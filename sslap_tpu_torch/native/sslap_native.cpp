// Native host-side runtime for sslap_tpu (C ABI, loaded via ctypes).
//
// The reference's native tier (Cython) owns ingest and feasibility
// (SURVEY.md SS3a R2/R3).  On TPU the solve loop is XLA/Pallas; the native
// tier here accelerates the host-side pieces that sit off the device hot
// path but on the end-to-end critical path for large instances:
//   * Hopcroft-Karp maximum bipartite matching over CSR (hopcroft_solve; the
//     feasibility check past int32 indices)
//   * the size of a maximum matching, Pothen-Fan+ (feasibility check)
//   * COO -> padded-ELL layout building (ingest for ~1e7+ nnz problems)
//   * CSR -> CSC transpose (the FR tail's column table)
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread (see build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <system_error>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Hopcroft-Karp over bipartite CSR structure.  Deterministic: rows and
// adjacency scanned in index order (matches the numpy fallback in
// feasibility.py, which doubles as its oracle in tests/test_feasibility.py).
// Returns matching size; fills match_row[n], match_col[m] with -1 = free.
// ---------------------------------------------------------------------------
template <typename I>
static int64_t hopcroft_karp_impl(const int64_t* indptr,
                                  const I* indices,
                                  int64_t n, int64_t m,
                                  I* match_row, I* match_col,
                                  bool warm) {
  // Index type I: int64 (original ABI) or int32 (capacity-scale fast
  // path -- at 10M rows / 100M nnz the int32 CSR + match arrays halve
  // the memory traffic of the BFS/DFS sweeps, which are bandwidth-bound
  // on this host).
  const int64_t INF = INT64_MAX / 4;
  int64_t size = 0;
  if (!warm) {
    std::fill(match_row, match_row + n, I{-1});
    std::fill(match_col, match_col + m, I{-1});

    // Greedy seed pass.
    for (int64_t u = 0; u < n; ++u) {
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        I v = indices[k];
        if (match_col[v] == -1) {
          match_col[v] = static_cast<I>(u);
          match_row[u] = v;
          ++size;
          break;
        }
      }
    }
  } else {
    // Caller-provided initial matching (e.g. the device-side greedy bulk
    // pass, feasibility_device.py): count it and augment from there.
    for (int64_t u = 0; u < n; ++u) {
      if (match_row[u] >= 0) ++size;
    }
  }

  std::vector<int64_t> dist(n), q(n), it(n), stack(n + 1);

  auto bfs = [&]() -> bool {
    int64_t head = 0, tail = 0;
    bool found = false;
    for (int64_t u = 0; u < n; ++u) {
      if (match_row[u] == -1) {
        dist[u] = 0;
        q[tail++] = u;
      } else {
        dist[u] = INF;
      }
    }
    while (head < tail) {
      int64_t u = q[head++];
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int64_t w = match_col[indices[k]];
        if (w == -1) {
          found = true;
        } else if (dist[w] == INF) {
          dist[w] = dist[u] + 1;
          q[tail++] = w;
        }
      }
    }
    return found;
  };

  auto dfs = [&](int64_t root) -> bool {
    int64_t top = 0;
    stack[0] = root;
    it[root] = indptr[root];
    while (top >= 0) {
      int64_t u = stack[top];
      bool advanced = false;
      while (it[u] < indptr[u + 1]) {
        I v = indices[it[u]++];
        int64_t w = match_col[v];
        if (w == -1) {
          while (top >= 0) {  // augment along the stack
            int64_t uu = stack[top--];
            I pv = match_row[uu];
            match_row[uu] = v;
            match_col[v] = static_cast<I>(uu);
            v = pv;
          }
          return true;
        }
        if (dist[w] == dist[u] + 1) {
          stack[++top] = w;
          it[w] = indptr[w];
          advanced = true;
          break;
        }
      }
      if (!advanced) {
        dist[u] = INF;  // dead end this phase
        --top;
      }
    }
    return false;
  };

  while (bfs()) {
    for (int64_t u = 0; u < n; ++u) {
      if (match_row[u] == -1 && dfs(u)) ++size;
    }
  }
  return size;
}

// ---------------------------------------------------------------------------
// Size of a maximum matching over an int32 CSR: Pothen-Fan+ (Duff, Kaya &
// Ucar, ACM TOMS 38(2), 2011), for the feasibility pre-check, which needs
// the size alone.  Seeded by HK's greedy pass (or a given partial
// matching), then passes over the rows still free, one DFS a row:
//   * lookahead: a row's pointer, kept across passes, finds a free column
//     among its entries before the DFS descends.  A matched column stays
//     matched, so no entry behind the pointer can turn free again;
//   * a column is visited at most once a pass (stamped with the pass);
//   * the DFS scans adjacency forward on odd passes, backward on even ones.
// Stops once no row is free or a pass augments nothing.  Any maximum
// matching has the same size, so the size equals HK's; the matching left
// in match_row/match_col is not HK's.  stats[0] = passes, stats[1] = rows
// matched after the seed.  Single-threaded and deterministic.
// ---------------------------------------------------------------------------
static int64_t max_matching_size_impl(const int64_t* indptr,
                                      const int32_t* indices,
                                      int64_t n, int64_t m,
                                      int32_t* match_row, int32_t* match_col,
                                      bool warm, int64_t* stats) {
  std::vector<int64_t> look(n);
  int64_t size = 0;
  if (!warm) {
    std::fill(match_row, match_row + n, int32_t{-1});
    std::fill(match_col, match_col + m, int32_t{-1});
    for (int64_t u = 0; u < n; ++u) {  // HK's greedy seed
      int64_t k = indptr[u], end = indptr[u + 1];
      for (; k < end; ++k) {
        int32_t v = indices[k];
        if (match_col[v] == -1) {
          match_col[v] = static_cast<int32_t>(u);
          match_row[u] = v;
          ++size;
          break;
        }
      }
      look[u] = k < end ? k + 1 : end;  // every entry before k is matched
    }
  } else {
    for (int64_t u = 0; u < n; ++u) {
      look[u] = indptr[u];
      if (match_row[u] >= 0) ++size;
    }
  }

  std::vector<int32_t> free_rows;
  for (int64_t u = 0; u < n; ++u) {
    if (match_row[u] == -1 && indptr[u + 1] > indptr[u]) {
      free_rows.push_back(static_cast<int32_t>(u));
    }
  }
  std::vector<int32_t> stamp(m, 0), stack(n + 1);
  std::vector<int64_t> it(n);
  int64_t passes = 0, augmented = 0;

  // One DFS from a free row; true if it augmented.
  auto dfs = [&](int32_t root, int32_t pass, bool fwd) -> bool {
    int64_t top = 0;
    stack[0] = root;
    it[root] = fwd ? indptr[root] : indptr[root + 1];
    while (top >= 0) {
      int32_t x = stack[top];
      int64_t end = indptr[x + 1];
      int64_t& la = look[x];
      while (la < end) {
        int32_t v = indices[la++];
        if (match_col[v] == -1) {
          while (top >= 0) {  // augment along the stack
            int32_t xx = stack[top--];
            int32_t pv = match_row[xx];
            match_row[xx] = v;
            match_col[v] = xx;
            v = pv;
          }
          return true;
        }
      }
      int32_t next = -1;
      if (fwd) {
        while (it[x] < end) {
          int32_t v = indices[it[x]++];
          if (stamp[v] != pass) {
            stamp[v] = pass;
            next = match_col[v];
            break;
          }
        }
      } else {
        while (it[x] > indptr[x]) {
          int32_t v = indices[--it[x]];
          if (stamp[v] != pass) {
            stamp[v] = pass;
            next = match_col[v];
            break;
          }
        }
      }
      if (next < 0) {
        --top;  // dead end: every column of x visited this pass
      } else {
        stack[++top] = next;
        it[next] = fwd ? indptr[next] : indptr[next + 1];
      }
    }
    return false;
  };

  while (!free_rows.empty()) {
    ++passes;
    const int32_t pass = static_cast<int32_t>(passes);
    const bool fwd = passes % 2 == 1;
    size_t kept = 0;
    for (int32_t u : free_rows) {
      if (!dfs(u, pass, fwd)) free_rows[kept++] = u;
    }
    const int64_t found = static_cast<int64_t>(free_rows.size() - kept);
    free_rows.resize(kept);
    augmented += found;
    if (found == 0) break;
  }
  stats[0] = passes;
  stats[1] = augmented;
  return size + augmented;
}

extern "C" {

int64_t sslap_hopcroft_karp(const int64_t* indptr, const int64_t* indices,
                            int64_t n, int64_t m,
                            int64_t* match_row, int64_t* match_col) {
  return hopcroft_karp_impl<int64_t>(indptr, indices, n, m, match_row,
                                     match_col, /*warm=*/false);
}

// Warm variant: match_row/match_col carry an initial (partial) matching;
// HK augments it to maximum.  Used by the device-seeded feasibility path.
int64_t sslap_hopcroft_karp_warm(const int64_t* indptr,
                                 const int64_t* indices,
                                 int64_t n, int64_t m,
                                 int64_t* match_row, int64_t* match_col) {
  return hopcroft_karp_impl<int64_t>(indptr, indices, n, m, match_row,
                                     match_col, /*warm=*/true);
}

// int32-index variants (n, m < 2^31): half the CSR/match memory traffic.
int64_t sslap_hopcroft_karp_i32(const int64_t* indptr,
                                const int32_t* indices,
                                int64_t n, int64_t m,
                                int32_t* match_row, int32_t* match_col) {
  return hopcroft_karp_impl<int32_t>(indptr, indices, n, m, match_row,
                                     match_col, /*warm=*/false);
}

int64_t sslap_hopcroft_karp_warm_i32(const int64_t* indptr,
                                     const int32_t* indices,
                                     int64_t n, int64_t m,
                                     int32_t* match_row,
                                     int32_t* match_col) {
  return hopcroft_karp_impl<int32_t>(indptr, indices, n, m, match_row,
                                     match_col, /*warm=*/true);
}

// Size of a maximum matching (n, m < 2^31); match_row[n] / match_col[m]
// are work buffers.  stats[2] out: passes, rows augmented after the seed.
int64_t sslap_max_matching_size_i32(const int64_t* indptr,
                                    const int32_t* indices,
                                    int64_t n, int64_t m,
                                    int32_t* match_row, int32_t* match_col,
                                    int64_t* stats) {
  return max_matching_size_impl(indptr, indices, n, m, match_row,
                                match_col, /*warm=*/false, stats);
}

// Warm variant: match_row/match_col carry a consistent partial matching.
int64_t sslap_max_matching_size_warm_i32(const int64_t* indptr,
                                         const int32_t* indices,
                                         int64_t n, int64_t m,
                                         int32_t* match_row,
                                         int32_t* match_col,
                                         int64_t* stats) {
  return max_matching_size_impl(indptr, indices, n, m, match_row,
                                match_col, /*warm=*/true, stats);
}

// ---------------------------------------------------------------------------
// COO -> padded ELL.  Two-call protocol:
//   1) sslap_coo_prepare: stable counting-sort by row, per-row sort by col,
//      duplicate detection, per-row counts.  Returns K (max nnz/row), or
//      -1 on duplicate (row, col), -2 on out-of-range index.
//   2) sslap_ell_fill: scatter sorted entries into [n, K] cols/vals/valid.
// perm is caller-allocated [nnz]; counts is [n].
// ---------------------------------------------------------------------------
int64_t sslap_coo_prepare(int64_t nnz, int64_t n, int64_t m,
                          const int64_t* rr, const int64_t* cc,
                          int64_t* perm, int64_t* counts) {
  std::fill(counts, counts + n, int64_t{0});
  for (int64_t k = 0; k < nnz; ++k) {
    if (rr[k] < 0 || rr[k] >= n || cc[k] < 0 || cc[k] >= m) return -2;
    ++counts[rr[k]];
  }
  // Counting sort by row (stable).
  std::vector<int64_t> starts(n + 1, 0);
  for (int64_t u = 0; u < n; ++u) starts[u + 1] = starts[u] + counts[u];
  std::vector<int64_t> cursor(starts.begin(), starts.end() - 1);
  for (int64_t k = 0; k < nnz; ++k) perm[cursor[rr[k]]++] = k;
  // Per-row sort by column; detect duplicates.
  int64_t K = 0;
  for (int64_t u = 0; u < n; ++u) {
    int64_t lo = starts[u], hi = starts[u + 1];
    std::sort(perm + lo, perm + hi,
              [&](int64_t a, int64_t b) { return cc[a] < cc[b]; });
    for (int64_t k = lo + 1; k < hi; ++k) {
      if (cc[perm[k]] == cc[perm[k - 1]]) return -1;
    }
    K = std::max(K, hi - lo);
  }
  return K;
}

void sslap_ell_fill_f32(int64_t nnz, int64_t n, int64_t K,
                        const int64_t* rr, const int64_t* cc,
                        const float* vv, const int64_t* perm,
                        const int64_t* counts,
                        int32_t* ell_cols, float* ell_vals, bool* ell_valid) {
  std::memset(ell_cols, 0, sizeof(int32_t) * n * K);
  std::memset(ell_vals, 0, sizeof(float) * n * K);
  std::memset(ell_valid, 0, sizeof(bool) * n * K);
  int64_t pos = 0;
  for (int64_t u = 0; u < n; ++u) {
    for (int64_t s = 0; s < counts[u]; ++s, ++pos) {
      int64_t k = perm[pos];
      ell_cols[u * K + s] = static_cast<int32_t>(cc[k]);
      ell_vals[u * K + s] = vv[k];
      ell_valid[u * K + s] = true;
    }
  }
}

void sslap_ell_fill_f64(int64_t nnz, int64_t n, int64_t K,
                        const int64_t* rr, const int64_t* cc,
                        const double* vv, const int64_t* perm,
                        const int64_t* counts,
                        int32_t* ell_cols, double* ell_vals,
                        bool* ell_valid) {
  std::memset(ell_cols, 0, sizeof(int32_t) * n * K);
  std::memset(ell_vals, 0, sizeof(double) * n * K);
  std::memset(ell_valid, 0, sizeof(bool) * n * K);
  int64_t pos = 0;
  for (int64_t u = 0; u < n; ++u) {
    for (int64_t s = 0; s < counts[u]; ++s, ++pos) {
      int64_t k = perm[pos];
      ell_cols[u * K + s] = static_cast<int32_t>(cc[k]);
      ell_vals[u * K + s] = vv[k];
      ell_valid[u * K + s] = true;
    }
  }
}

// ---------------------------------------------------------------------------
// ELL -> line-packed RowPack (compact.RowPack layout): one fused pass that
// applies the min/max transform (vals * sign_scale), masks invalid slots to
// the negative sentinel, and writes the packed [npad, W = 2K+1] int32 image
// (row-major; the caller reshapes to [npad/R, R*W] lines -- rows are
// consecutive inside a line, so the flat layouts coincide).  Replaces a
// multi-temporary numpy pipeline measured at 34-61 s for 10M rows x K=16
// (VERDICT round-2 task 3); this pass is a single read of cols/vals/valid
// and a single write of the packed image.
// The caller allocates `out` zero-filled for npad * W (calloc is lazy), so
// padding rows carry nvalid = 0 and never bid.
// ---------------------------------------------------------------------------
}  // extern "C" (template below; C entry points follow)

template <typename T>
static void rowpack_fill(int64_t n, int64_t K, const int32_t* cols,
                         const T* vals, const bool* valid,
                         const int32_t* nvalid, T sign_scale, T neg,
                         int32_t* out) {
  const int64_t W = 2 * K + 1;
  for (int64_t u = 0; u < n; ++u) {
    int32_t* row = out + u * W;
    const int32_t* cu = cols + u * K;
    const T* vu = vals + u * K;
    const bool* mu = valid + u * K;
    std::memcpy(row, cu, sizeof(int32_t) * K);
    for (int64_t j = 0; j < K; ++j) {
      T v = mu[j] ? static_cast<T>(vu[j] * sign_scale) : neg;
      int32_t bits;
      std::memcpy(&bits, &v, sizeof(int32_t));
      row[K + j] = bits;
    }
    row[2 * K] = nvalid[u];
  }
}

extern "C" {

void sslap_rowpack_fill_f32(int64_t n, int64_t K, const int32_t* cols,
                            const float* vals, const bool* valid,
                            const int32_t* nvalid, float sign_scale,
                            float neg, int32_t* out) {
  rowpack_fill<float>(n, K, cols, vals, valid, nvalid, sign_scale, neg, out);
}

void sslap_rowpack_fill_i32(int64_t n, int64_t K, const int32_t* cols,
                            const int32_t* vals, const bool* valid,
                            const int32_t* nvalid, int32_t sign_scale,
                            int32_t neg, int32_t* out) {
  rowpack_fill<int32_t>(n, K, cols, vals, valid, nvalid, sign_scale, neg,
                        out);
}

// Wide-layout (column-window-grouped) fill for ops/widebid.py: counting-
// sort placement of ELL entries into [NB, E] window groups, fused with the
// min/max transform + sentinel masking.  Sequential q-ascending traversal
// makes the grouping stable by construction (bit-parity with the numpy
// stable-argsort path is asserted in tests/test_ops.py).

// Effective column of entry q: valid entries clip into [0, m); INVALID
// slots get a synthetic column spread uniformly across windows (window
// q % NB, lane 0) -- ingest gives padding slots col 0, and routing ~2M
// pads into window 0 once exploded E to 2e6 (round-4 tracking OOM).
// Invalid w values never influence outputs (below neg/2 on every path).
static inline int32_t wide_eff_col(int64_t q, int32_t c, bool ok,
                                   int32_t m, int64_t NB) {
  if (!ok) {
    int64_t cc = (q % NB) << 7;
    return cc >= m ? m - 1 : static_cast<int32_t>(cc);
  }
  if (c < 0) return 0;
  if (c >= m) return m - 1;
  return c;
}

void sslap_wide_count(int64_t nK, const int32_t* cols, const bool* valid,
                      int32_t m, int64_t NB,
                      int64_t* counts /* [NB] zeroed */) {
  for (int64_t q = 0; q < nK; ++q)
    counts[wide_eff_col(q, cols[q], valid[q], m, NB) >> 7]++;
}

}  // extern "C" (template below; C entry points follow)

template <typename T>
static void wide_fill(int64_t nK, const int32_t* cols, const T* vals,
                      const bool* valid, T sign_scale, T neg, int32_t m,
                      int64_t NB, int64_t E, int64_t* cursor /* zeroed */,
                      int32_t* coff, T* vals_cg, int32_t* dest) {
  for (int64_t q = 0; q < nK; ++q) {
    int32_t c = wide_eff_col(q, cols[q], valid[q], m, NB);
    int64_t w = c >> 7;
    int64_t slot = w * E + cursor[w]++;
    coff[slot] = c & 127;
    vals_cg[slot] = valid[q] ? static_cast<T>(vals[q] * sign_scale) : neg;
    dest[slot] = static_cast<int32_t>(q);
  }
  int32_t pad = static_cast<int32_t>(nK);
  for (int64_t w = 0; w < NB; ++w)
    for (int64_t e = cursor[w]; e < E; ++e)
      dest[w * E + e] = pad++;
}

extern "C" {

void sslap_wide_fill_f32(int64_t nK, const int32_t* cols, const float* vals,
                         const bool* valid, float sign_scale, float neg,
                         int32_t m, int64_t NB, int64_t E, int64_t* cursor,
                         int32_t* coff, float* vals_cg, int32_t* dest) {
  wide_fill<float>(nK, cols, vals, valid, sign_scale, neg, m, NB, E, cursor,
                   coff, vals_cg, dest);
}

void sslap_wide_fill_i32(int64_t nK, const int32_t* cols,
                         const int32_t* vals, const bool* valid,
                         int32_t sign_scale, int32_t neg, int32_t m,
                         int64_t NB, int64_t E, int64_t* cursor,
                         int32_t* coff, int32_t* vals_cg, int32_t* dest) {
  wide_fill<int32_t>(nK, cols, vals, valid, sign_scale, neg, m, NB, E,
                     cursor, coff, vals_cg, dest);
}

void sslap_ell_fill_i32(int64_t nnz, int64_t n, int64_t K,
                        const int64_t* rr, const int64_t* cc,
                        const int32_t* vv, const int64_t* perm,
                        const int64_t* counts,
                        int32_t* ell_cols, int32_t* ell_vals,
                        bool* ell_valid) {
  std::memset(ell_cols, 0, sizeof(int32_t) * n * K);
  std::memset(ell_vals, 0, sizeof(int32_t) * n * K);
  std::memset(ell_valid, 0, sizeof(bool) * n * K);
  int64_t pos = 0;
  for (int64_t u = 0; u < n; ++u) {
    for (int64_t s = 0; s < counts[u]; ++s, ++pos) {
      int64_t k = perm[pos];
      ell_cols[u * K + s] = static_cast<int32_t>(cc[k]);
      ell_vals[u * K + s] = vv[k];
      ell_valid[u * K + s] = true;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ELL -> CSR of transformed (maximization) values, one fused pass.  The
// numpy path (`cols[valid]`, `vals[valid]`) runs np.nonzero over the whole
// [n, K] mask once PER indexing op, materializing two [nnz] int64 index
// temps (~0.8 GB each at 100M nnz) before the gathers -- measured at
// 49.5 s for the 10M x 10M scale config under its memory pressure
// (PERF.md round-3 table).  This pass reads cols/vals/valid once and
// writes indptr/indices/data directly.  The caller allocates indices/data
// at nnz (= valid.sum()) and must pass the same sign*scale the device
// transform uses so host and device values agree bit-for-bit.
// ---------------------------------------------------------------------------

namespace {

template <typename T>
void ell_to_csr_impl(int64_t n, int64_t K, const int32_t* cols,
                     const T* vals, const bool* valid, T sign_scale,
                     int64_t* indptr, int32_t* indices, T* data) {
  int64_t pos = 0;
  indptr[0] = 0;
  for (int64_t u = 0; u < n; ++u) {
    const int32_t* cu = cols + u * K;
    const T* vu = vals + u * K;
    const bool* mu = valid + u * K;
    for (int64_t j = 0; j < K; ++j) {
      if (mu[j]) {
        indices[pos] = cu[j];
        data[pos] = static_cast<T>(vu[j] * sign_scale);
        ++pos;
      }
    }
    indptr[u + 1] = pos;
  }
}

// ---------------------------------------------------------------------------
// CSR -> CSC transpose (the FR engine's column table), a stable counting
// sort: rows are visited in order, so each column lists its rows
// ascending -- the order np.argsort(indices, kind="stable") gives, and the
// output equals the numpy path (hybrid._csr_to_csc) bit for bit.  One nnz
// extent, indptr[n], bounds every read.  The rows are cut into nt
// contiguous chunks of about equal nnz: each thread counts its chunk's
// entries per column, one exclusive prefix over (column, chunk) gives each
// (chunk, column) pair its first slot, and each thread scatters its own
// rows.  Chunk order within a column is row order, so every nt gives the
// same output.  C, the counter type, is int32 while nnz < 2^31.
// ---------------------------------------------------------------------------

constexpr int64_t kCscEntriesPerThread = int64_t(1) << 20;
constexpr int64_t kCscMaxThreads = 8;

int64_t csc_threads(int64_t nnz) {
  const int64_t hw = std::thread::hardware_concurrency();
  return std::max<int64_t>(
      1, std::min({hw, kCscMaxThreads, nnz / kCscEntriesPerThread}));
}

// f(0..nt-1), f(0) on the calling thread; a chunk whose thread cannot be
// started runs on the calling thread too.
template <typename F>
void run_chunks(int64_t nt, const F& f) {
  std::vector<std::thread> pool;
  std::vector<int64_t> inline_chunks;
  for (int64_t t = 1; t < nt; ++t) {
    try {
      pool.emplace_back(f, t);
    } catch (const std::system_error&) {
      inline_chunks.push_back(t);
    }
  }
  f(0);
  for (int64_t t : inline_chunks) f(t);
  for (auto& th : pool) th.join();
}

template <typename T, typename C>
void csr_to_csc_impl(int64_t n, int64_t m, int64_t nt, const int64_t* indptr,
                     const int32_t* indices, const T* data, int64_t* cindptr,
                     int32_t* cindices, T* cvals) {
  const int64_t nnz = indptr[n];
  // chunk t: rows [lo[t], lo[t + 1]), from the first row whose entries
  // start at or after t * nnz / nt
  std::vector<int64_t> lo(nt + 1, n);
  for (int64_t t = 0; t < nt; ++t)
    lo[t] = std::lower_bound(indptr, indptr + n, t * nnz / nt) - indptr;
  std::vector<C> cnt(nt * m);  // [chunk][column]
  run_chunks(nt, [&](int64_t t) {
    C* ct = cnt.data() + t * m;
    for (int64_t p = indptr[lo[t]], e = indptr[lo[t + 1]]; p < e; ++p)
      ++ct[indices[p]];
  });
  int64_t run = 0;
  cindptr[0] = 0;
  for (int64_t c = 0; c < m; ++c) {
    for (int64_t t = 0; t < nt; ++t) {
      const C k = cnt[t * m + c];
      cnt[t * m + c] = static_cast<C>(run);
      run += k;
    }
    cindptr[c + 1] = run;
  }
  run_chunks(nt, [&](int64_t t) {
    C* cur = cnt.data() + t * m;
    for (int64_t u = lo[t]; u < lo[t + 1]; ++u) {
      for (int64_t p = indptr[u], e = indptr[u + 1]; p < e; ++p) {
        const C q = cur[indices[p]]++;
        cindices[q] = static_cast<int32_t>(u);
        cvals[q] = data[p];
      }
    }
  });
}

template <typename T>
void csr_to_csc(int64_t n, int64_t m, const int64_t* indptr,
                const int32_t* indices, const T* data, int64_t* cindptr,
                int32_t* cindices, T* cvals) {
  const int64_t nnz = indptr[n];
  const int64_t nt = csc_threads(nnz);
  if (nnz < (int64_t(1) << 31))
    csr_to_csc_impl<T, int32_t>(n, m, nt, indptr, indices, data, cindptr,
                                cindices, cvals);
  else
    csr_to_csc_impl<T, int64_t>(n, m, nt, indptr, indices, data, cindptr,
                                cindices, cvals);
}

}  // namespace

extern "C" {

void sslap_ell_to_csr_f32(int64_t n, int64_t K, const int32_t* cols,
                          const float* vals, const bool* valid,
                          float sign_scale, int64_t* indptr,
                          int32_t* indices, float* data) {
  ell_to_csr_impl<float>(n, K, cols, vals, valid, sign_scale, indptr,
                         indices, data);
}

void sslap_ell_to_csr_f64(int64_t n, int64_t K, const int32_t* cols,
                          const double* vals, const bool* valid,
                          double sign_scale, int64_t* indptr,
                          int32_t* indices, double* data) {
  ell_to_csr_impl<double>(n, K, cols, vals, valid, sign_scale, indptr,
                          indices, data);
}

void sslap_ell_to_csr_i32(int64_t n, int64_t K, const int32_t* cols,
                          const int32_t* vals, const bool* valid,
                          int32_t sign_scale, int64_t* indptr,
                          int32_t* indices, int32_t* data) {
  ell_to_csr_impl<int32_t>(n, K, cols, vals, valid, sign_scale, indptr,
                           indices, data);
}

void sslap_csr_to_csc_f32(int64_t n, int64_t m, const int64_t* indptr,
                          const int32_t* indices, const float* data,
                          int64_t* cindptr, int32_t* cindices, float* cvals) {
  csr_to_csc<float>(n, m, indptr, indices, data, cindptr, cindices, cvals);
}

void sslap_csr_to_csc_f64(int64_t n, int64_t m, const int64_t* indptr,
                          const int32_t* indices, const double* data,
                          int64_t* cindptr, int32_t* cindices,
                          double* cvals) {
  csr_to_csc<double>(n, m, indptr, indices, data, cindptr, cindices, cvals);
}

void sslap_csr_to_csc_i32(int64_t n, int64_t m, const int64_t* indptr,
                          const int32_t* indices, const int32_t* data,
                          int64_t* cindptr, int32_t* cindices,
                          int32_t* cvals) {
  csr_to_csc<int32_t>(n, m, indptr, indices, data, cindptr, cindices, cvals);
}

// ---------------------------------------------------------------------------
// eps-CS certificate statistics, one fused pass over the ELL image.  For
// every row u (with w = vals*sign_scale - prices[col] on valid slots,
// -inf elsewhere) emits:
//   v1[u]     = max_j w[u, j]
//   cur[u]    = w[u, slot],  slot = FIRST j with cols[u, j] == sigma[u],
//               else slot = 0   (matches np.argmax(cols == sigma[:, None]))
//   a_orig[u] = vals[u, slot]   (untransformed; objective accumulation
//               stays on the python side so the f32 summation semantics
//               match the numpy path exactly)
//   wmax_out  = max |w| over valid slots (for the ULP rounding slack)
// The numpy formulation allocates five [n, K] temps (~3 GB at 10M x 16)
// and measured 158 s on the scale config (PERF.md round-3 table); this
// pass reads each input array once and writes only [n] vectors.
// ---------------------------------------------------------------------------

void sslap_eps_cs_stats_f32(int64_t n, int64_t K, const int32_t* cols,
                            const float* vals, const bool* valid,
                            const float* prices, const int32_t* sigma,
                            float sign_scale,
                            float* v1, float* cur, float* a_orig,
                            float* wmax_out) {
  float wmax = 0.0f;
  for (int64_t u = 0; u < n; ++u) {
    const int32_t* cu = cols + u * K;
    const float* vu = vals + u * K;
    const bool* mu = valid + u * K;
    const int32_t s = sigma[u];
    float best = -INFINITY;
    int64_t slot = 0;
    bool seen = false;
    for (int64_t j = 0; j < K; ++j) {
      if (!seen && cu[j] == s) { slot = j; seen = true; }
      if (mu[j]) {
        // Two rounded statements (not one expression): blocks FMA
        // contraction under -O3 so w is bit-identical to the numpy
        // vals*sign_scale - prices[cols] two-step.
        const float vt = vu[j] * sign_scale;
        const float w = vt - prices[cu[j]];
        if (w > best) best = w;
        const float aw = std::fabs(w);
        if (aw > wmax) wmax = aw;
      }
    }
    v1[u] = best;
    const float vt_slot = vu[slot] * sign_scale;
    cur[u] = mu[slot] ? vt_slot - prices[cu[slot]] : -INFINITY;
    a_orig[u] = vu[slot];
  }
  *wmax_out = wmax;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Gauss-Seidel forward auction over CSR (transformed maximization values).
//
// Used two ways (SURVEY.md SS8 + hybrid design):
//   1. Tail finisher for the TPU Jacobi solver: the device retires the
//      massively-parallel bulk of each eps phase; the serial eviction
//      chains that remain (O(n) Jacobi rounds' worth) are finished here in
//      O(chain) bids.  Bid semantics match the device exactly (lowest-col
//      argmax tie-break, v2 = v1 - bigp for single-entry rows, implicit
//      dummy rows for rectangular problems) so eps-CS is preserved across
//      the handoff.
//   2. Standalone CPU solver (sslap-class reference for benchmarking).
//
// State arrays are modified in place.  owner: -1 free, -2 dummy-held,
// >= 0 real row.  Returns the number of bids performed, or -1 if max_bids
// was exhausted (possible infeasibility; caller decides).
// ---------------------------------------------------------------------------

namespace {

// Indexed binary min-heap over (price, col) -- O(log m) dummy bids.
//
// Rectangular problems run (m - n) implicit dummy rows whose bid is
// always "grab the cheapest column at (second-cheapest + eps)".  The
// original linear scan made every dummy bid O(m); at 10k x 20k that
// measured 76 s vs scipy's 0.17 s (round 5, chip_logs/r5_sweep_rect).
// Prices only RISE during the auction, so one sift-down per price
// update maintains the heap; ties break to the lowest column index
// (lexicographic (price, col) order), matching the scan and the device
// semantics bit-for-bit.  The second-smallest PRICE is always at one of
// the root's children.
template <typename T>
struct PriceHeap {
  std::vector<int32_t> h;    // heap of column ids
  std::vector<int32_t> pos;  // pos[j] = index of j in h
  const T* p = nullptr;
  int64_t m = 0;
  bool less(int32_t a, int32_t b) const {
    return p[a] < p[b] || (p[a] == p[b] && a < b);
  }
  void sift_down(int64_t i) {
    for (;;) {
      int64_t l = 2 * i + 1, r = l + 1, s = i;
      if (l < m && less(h[l], h[s])) s = l;
      if (r < m && less(h[r], h[s])) s = r;
      if (s == i) break;
      std::swap(h[i], h[s]);
      pos[h[i]] = (int32_t)i;
      pos[h[s]] = (int32_t)s;
      i = s;
    }
  }
  void init(const T* prices, int64_t m_) {
    p = prices;
    m = m_;
    h.resize(m);
    pos.resize(m);
    for (int64_t j = 0; j < m; ++j) h[j] = pos[j] = (int32_t)j;
    for (int64_t i = m / 2 - 1; i >= 0; --i) sift_down(i);
  }
  void increased(int32_t j) { sift_down(pos[j]); }
  int32_t min1() const { return h[0]; }
  T second_price(T fallback) const {
    if (m < 2) return fallback;
    T best = p[h[1]];
    if (m > 2 && p[h[2]] < best) best = p[h[2]];
    return best;
  }
};

template <typename T, bool kPrefetch>
int64_t auction_gs(int64_t n, int64_t m, const int64_t* indptr,
                   const int32_t* indices, const T* vals, T* prices,
                   int32_t* sigma, int32_t* owner, T eps, T bigp,
                   int64_t n_dummy_total, int64_t max_bids) {
  // FIFO queue of unassigned real rows; dummies tracked by a counter
  // (interchangeable).  Capacity n + 1 suffices: every real row appears at
  // most once (it is either queued, assigned, or being processed).
  std::vector<int32_t> queue(n + 1);
  int64_t head = 0, tail = 0;
  auto push = [&](int32_t u) {
    queue[tail] = u;
    tail = (tail + 1) % (n + 1);
  };
  int64_t dummy_pending = n_dummy_total;
  for (int64_t j = 0; j < m; ++j) {
    if (owner[j] == -2) --dummy_pending;
  }
  for (int64_t u = 0; u < n; ++u) {
    if (sigma[u] < 0 && indptr[u + 1] > indptr[u]) push((int32_t)u);
  }

  auto evict = [&](int64_t j) {
    int32_t w = owner[j];
    if (w >= 0) {
      sigma[w] = -1;
      push(w);
    } else if (w == -2) {
      ++dummy_pending;
    }
  };

  PriceHeap<T> heap;  // armed (heap.p != null) only for rectangular runs
  if (n_dummy_total > 0 && m >= 8) heap.init(prices, m);

  int64_t bids = 0;
  while ((head != tail || dummy_pending > 0)) {
    if (bids >= max_bids) return -1;
    ++bids;
    if (head != tail) {
      int32_t u = queue[head];
      head = (head + 1) % (n + 1);
      if (sigma[u] >= 0) continue;  // stale entry (shouldn't happen)
      // top-2 of a_uj - p_j; ties -> lowest column index (scan order).
      int64_t lo = indptr[u], hi = indptr[u + 1];
      if (kPrefetch) {
        // The bid scan is DRAM-latency-bound on the random price reads
        // (~10 dependent misses/bid at 1M columns).  Issue them all up
        // front so they overlap, and warm the next queued row's slice
        // too.  The reference-class plain loop (kPrefetch = false) is
        // kept as the benchmark baseline -- sslap's Cython does not
        // prefetch.
        for (int64_t k = lo; k < hi; ++k) {
          __builtin_prefetch(&prices[indices[k]], 0, 1);
        }
        if (head != tail) {
          int32_t nu = queue[head];
          int64_t nlo = indptr[nu], nhi = indptr[nu + 1];
          __builtin_prefetch(&indices[nlo], 0, 1);
          for (int64_t k = nlo; k < nhi; ++k) {
            __builtin_prefetch(&prices[indices[k]], 0, 0);
          }
        }
      }
      T v1 = T(0), v2 = T(0);
      int64_t kbest = -1;
      bool has1 = false, has2 = false;
      for (int64_t k = lo; k < hi; ++k) {
        T w = vals[k] - prices[indices[k]];
        if (!has1 || w > v1) {
          if (has1) { v2 = v1; has2 = true; }
          v1 = w;
          kbest = k;
          has1 = true;
        } else if (!has2 || w > v2) {
          v2 = w;
          has2 = true;
        }
      }
      if (!has1) continue;  // no valid entries: permanently unassignable
      if (!has2) v2 = v1 - bigp;
      int64_t jstar = indices[kbest];
      T bid = vals[kbest] - v2 + eps;
      evict(jstar);
      prices[jstar] = bid;
      if (heap.p) heap.increased((int32_t)jstar);
      owner[jstar] = u;
      sigma[u] = (int32_t)jstar;
    } else {
      // Dummy bid: value 0 on every column -> top-2 of -p_j == two smallest
      // prices (ties -> lowest index).  Heap path is bit-identical to the
      // scan (same lexicographic tie-break, same p2 value) at O(log m)
      // instead of O(m) per bid.
      int64_t j1;
      T p2;
      if (heap.p) {
        j1 = heap.min1();
        p2 = heap.second_price(prices[heap.min1()] + bigp);
      } else {
        int64_t jj1 = -1, jj2 = -1;
        for (int64_t j = 0; j < m; ++j) {
          if (jj1 < 0 || prices[j] < prices[jj1]) {
            jj2 = jj1;
            jj1 = j;
          } else if (jj2 < 0 || prices[j] < prices[jj2]) {
            jj2 = j;
          }
        }
        j1 = jj1;
        p2 = (jj2 >= 0) ? prices[jj2] : prices[jj1] + bigp;
      }
      evict(j1);
      prices[j1] = p2 + eps;
      if (heap.p) heap.increased((int32_t)j1);
      owner[j1] = -2;
      --dummy_pending;
    }
  }
  return bids;
}

// ---------------------------------------------------------------------------
// Combined forward-reverse Gauss-Seidel auction (square problems).
//
// Round-5 component (Bertsekas & Castanon's combined forward/reverse
// auction; PAPERS.md arXiv:1401.0119 family).  The forward-only engine's
// structural cost on churned warm re-solves: a displaced row re-enters at
// eps_min where eviction chains are longest -- prices can only rise, so
// the chain must climb over the whole local price landscape.  Reverse
// bids (unassigned COLUMNS bid for rows; profits rise, and the winning
// column's price is SET DOWN to b2 - eps) attack the same chains from the
// other side and meet in the middle.
//
// Invariants (maintained by both bid types, one-line checks in comments):
//   dual feasibility:  pi_i + p_j >= a_ij - eps          on every edge
//   assigned pairs:    pi_i + p_j  = a_ij                (tight)
// Each forward bid raises p_jstar by >= eps, each reverse bid raises
// pi_istar by >= eps, and duals are bounded for feasible instances =>
// termination; max_bids is the infeasibility valve (-1, same contract as
// auction_gs).  Alternation: phase-snapshot round-robin -- process the
// rows queued at phase start, then the columns queued at phase start,
// repeat.  Lazy skip on pop (a target may have been assigned meanwhile);
// in_queue flags keep each id queued at most once.
//
// Entry accepts a PARTIAL assignment (sigma/owner, e.g. a truncated
// device phase's state).  Profits are initialized here: tight for
// assigned rows (their pairs satisfy forward eps-CS on entry), best-value
// for unassigned rows.  On exit the prices alone still satisfy forward
// eps-CS for the final assignment (tightness + feasibility above), so
// callers can keep treating prices as THE dual state.
template <typename T>
int64_t auction_gs_fr(int64_t n, int64_t m,
                      const int64_t* indptr, const int32_t* indices,
                      const T* vals,                       // CSR (rows)
                      const int64_t* cindptr, const int32_t* cindices,
                      const T* cvals,                      // CSC (columns)
                      T* prices, T* profits, int32_t* sigma, int32_t* owner,
                      T eps, T bigp, int64_t max_bids) {
  std::vector<int32_t> row_q(n), col_q(m);
  std::vector<uint8_t> row_in(n, 0), col_in(m, 0);
  int64_t rq_head = 0, rq_tail = 0, cq_head = 0, cq_tail = 0;
  auto push_row = [&](int32_t u) {
    if (!row_in[u]) { row_in[u] = 1; row_q[rq_tail++ % n] = u; }
  };
  auto push_col = [&](int32_t j) {
    if (!col_in[j]) { col_in[j] = 1; col_q[cq_tail++ % m] = j; }
  };
  // Profit init: tight on assigned pairs, best-value on unassigned rows.
  for (int64_t i = 0; i < n; ++i) {
    if (sigma[i] >= 0) {
      // find the assigned entry's value (rows are short; linear scan)
      T a = T(0);
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        if (indices[k] == sigma[i]) { a = vals[k]; break; }
      }
      profits[i] = a - prices[sigma[i]];
    } else {
      T best = -bigp;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        T w = vals[k] - prices[indices[k]];
        if (w > best) best = w;
      }
      profits[i] = best;
      if (indptr[i + 1] > indptr[i]) push_row((int32_t)i);
    }
  }
  for (int64_t j = 0; j < m; ++j) {
    if (owner[j] < 0 && cindptr[j + 1] > cindptr[j]) push_col((int32_t)j);
  }

  // Scheduling (two measured failure modes inform it):
  //   * naive phase-snapshot alternation LIVELOCKS (107k bids at n=150:
  //     forward raises a price by eps, reverse sets it back -- neither
  //     dual is monotone across the mix);
  //   * strict Bertsekas-Castanon switch-on-every-match TERMINATES but
  //     doubles the work on random instances (66-71M bids vs the pure
  //     forward engine's 33M at 1M -- reverse stretches keep stealing
  //     what forward just built).
  // Shipped schedule: FORWARD-PREFERRED.  Forward runs freely; a reverse
  // stretch (until one matched-count increase) is invoked only when
  // forward goes ``stall_t`` bids without assigning a fresh column --
  // the long-eviction-chain regime reverse bids exist for.  A global
  // reverse-bid budget bounds the mixed phase; once spent, the run is
  // pure forward, whose termination is the standard auction argument.
  int64_t matched = 0;
  for (int64_t i = 0; i < n; ++i) matched += (sigma[i] >= 0);
  const int64_t stall_t = 256;
  int64_t reverse_budget = 4 * n + 1024;
  int64_t stall = 0;

  int64_t bids = 0;
  while (rq_head != rq_tail || cq_head != cq_tail) {
    // ---- forward (preferred) ----
    while (rq_head != rq_tail) {
      int32_t u = row_q[rq_head++ % n];
      row_in[u] = 0;
      if (sigma[u] >= 0) continue;          // reverse bid took it
      if (bids >= max_bids) return -1;
      ++bids;
      T v1 = T(0), v2 = T(0);
      int64_t kbest = -1;
      bool has1 = false, has2 = false;
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        T w = vals[k] - prices[indices[k]];
        if (!has1 || w > v1) {
          if (has1) { v2 = v1; has2 = true; }
          v1 = w; kbest = k; has1 = true;
        } else if (!has2 || w > v2) {
          v2 = w; has2 = true;
        }
      }
      if (!has1) continue;                  // permanently unassignable
      if (!has2) v2 = v1 - bigp;
      int64_t jstar = indices[kbest];
      int32_t w = owner[jstar];
      bool progress = (w < 0);
      if (w >= 0) { sigma[w] = -1; push_row(w); }
      prices[jstar] = vals[kbest] - v2 + eps;   // p rises by >= eps
      profits[u] = v2 - eps;                    // tight: pi+p = a exactly
      owner[jstar] = u;
      sigma[u] = (int32_t)jstar;
      if (progress) {
        ++matched;
        stall = 0;
      } else if (++stall >= stall_t && reverse_budget > 0) {
        stall = 0;
        break;                              // chain too long: try reverse
      }
    }
    // ---- reverse stretch: until one matched-count increase ----
    while (cq_head != cq_tail && reverse_budget > 0) {
      int32_t j = col_q[cq_head++ % m];
      col_in[j] = 0;
      if (owner[j] >= 0) continue;          // forward bid took it
      if (bids >= max_bids) return -1;
      ++bids;
      T b1 = T(0), b2 = T(0);
      int64_t kbest = -1;
      bool has1 = false, has2 = false;
      for (int64_t k = cindptr[j]; k < cindptr[j + 1]; ++k) {
        T w = cvals[k] - profits[cindices[k]];
        if (!has1 || w > b1) {
          if (has1) { b2 = b1; has2 = true; }
          b1 = w; kbest = k; has1 = true;
        } else if (!has2 || w > b2) {
          b2 = w; has2 = true;
        }
      }
      if (!has1) continue;
      if (!has2) b2 = b1 - bigp;
      --reverse_budget;
      int64_t istar = cindices[kbest];
      int32_t jprev = sigma[istar];
      bool progress = (jprev < 0);
      if (jprev >= 0) { owner[jprev] = -1; push_col(jprev); }
      profits[istar] = cvals[kbest] - b2 + eps;  // pi rises by >= eps
      prices[j] = b2 - eps;                      // tight: pi+p = a exactly
      owner[j] = istar;
      sigma[istar] = (int32_t)j;
      if (progress) { ++matched; break; }
    }
    // Budget spent: the run is pure forward from here on, so stale
    // column entries must not keep the outer loop spinning (the column
    // queue can no longer change).
    if (reverse_budget <= 0) {
      while (cq_head != cq_tail) col_in[col_q[cq_head++ % m]] = 0;
    }
  }
  return bids;
}

// Warm-started eps-scaling: unassign only the pairs violating eps-CS for
// the new (smaller) eps.  Mirrors auction.py:unassign_violators exactly so
// device and host phases interoperate in the hybrid path.
template <typename T>
void unassign_violators(int64_t n, int64_t m, const int64_t* indptr,
                        const int32_t* indices, const T* vals, T* prices,
                        int32_t* sigma, int32_t* owner, T eps,
                        int64_t n_dummy_total) {
  for (int64_t u = 0; u < n; ++u) {
    int32_t j_cur = sigma[u];
    if (j_cur < 0) continue;
    T v1 = T(0), cur = T(0);
    bool has1 = false;
    for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
      T w = vals[k] - prices[indices[k]];
      if (!has1 || w > v1) { v1 = w; has1 = true; }
      if (indices[k] == j_cur) cur = w;
    }
    if (has1 && cur < v1 - eps) {
      owner[j_cur] = -1;
      sigma[u] = -1;
    }
  }
  if (n_dummy_total > 0) {
    T minp = prices[0];
    for (int64_t j = 1; j < m; ++j) minp = std::min(minp, prices[j]);
    for (int64_t j = 0; j < m; ++j) {
      if (owner[j] == -2 && prices[j] > minp + eps) owner[j] = -1;
    }
  }
}

// Forward-reverse dual tightening for warm starts (round 5; VERDICT r4
// task 4 / Bertsekas forward-reverse auction, arXiv:1401.0119 family).
//
// The forward auction's structural warm-start weakness: prices only RISE,
// so warm duals that are too high for the NEW cost pattern (edges churned
// away, values drifted down) leave displaced rows no bidding slack and
// eviction chains blow up (measured: 41-49M-bid chained-warm blowups at
// 1M, PERF.md round 4).  One tightening sweep repairs exactly that:
//
//   pi_i    = max_j (a_ij - p_j)              (row profits, forward pass)
//   p_j    <- min(p_j, max(0, max_i (a_ij - pi_i)))   (reverse pass)
//
// Properties (both one-line proofs from the max definitions):
//   * dual feasibility: a_ij - pi_i - p_j^new <= 0 on every edge;
//   * monotone descent: pi_i >= a_ij - p_j^old  =>  p_j^new <= p_j^old --
//     prices can only FALL, the direction forward bidding cannot move;
//   * columns whose supporting edges vanished fall to their true market
//     level (or 0 when nothing wants them), restoring bidding slack
//     without discarding the dual information the way a scalar
//     warm_relax multiply does.
// Correctness of the subsequent solve is unconditional: the auction
// converges from ANY finite non-negative starting prices; tightening only
// changes the bid count, never the fixed point.
template <typename T>
void fr_tighten(int64_t n, int64_t m, const int64_t* indptr,
                const int32_t* indices, const T* vals, T* prices,
                int64_t iters) {
  const T kLowest = std::numeric_limits<T>::lowest();
  std::vector<T> pi(n);
  std::vector<T> pnew(m);
  for (int64_t it = 0; it < iters; ++it) {
    for (int64_t i = 0; i < n; ++i) {
      T best = kLowest;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        T w = vals[k] - prices[indices[k]];
        if (w > best) best = w;
      }
      pi[i] = best;
    }
    std::fill(pnew.begin(), pnew.end(), kLowest);
    for (int64_t i = 0; i < n; ++i) {
      if (pi[i] == kLowest) continue;  // empty row supports nothing
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        T w = vals[k] - pi[i];
        int32_t j = indices[k];
        if (w > pnew[j]) pnew[j] = w;
      }
    }
    bool changed = false;
    for (int64_t j = 0; j < m; ++j) {
      T cand = (pnew[j] == kLowest) ? T(0) : std::max(T(0), pnew[j]);
      if (cand < prices[j]) {
        prices[j] = cand;
        changed = true;
      }
    }
    if (!changed) break;  // fixed point: further sweeps are no-ops
  }
}

}  // namespace

extern "C" {

int64_t sslap_auction_gs_fr_f32(int64_t n, int64_t m, const int64_t* indptr,
                                const int32_t* indices, const float* vals,
                                const int64_t* cindptr,
                                const int32_t* cindices, const float* cvals,
                                float* prices, float* profits,
                                int32_t* sigma, int32_t* owner, float eps,
                                float bigp, int64_t max_bids) {
  return auction_gs_fr<float>(n, m, indptr, indices, vals, cindptr,
                              cindices, cvals, prices, profits, sigma,
                              owner, eps, bigp, max_bids);
}

int64_t sslap_auction_gs_fr_f64(int64_t n, int64_t m, const int64_t* indptr,
                                const int32_t* indices, const double* vals,
                                const int64_t* cindptr,
                                const int32_t* cindices, const double* cvals,
                                double* prices, double* profits,
                                int32_t* sigma, int32_t* owner, double eps,
                                double bigp, int64_t max_bids) {
  return auction_gs_fr<double>(n, m, indptr, indices, vals, cindptr,
                               cindices, cvals, prices, profits, sigma,
                               owner, eps, bigp, max_bids);
}

int64_t sslap_auction_gs_fr_i32(int64_t n, int64_t m, const int64_t* indptr,
                                const int32_t* indices, const int32_t* vals,
                                const int64_t* cindptr,
                                const int32_t* cindices,
                                const int32_t* cvals, int32_t* prices,
                                int32_t* profits, int32_t* sigma,
                                int32_t* owner, int32_t eps, int32_t bigp,
                                int64_t max_bids) {
  return auction_gs_fr<int32_t>(n, m, indptr, indices, vals, cindptr,
                                cindices, cvals, prices, profits, sigma,
                                owner, eps, bigp, max_bids);
}

void sslap_fr_tighten_f32(int64_t n, int64_t m, const int64_t* indptr,
                          const int32_t* indices, const float* vals,
                          float* prices, int64_t iters) {
  fr_tighten<float>(n, m, indptr, indices, vals, prices, iters);
}

void sslap_fr_tighten_f64(int64_t n, int64_t m, const int64_t* indptr,
                          const int32_t* indices, const double* vals,
                          double* prices, int64_t iters) {
  fr_tighten<double>(n, m, indptr, indices, vals, prices, iters);
}

void sslap_fr_tighten_i32(int64_t n, int64_t m, const int64_t* indptr,
                          const int32_t* indices, const int32_t* vals,
                          int32_t* prices, int64_t iters) {
  fr_tighten<int32_t>(n, m, indptr, indices, vals, prices, iters);
}

void sslap_unassign_violators_f32(int64_t n, int64_t m, const int64_t* indptr,
                                  const int32_t* indices, const float* vals,
                                  float* prices, int32_t* sigma,
                                  int32_t* owner, float eps,
                                  int64_t n_dummy_total) {
  unassign_violators<float>(n, m, indptr, indices, vals, prices, sigma, owner,
                            eps, n_dummy_total);
}

void sslap_unassign_violators_i32(int64_t n, int64_t m, const int64_t* indptr,
                                  const int32_t* indices, const int32_t* vals,
                                  int32_t* prices, int32_t* sigma,
                                  int32_t* owner, int32_t eps,
                                  int64_t n_dummy_total) {
  unassign_violators<int32_t>(n, m, indptr, indices, vals, prices, sigma,
                              owner, eps, n_dummy_total);
}

int64_t sslap_auction_gs_f32(int64_t n, int64_t m, const int64_t* indptr,
                             const int32_t* indices, const float* vals,
                             float* prices, int32_t* sigma, int32_t* owner,
                             float eps, float bigp, int64_t n_dummy_total,
                             int64_t max_bids) {
  return auction_gs<float, false>(n, m, indptr, indices, vals, prices, sigma,
                                  owner, eps, bigp, n_dummy_total, max_bids);
}

int64_t sslap_auction_gs_i32(int64_t n, int64_t m, const int64_t* indptr,
                             const int32_t* indices, const int32_t* vals,
                             int32_t* prices, int32_t* sigma, int32_t* owner,
                             int32_t eps, int32_t bigp, int64_t n_dummy_total,
                             int64_t max_bids) {
  return auction_gs<int32_t, false>(n, m, indptr, indices, vals, prices,
                                    sigma, owner, eps, bigp, n_dummy_total,
                                    max_bids);
}

int64_t sslap_auction_gs_f64(int64_t n, int64_t m, const int64_t* indptr,
                             const int32_t* indices, const double* vals,
                             double* prices, int32_t* sigma, int32_t* owner,
                             double eps, double bigp, int64_t n_dummy_total,
                             int64_t max_bids) {
  return auction_gs<double, false>(n, m, indptr, indices, vals, prices,
                                   sigma, owner, eps, bigp, n_dummy_total,
                                   max_bids);
}

void sslap_unassign_violators_f64(int64_t n, int64_t m, const int64_t* indptr,
                                  const int32_t* indices, const double* vals,
                                  double* prices, int32_t* sigma,
                                  int32_t* owner, double eps,
                                  int64_t n_dummy_total) {
  unassign_violators<double>(n, m, indptr, indices, vals, prices, sigma,
                             owner, eps, n_dummy_total);
}

// Prefetching fast path (the framework's production GS; the plain variants
// above stay as the sslap-class benchmark baseline).
int64_t sslap_auction_gs_pf_f32(int64_t n, int64_t m, const int64_t* indptr,
                                const int32_t* indices, const float* vals,
                                float* prices, int32_t* sigma,
                                int32_t* owner, float eps, float bigp,
                                int64_t n_dummy_total, int64_t max_bids) {
  return auction_gs<float, true>(n, m, indptr, indices, vals, prices, sigma,
                                 owner, eps, bigp, n_dummy_total, max_bids);
}

int64_t sslap_auction_gs_pf_i32(int64_t n, int64_t m, const int64_t* indptr,
                                const int32_t* indices, const int32_t* vals,
                                int32_t* prices, int32_t* sigma,
                                int32_t* owner, int32_t eps, int32_t bigp,
                                int64_t n_dummy_total, int64_t max_bids) {
  return auction_gs<int32_t, true>(n, m, indptr, indices, vals, prices,
                                   sigma, owner, eps, bigp, n_dummy_total,
                                   max_bids);
}

}  // extern "C"
