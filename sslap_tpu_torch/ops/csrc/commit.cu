// K2: resolve + commit over a compacted round (sm_90a).
//
// Replaces sslap_tpu/ops/commit.py::_commit_kernel (the Pallas sequential
// max-scatter of bids into per-column (best, winner), contract
// sslap_tpu/auction.py::resolve_bids), and also applies the commit of
// sslap_tpu/compact.py::compact_round (compact.py:338-368): price raise,
// owner install, eviction, sigma update.
//
// The TPU kernel walks the bids in order on one core.  Blocks here run in
// no order, so the tie-break is carried by the key instead of the order:
// round.cuh's bid_key, (order-preserving uint32 of the bid) << 32 |
// (0xFFFFFFFF - row).  The highest key per column is the highest bid with
// the LOWEST row among equal bids.
//
// Two launches, one thread a bid:
//   resolve  thread 0 zeroes counts (the commit launch adds to them
//            after it).  Each warp groups its bids by column
//            (__match_any_sync on tgt) and takes each group's highest key
//            by shuffles; that lane alone makes the atomicMax on keys[tgt],
//            one per column the warp touches.  A warp with no bid (tgt == m
//            on every lane) loads nothing more.
//   commit   each bidder runs round.cuh's commit_bid: the one whose key
//            survived is its column's unique winner and commits (price,
//            owner, sigma, the evictee's sigma) and resets keys[tgt] to 0,
//            so the [m] key table is all zero again after the round.
//            counts = (won, evicted, stayed): each warp sums them with
//            __reduce_add_sync, each block adds them once.
// Outputs: stay (losers, else n_rows), evicted (previous owners, else
// n_rows).  Row ids are global: sigma holds rows [row_offset, row_offset +
// n_local) (0 and n for one device; a shard's rows when every shard
// commits the same all-gathered bids, parallel/sharded_compact.py), and a
// sigma write of another shard's row is skipped.  The
// eps-phase ladder (ladder.cu) runs round.cuh's bid_key and commit_bid in
// its stages A and B; this standalone pair serves auction.jacobi_round,
// the batched Jacobi solve, the dense engine and the sharded hybrid's
// compact rounds (with the shard's row offset); the resolve launch alone
// (sslap_resolve_*) serves the sharded and overlapped rounds, whose commit
// is commit_keys_kernel below.  One cooperative launch
// with a grid barrier between the passes was tried and lost: 6.5 us a
// launch with no bidder against 4.7 us for the two, and the batched
// mode='device' solve launches K2 on mostly dead id lists (PERF.md).
//
// Bound on an H100: per bidder 12 bytes of (id, tgt, bid) in and 8 of
// (stay, evicted) out, and per column won a few random 4-8 byte accesses
// to [m] tables that stay in the 50 MB L2.  The first version made one
// atomicMax per bidder, so bidders on one column serialised at L2 (the
// dense engine's and early rounds' popular columns); the random L2
// atomics and commit accesses, each a 32-byte sector, remain the limit.
#include "round.cuh"

namespace {

// The highest v over the lanes of the warp that bid (has) on the same
// column (label) as this lane; v itself for a lane that does not bid.
// Every lane of the warp calls it; it costs one shuffle per lane of the
// largest group.
__device__ __forceinline__ unsigned long long warp_max_by_label(
    bool has, int32_t label, unsigned long long v) {
  const int lane = threadIdx.x & 31;
  // a lane without a bid is a group of its own (columns are >= 0)
  const unsigned peers =
      __match_any_sync(sslap::kFullMask, has ? label : -1 - lane);
  const int rounds = static_cast<int>(
      __reduce_max_sync(sslap::kFullMask, __popc(peers)));
  if (rounds == 1) return v;   // no two bids of the warp share a column
  unsigned rest = peers;
  unsigned long long best = v;
  for (int t = 0; t < rounds; ++t) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    rest &= rest - 1;
    const unsigned long long o = __shfl_sync(sslap::kFullMask, v, src);
    best = o > best ? o : best;
  }
  return best;
}

template <typename T>
__global__ void __launch_bounds__(sslap::kBlock)
    resolve_kernel(const int32_t* __restrict__ ids,
                   const int32_t* __restrict__ tgt,
                   const T* __restrict__ bid, int64_t C, int32_t m,
                   unsigned long long* keys, int32_t* counts) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i < 3 && counts != nullptr) counts[i] = 0;
  // i - lane is the warp's first slot: the exit is warp-uniform
  if (i - (threadIdx.x & 31) >= C) return;
  const int32_t j = i < C ? __ldg(tgt + i) : m;
  const bool has = j < m;
  if (__ballot_sync(sslap::kFullMask, has) == 0) return;
  const unsigned long long key =
      has ? sslap::bid_key(__ldg(bid + i), __ldg(ids + i)) : 0ull;
  // every lane takes part in the shuffles, bidder or not
  if (has && key == warp_max_by_label(has, j, key))
    atomicMax(keys + j, key);
}

template <typename T>
__global__ void __launch_bounds__(sslap::kBlock)
    commit_kernel(const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ tgt,
                  const T* __restrict__ bid, int64_t C, int32_t n_rows,
                  int32_t m, unsigned long long* keys, T* prices,
                  int32_t* owner, int32_t* sigma, int32_t row_offset,
                  int32_t n_local, int32_t* __restrict__ stay,
                  int32_t* __restrict__ evicted, int32_t* counts) {
  __shared__ int s_counts[3];
  if (threadIdx.x < 3) s_counts[threadIdx.x] = 0;
  __syncthreads();
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  int won = 0, ev = 0, stayed = 0;
  if (i < C) {
    const int32_t j = __ldg(tgt + i);
    int32_t s = n_rows, e = n_rows;
    if (j < m) {
      bool w;
      const int32_t r = sslap::commit_bid(__ldg(ids + i), j, __ldg(bid + i),
                                          keys, prices, owner, sigma,
                                          row_offset, n_local, &w);
      if (w) {
        won = 1;
        if (r >= 0) {
          e = r;
          ev = 1;
        }
      } else {
        s = r;
        stayed = 1;
      }
    }
    stay[i] = s;
    evicted[i] = e;
  }
  won = __reduce_add_sync(sslap::kFullMask, won);
  ev = __reduce_add_sync(sslap::kFullMask, ev);
  stayed = __reduce_add_sync(sslap::kFullMask, stayed);
  if ((threadIdx.x & 31) == 0) {
    if (won) atomicAdd(&s_counts[0], won);
    if (ev) atomicAdd(&s_counts[1], ev);
    if (stayed) atomicAdd(&s_counts[2], stayed);
  }
  __syncthreads();
  if (threadIdx.x < 3 && s_counts[threadIdx.x] != 0)
    atomicAdd(&counts[threadIdx.x], s_counts[threadIdx.x]);
}

template <typename T>
int launch_commit(const int32_t* ids, const int32_t* tgt, const T* bid,
                  int64_t C, int32_t n_rows, int32_t m,
                  unsigned long long* keys, T* prices, int32_t* owner,
                  int32_t* sigma, int32_t row_offset, int32_t n_local,
                  int32_t* stay, int32_t* evicted, int32_t* counts,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = C > 0 ? sslap::grid_for(C) : 1;
  resolve_kernel<T><<<grid, sslap::kBlock, 0, s>>>(ids, tgt, bid, C, m,
                                                   keys, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  commit_kernel<T><<<grid, sslap::kBlock, 0, s>>>(
      ids, tgt, bid, C, n_rows, m, keys, prices, owner, sigma, row_offset,
      n_local, stay, evicted, counts);
  return static_cast<int>(cudaGetLastError());
}

// The resolve launch alone (the sharded round, parallel/sharded.py): the
// shard's bids folded into its [m] key table, which the caller combines
// across shards (an elementwise max) and zeroes again itself.
template <typename T>
int launch_resolve(const int32_t* ids, const int32_t* tgt, const T* bid,
                   int64_t C, int32_t m, unsigned long long* keys,
                   void* stream) {
  const unsigned grid = C > 0 ? sslap::grid_for(C) : 1;
  resolve_kernel<T><<<grid, sslap::kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      ids, tgt, bid, C, m, keys, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The fused key commit of the sharded and overlapped rounds
// (ops/commit.py:commit_keys).  No Pallas kernel stands behind it: it
// replaces the XLA jnp decode and commit of sslap_tpu/auction.py's
// commit_bids and the guarded commit of sslap_tpu/parallel/overlap.py:95-108
// that each shard applies to its replicas once a round.  Per column j of
// the combined key table: a zero key (no bid) is left alone;
// else the key is zeroed, (best, winner) decoded (the inverse of bid_key),
// and the bid accepted (guarded: best >= prices[j] + eps, one add and a
// compare in T, the reference's op; unguarded: best > half_neg, as
// commit_bids reads the decoded table).  An accepted bid evicts the old
// owner and installs the winner where their rows are the shard's
// [row_offset, row_offset + n_local), and writes prices[j] and owner[j].
// One pass equals the reference's every-eviction-before-any-assignment
// because no row is both evicted and assigned in one commit (a winner was
// unassigned when it bid; the plain version checks it).
//
// Bound on an H100: the [m] keys read (8 B a column) and, per column with a
// bid, its key zeroed and its price read (guarded) and written with the
// owner (read and written), and two 4-byte sigma writes: about 32 MB at
// m = 1M when every column has a bid, 9.6 us at 3.35 TB/s.  The accesses
// are coalesced (neighbouring threads take neighbouring columns) except the
// sigma writes, scattered 4-byte stores.  A thread takes kKeyCols columns
// a grid stride apart and runs them in stages (all keys, then the prices
// of those with a bid, then the owners of the accepted, then the writes),
// so that a thread keeps that many loads in flight (one column a thread
// left most of the card's memory rate unused).
constexpr int kKeyCols = 4;

__device__ __forceinline__ float decode_bid(uint32_t hi, float) {
  return __uint_as_float((hi & 0x80000000u) ? (hi ^ 0x80000000u) : ~hi);
}

__device__ __forceinline__ int32_t decode_bid(uint32_t hi, int32_t) {
  return static_cast<int32_t>(hi ^ 0x80000000u);
}

template <typename T>
__global__ void __launch_bounds__(sslap::kBlock)
    commit_keys_kernel(unsigned long long* __restrict__ keys, int32_t m,
                       T* __restrict__ prices, int32_t* __restrict__ owner,
                       int32_t* __restrict__ sigma, int32_t n_local,
                       int32_t row_offset, T eps, T half_neg, int guarded) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t j0 = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
  unsigned long long k[kKeyCols];
  bool any = false;
#pragma unroll
  for (int u = 0; u < kKeyCols; ++u) {
    const int64_t j = j0 + u * stride;
    k[u] = j < m ? keys[j] : 0ull;
    any |= k[u] != 0ull;
  }
  if (!any) return;
  T best[kKeyCols], price[kKeyCols];
#pragma unroll
  for (int u = 0; u < kKeyCols; ++u) {
    if (k[u] == 0ull) continue;
    const int64_t j = j0 + u * stride;
    keys[j] = 0ull;
    best[u] = decode_bid(static_cast<uint32_t>(k[u] >> 32), T());
    if (guarded) price[u] = prices[j];
  }
  bool accept[kKeyCols];
  int32_t prev[kKeyCols];
#pragma unroll
  for (int u = 0; u < kKeyCols; ++u) {
    accept[u] = k[u] != 0ull &&
                (guarded ? best[u] >= price[u] + eps : best[u] > half_neg);
    if (accept[u]) prev[u] = owner[j0 + u * stride];
  }
  const uint32_t local_n = static_cast<uint32_t>(n_local);
#pragma unroll
  for (int u = 0; u < kKeyCols; ++u) {
    if (!accept[u]) continue;
    const int64_t j = j0 + u * stride;
    const int32_t winner =
        static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(k[u]));
    prices[j] = best[u];
    owner[j] = winner;
    if (prev[u] >= 0) {
      const uint32_t e = static_cast<uint32_t>(prev[u] - row_offset);
      if (e < local_n) sigma[e] = -1;
    }
    const uint32_t w = static_cast<uint32_t>(winner - row_offset);
    if (w < local_n) sigma[w] = static_cast<int32_t>(j);
  }
}

template <typename T>
int launch_commit_keys(unsigned long long* keys, int32_t m, T* prices,
                       int32_t* owner, int32_t* sigma, int32_t n_local,
                       int32_t row_offset, T eps, T half_neg, int guarded,
                       void* stream) {
  const unsigned grid =
      m > 0 ? sslap::grid_for((m + kKeyCols - 1) / kKeyCols) : 1;
  commit_keys_kernel<T><<<grid, sslap::kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, m, prices, owner, sigma, n_local, row_offset, eps, half_neg,
      guarded);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sslap_commit_keys_f32(unsigned long long* keys, int32_t m, float* prices,
                          int32_t* owner, int32_t* sigma, int32_t n_local,
                          int32_t row_offset, float eps, float half_neg,
                          int guarded, void* stream) {
  return launch_commit_keys<float>(keys, m, prices, owner, sigma, n_local,
                                   row_offset, eps, half_neg, guarded,
                                   stream);
}

int sslap_commit_keys_i32(unsigned long long* keys, int32_t m,
                          int32_t* prices, int32_t* owner, int32_t* sigma,
                          int32_t n_local, int32_t row_offset, int32_t eps,
                          int32_t half_neg, int guarded, void* stream) {
  return launch_commit_keys<int32_t>(keys, m, prices, owner, sigma, n_local,
                                     row_offset, eps, half_neg, guarded,
                                     stream);
}

int sslap_resolve_f32(const int32_t* ids, const int32_t* tgt,
                      const float* bid, int64_t C, int32_t m,
                      unsigned long long* keys, void* stream) {
  return launch_resolve<float>(ids, tgt, bid, C, m, keys, stream);
}

int sslap_resolve_i32(const int32_t* ids, const int32_t* tgt,
                      const int32_t* bid, int64_t C, int32_t m,
                      unsigned long long* keys, void* stream) {
  return launch_resolve<int32_t>(ids, tgt, bid, C, m, keys, stream);
}

int sslap_commit_f32(const int32_t* ids, const int32_t* tgt,
                     const float* bid, int64_t C, int32_t n_rows, int32_t m,
                     unsigned long long* keys, float* prices, int32_t* owner,
                     int32_t* sigma, int32_t row_offset, int32_t n_local,
                     int32_t* stay, int32_t* evicted, int32_t* counts,
                     void* stream) {
  return launch_commit<float>(ids, tgt, bid, C, n_rows, m, keys, prices,
                              owner, sigma, row_offset, n_local, stay,
                              evicted, counts, stream);
}

int sslap_commit_i32(const int32_t* ids, const int32_t* tgt,
                     const int32_t* bid, int64_t C, int32_t n_rows,
                     int32_t m, unsigned long long* keys, int32_t* prices,
                     int32_t* owner, int32_t* sigma, int32_t row_offset,
                     int32_t n_local, int32_t* stay, int32_t* evicted,
                     int32_t* counts, void* stream) {
  return launch_commit<int32_t>(ids, tgt, bid, C, n_rows, m, keys, prices,
                                owner, sigma, row_offset, n_local, stay,
                                evicted, counts, stream);
}

}  // extern "C"
