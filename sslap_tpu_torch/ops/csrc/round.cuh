// The bit-exact arithmetic of one compacted auction round (sm_90a), shared
// by K1 (bid.cu), K2 (commit.cu) and the eps-phase ladder (ladder.cu), so
// that the three kernels have one source for it.
//
//   bid_row     K1's row arithmetic: top-2 of w_k = vals_m - price, the
//               bid, and with phase_start the eps-CS violator scan.
//   bid_key     K2's resolve key: one 64-bit atomicMax per bidder leaves,
//               per column, the highest bid with the lowest row.
//   commit_bid  K2's commit of one bid whose key survived.
#pragma once

#include "common.cuh"

namespace sslap {

// Per row (id < n): w_k = vals_m[id, k] - price(cols[id, k]) (one
// subtract); v1 = max_k w_k, slot = first k reaching it (lowest column);
// v2 = max(neg, w_k for k != slot), or v1 - bigp when nv < 2; a* =
// vals_m[id, slot] + 0 (the reference's one-hot sum: -0.0 becomes +0.0);
// *bid = (a* - v2) + eps.  phase_start: cur = 0 + w at the row's current
// column `sig` (real slots only); a violator (sig >= 0 && cur < v1 - eps)
// clears owner[sig] and sigma[id] (race-free: an assignment is a matching,
// and each thread writes only its own row and its own column) and bids in
// this round.  Returns the target column, or m for a row that does not
// bid.  `price(c)` loads prices[c]: the caller picks the load path.
//
// The slots go in chunks of kChunk: a chunk's columns and values are
// loaded together, then its prices, then the arithmetic runs in slot
// order.  A row then waits on 2 ceil(K / kChunk) dependent memory round
// trips, not 2 K (column, then its price, slot after slot), which is what
// a round costs when few rows are live.
constexpr int kChunk = 4;

template <typename T, typename Price>
__device__ __forceinline__ int32_t bid_row(
    int32_t id, const int32_t* __restrict__ cols,
    const T* __restrict__ vals_m, int32_t nv, int32_t sig, Price price,
    int32_t m, int32_t K, T eps, T bigp, T neg, T half_neg,
    bool phase_start, int32_t* sigma, int32_t* owner, T* bid) {
  const int32_t* crow = cols + static_cast<int64_t>(id) * K;
  const T* vrow = vals_m + static_cast<int64_t>(id) * K;
  T v1 = neg, v2 = neg, cur = T(0);
  int32_t slot = 0;
  for (int32_t k0 = 0; k0 < K; k0 += kChunk) {
    int32_t c[kChunk];
    T v[kChunk], p[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (k0 + u < K) {
        c[u] = crow[k0 + u];
        v[u] = vrow[k0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (k0 + u < K) p[u] = price(c[u]);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (k0 + u >= K) break;
      const T w = v[u] - p[u];
      if (k0 + u == 0) {
        v1 = w;
      } else if (w > v1) {
        v2 = v1 > v2 ? v1 : v2;
        v1 = w;
        slot = k0 + u;
      } else {
        v2 = w > v2 ? w : v2;
      }
      if (c[u] == sig && w > half_neg) cur = cur + w;
    }
  }
  if (nv < 2) v2 = v1 - bigp;
  const T a_star = vrow[slot] + T(0);
  bool bidding = nv > 0;
  if (phase_start) {
    const bool viol = sig >= 0 && cur < v1 - eps;
    if (viol) {
      owner[sig] = -1;
      sigma[id] = -1;
    }
    bidding = bidding && (sig < 0 || viol);
  }
  *bid = (a_star - v2) + eps;
  return bidding ? crow[slot] : m;
}

// Order-preserving uint32 of a bid.  Floats: flip all bits of negatives,
// set the sign bit of non-negatives, after -0.0 is canonicalised to +0.0
// (the reference's b == best treats them as equal).  int32: flip the sign.
__device__ __forceinline__ uint32_t order_bits(float b) {
  if (b == 0.0f) b = 0.0f;
  const uint32_t u = __float_as_uint(b);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t order_bits(int32_t b) {
  return static_cast<uint32_t>(b) ^ 0x80000000u;
}

// (order bits) << 32 | (0xFFFFFFFF - row): a larger key is a higher bid,
// then a lower row.  Every real key is > 0.
template <typename T>
__device__ __forceinline__ unsigned long long bid_key(T b, int32_t row) {
  return (static_cast<unsigned long long>(order_bits(b)) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu -
                                         static_cast<uint32_t>(row));
}

// Commit row `id`'s bid `b` on column j < m after every bid of the round
// has been folded into keys.  The bidder whose key survived is the
// column's unique winner: it resets keys[j] to 0 (every column that got a
// bid has one winner, so the [m] table is all zero again after the round
// with no memset; a loser that reads the cleared key still compares
// unequal), reads the previous owner, writes price = its bid, owner,
// sigma, and clears the evictee's sigma (an evictee is assigned, so never
// a bidder of this round: the writes are disjoint).  keys and owner are
// read through L2 (__ldcg), so a caller may run this after a grid barrier.
// Returns the row to relist: the bidder if it lost, the evicted previous
// owner (or -1 for none) if it won; *won says which.
template <typename T>
__device__ __forceinline__ int32_t commit_bid(int32_t id, int32_t j, T b,
                                              unsigned long long* keys,
                                              T* prices, int32_t* owner,
                                              int32_t* sigma, bool* won) {
  if (__ldcg(keys + j) != bid_key(b, id)) {
    *won = false;
    return id;
  }
  keys[j] = 0ull;
  const int32_t prev = __ldcg(owner + j);
  prices[j] = b;
  owner[j] = id;
  sigma[id] = j;
  if (prev >= 0) sigma[prev] = -1;
  *won = true;
  return prev;
}

}  // namespace sslap
