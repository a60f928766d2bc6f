// The bit-exact arithmetic of one compacted auction round (sm_90a), shared
// by K1 (bid.cu), K2 (commit.cu) and the eps-phase ladder (ladder.cu), so
// that the three kernels have one source for it.
//
//   bid_row     K1's row arithmetic: top-2 of w_k = vals_m - price, the
//               bid, and with phase_start the eps-CS violator scan.
//   bid_lanes   the same row split over a group of G lanes of a warp
//   bid_finish  (K1's standalone kernel, bid.cu), the group's result
//               merged and turned into the bid.
//   bid_key     K2's resolve key: one 64-bit atomicMax per bidder leaves,
//               per column, the highest bid with the lowest row.
//   commit_bid  K2's commit of one bid whose key survived (sigma may be
//               one shard's rows).
#pragma once

#include <climits>

#include "common.cuh"

namespace sslap {

constexpr unsigned kFullMask = 0xffffffffu;

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

// One lane's part of a row, split over a group of G lanes (bid_lanes):
// v1 and slot are the lane's first maximum of w (slot == K: the lane had
// no slot), v2 the max of neg and the lane's other w, a and col the
// value and column at slot, cur the sum of 0 and the real w at `sig`.
template <typename T>
struct LaneTop {
  T v1, v2, a, cur;
  int32_t slot, col;
};

template <typename T>
__device__ __forceinline__ T lowest();
template <>
__device__ __forceinline__ float lowest<float>() {
  return __int_as_float(static_cast<int>(0xff800000u));   // -inf
}
template <>
__device__ __forceinline__ int32_t lowest<int32_t>() { return INT_MIN; }

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load4(const int32_t* p, int32_t* out) {
  const int4 x = __ldg(reinterpret_cast<const int4*>(p));
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

// Slots a lane takes per step of bid_lanes: 8 words, or two 16-byte loads.
constexpr int kLaneSlots = 8;

// bid_row's scan of row `id` (live: id < n) by lane g of a group of G
// lanes, then merged over the group, so that every lane of the group
// returns the row's (v1, slot, v2, a, col, cur).  Each step a lane takes
// kLaneSlots slots as units of V: unit g + q G (q = 0, 1, ...) holds slots
// k0 + V (g + q G) + (0 .. V - 1), so neighbouring lanes read neighbouring
// words (V == 1) or 16-byte vectors of cols and vals_m (V == 4: K % 4 ==
// 0, 16-byte aligned rows); then its price gathers, all in flight
// together, then the arithmetic in slot order.  The merge is a butterfly
// of __shfl_xor_sync over the group: the higher v1 wins, the lower slot
// among equal v1 (bid_row's first maximum), v2 = max(the winner's v2, the
// loser's v1), cur adds up.  Every lane of the warp must call it (the
// shuffles take the full mask); a dead row loads nothing.
template <typename T, int G, int V, typename Price>
__device__ __forceinline__ LaneTop<T> bid_lanes(
    int32_t id, bool live, int g, const int32_t* __restrict__ cols,
    const T* __restrict__ vals_m, int32_t sig, Price price, int32_t K,
    T neg, T half_neg) {
  static_assert(V == 1 || V == 4, "V is 1 or 4 slots a load");
  constexpr int kPer = kLaneSlots;
  LaneTop<T> r{lowest<T>(), neg, T(0), T(0), K, 0};
  if (live) {
    const int32_t* crow = cols + static_cast<int64_t>(id) * K;
    const T* vrow = vals_m + static_cast<int64_t>(id) * K;
    for (int32_t k0 = 0; k0 < K; k0 += G * kPer) {
      int32_t k[kPer], c[kPer];
      T v[kPer], p[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        k[u] = k0 + V * (g + (u / V) * G) + u % V;
      if (V == 4) {
#pragma unroll
        for (int u = 0; u < kPer; u += 4) {
          if (k[u] < K) {
            load4(crow + k[u], c + u);
            load4(vrow + k[u], v + u);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          if (k[u] < K) {
            c[u] = __ldg(crow + k[u]);
            v[u] = __ldg(vrow + k[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (k[u] < K) p[u] = price(c[u]);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (k[u] >= K) break;
        const T w = v[u] - p[u];
        if (r.slot == K) {
          r.v1 = w;
          r.slot = k[u];
          r.a = v[u];
          r.col = c[u];
        } else if (w > r.v1) {
          r.v2 = r.v1 > r.v2 ? r.v1 : r.v2;
          r.v1 = w;
          r.slot = k[u];
          r.a = v[u];
          r.col = c[u];
        } else {
          r.v2 = w > r.v2 ? w : r.v2;
        }
        if (c[u] == sig && w > half_neg) r.cur = r.cur + w;
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const T ov1 = __shfl_xor_sync(kFullMask, r.v1, off);
    const T ov2 = __shfl_xor_sync(kFullMask, r.v2, off);
    const T oa = __shfl_xor_sync(kFullMask, r.a, off);
    const T ocur = __shfl_xor_sync(kFullMask, r.cur, off);
    const int32_t oslot = __shfl_xor_sync(kFullMask, r.slot, off);
    const int32_t ocol = __shfl_xor_sync(kFullMask, r.col, off);
    const bool take = ov1 > r.v1 || (ov1 == r.v1 && oslot < r.slot);
    // the same operands in both lanes of the pair: winner's v2, loser's v1
    const T wv2 = take ? ov2 : r.v2;
    const T lv1 = take ? r.v1 : ov1;
    r.v2 = lv1 > wv2 ? lv1 : wv2;
    if (take) {
      r.v1 = ov1;
      r.slot = oslot;
      r.a = oa;
      r.col = ocol;
    }
    r.cur = r.cur + ocur;
  }
  return r;
}

// bid_row's ending on a row merged by bid_lanes (one lane of the group
// calls it): v2 = v1 - bigp when nv < 2; a* = a + 0; *bid = (a* - v2) +
// eps; with phase_start a violator (sig >= 0 && cur < v1 - eps) clears
// owner[sig] and sigma[id] and bids.  Returns the target column, or m.
template <typename T>
__device__ __forceinline__ int32_t bid_finish(
    const LaneTop<T>& r, int32_t id, int32_t nv, int32_t sig, int32_t m,
    T eps, T bigp, bool phase_start, int32_t* sigma, int32_t* owner,
    T* bid) {
  const T v2 = nv < 2 ? r.v1 - bigp : r.v2;
  const T a_star = r.a + T(0);
  bool bidding = nv > 0;
  if (phase_start) {
    const bool viol = sig >= 0 && r.cur < r.v1 - eps;
    if (viol) {
      owner[sig] = -1;
      sigma[id] = -1;
    }
    bidding = bidding && (sig < 0 || viol);
  }
  *bid = (a_star - v2) + eps;
  return bidding ? r.col : m;
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
// and the sigma of its row and the evictee's (an evictee is assigned, so
// never a bidder of this round: the writes are disjoint).  Rows are
// global ids and `sigma` holds rows [row_offset, row_offset + n_local):
// a row outside them belongs to another shard, whose sigma write is
// skipped here (K2 over a gathered set, parallel/sharded_compact.py); the
// ladder passes 0 and n.  keys and owner are read through L2 (__ldcg), so
// a caller may run this after a grid barrier.  Returns the row to relist:
// the bidder if it lost, the evicted previous owner (or -1 for none) if
// it won; *won says which.
template <typename T>
__device__ __forceinline__ int32_t commit_bid(int32_t id, int32_t j, T b,
                                              unsigned long long* keys,
                                              T* prices, int32_t* owner,
                                              int32_t* sigma,
                                              int32_t row_offset,
                                              int32_t n_local, bool* won) {
  if (__ldcg(keys + j) != bid_key(b, id)) {
    *won = false;
    return id;
  }
  keys[j] = 0ull;
  const int32_t prev = __ldcg(owner + j);
  prices[j] = b;
  owner[j] = id;
  const uint32_t local_n = static_cast<uint32_t>(n_local);
  const uint32_t w = static_cast<uint32_t>(id - row_offset);
  if (w < local_n) sigma[w] = j;
  if (prev >= 0) {
    const uint32_t e = static_cast<uint32_t>(prev - row_offset);
    if (e < local_n) sigma[e] = -1;
  }
  *won = true;
  return prev;
}

}  // namespace sslap
