// DK: the dense bid of the batched dense engine (sm_90a).
//
// No TPU kernel is behind this op: it replaces the XLA-compiled
// sslap_tpu/dense_batch.py::_dense_bids, the only per-round op of the dense
// engine that reads n x m elements.  Per row of a dense [B, n, m] block of
// maximisation values (missing entries = the neg sentinel):
//
//   w_c = A[r, c] - p[c]                 (one subtract, never stored)
//   j = first c with w_c = v1 = max_c w_c (lowest column among equals)
//   v2 = max(neg, w_c for c != j), or v1 - bigp when nvalid < 2
//   a* = v1 + p[j]                       ((A - p) + p: not A in float32)
//   bid = (a* - v2) + eps[b]
//   tgt = b m + j for a row that bids (sigma < 0, nvalid > 0), else B m
//
// with b = id / n the row's instance, so that K2 (commit.cu) resolves the
// bids of a whole chunk over the flattened columns b m + c.  v1 is written
// too when asked for (the phase-start eps-CS violator scan needs it).
//
// One warp per id (pad ids >= B n write tgt = B m, bid = 0).  Lane l walks
// the row's 16-byte groups l, l + 32, ... in ascending column order,
// keeping (v1, j, v2) with the first maximum; the lanes then merge by
// butterfly shuffles: the larger v1 wins, on equal v1 the lower column,
// and v2 becomes the max of both v2 and the loser's v1 (the equal value on
// a tie).  The result does not depend on the merge order: max is exact,
// and a +-0.0 difference in v2 cannot change (a* - v2) + eps.
//
// Bound on an H100: the bytes of the rows that bid (m * 4 each, streamed
// once with evict-first loads) plus each instance's price row (read by all
// its rows, so it stays in L1/L2); 3.35 TB/s sets the floor.  The design
// keeps every load 16 bytes wide and coalesced across the warp, and enough
// warps resident (8 per block, no shared memory) to keep the memory busy.
#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = sslap::kBlock / kWarp;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<int32_t> {
  using type = int4;
};

__device__ __forceinline__ float lowest(float) {
  return __int_as_float(static_cast<int>(0xff800000u));  // -inf
}
__device__ __forceinline__ int32_t lowest(int32_t) { return INT32_MIN; }

template <typename T>
struct Top2 {
  T v1, v2;
  int32_t j;

  __device__ __forceinline__ void push(T w, int32_t c) {
    if (w > v1) {
      v2 = v1 > v2 ? v1 : v2;
      v1 = w;
      j = c;
    } else {
      v2 = w > v2 ? w : v2;
    }
  }

  __device__ __forceinline__ void merge_warp() {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const T o1 = __shfl_xor_sync(0xffffffffu, v1, off);
      const T o2 = __shfl_xor_sync(0xffffffffu, v2, off);
      const int32_t oj = __shfl_xor_sync(0xffffffffu, j, off);
      const bool take = o1 > v1 || (o1 == v1 && oj < j);
      const T loser = take ? v1 : o1;
      T m2 = v2 > o2 ? v2 : o2;
      m2 = m2 > loser ? m2 : loser;
      if (take) {
        v1 = o1;
        j = oj;
      }
      v2 = m2;
    }
  }
};

template <typename T>
__global__ void dense_bid_kernel(const int32_t* __restrict__ ids, int64_t C,
                                 const T* __restrict__ A,
                                 const int32_t* __restrict__ nvalid,
                                 const T* __restrict__ prices,
                                 const int32_t* __restrict__ sigma,
                                 const T* __restrict__ eps_of, T bigp, T neg,
                                 int32_t n, int32_t m, int32_t rows,
                                 int32_t no_bid, int vec,
                                 int32_t* __restrict__ tgt,
                                 T* __restrict__ bid, T* __restrict__ v1_out) {
  const int64_t i = (blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (i >= C) return;
  const int32_t id = ids[i];
  if (id >= rows) {
    if (lane == 0) {
      tgt[i] = no_bid;
      bid[i] = T(0);
      if (v1_out != nullptr) v1_out[i] = T(0);
    }
    return;
  }
  const int32_t b = id / n;
  const T* row = A + static_cast<int64_t>(id) * m;
  const T* p = prices + static_cast<int64_t>(b) * m;
  Top2<T> t{lowest(T(0)), neg, INT32_MAX};
  if (vec) {
    using V = typename Vec<T>::type;
    const V* row4 = reinterpret_cast<const V*>(row);
    const V* p4 = reinterpret_cast<const V*>(p);
    const int32_t m4 = m / 4;
#pragma unroll 4
    for (int32_t q = lane; q < m4; q += kWarp) {
      const V a = __ldcs(row4 + q);
      const V pq = __ldg(p4 + q);
      const int32_t c = 4 * q;
      t.push(a.x - pq.x, c);
      t.push(a.y - pq.y, c + 1);
      t.push(a.z - pq.z, c + 2);
      t.push(a.w - pq.w, c + 3);
    }
  } else {
    for (int32_t c = lane; c < m; c += kWarp)
      t.push(__ldcs(row + c) - __ldg(p + c), c);
  }
  t.merge_warp();
  if (lane != 0) return;
  const int32_t nv = nvalid[id];
  const T v2 = nv >= 2 ? t.v2 : t.v1 - bigp;
  const T a_star = t.v1 + p[t.j];
  bid[i] = (a_star - v2) + eps_of[b];
  tgt[i] = (sigma[id] < 0 && nv > 0) ? b * m + t.j : no_bid;
  if (v1_out != nullptr) v1_out[i] = t.v1;
}

template <typename T>
int launch_dense_bid(const int32_t* ids, int64_t C, const T* A,
                     const int32_t* nvalid, const T* prices,
                     const int32_t* sigma, const T* eps_of, T bigp, T neg,
                     int32_t n, int32_t m, int32_t rows, int32_t no_bid,
                     int vec, int32_t* tgt, T* bid, T* v1_out, void* stream) {
  if (C > 0) {
    const int64_t blocks = (C + kWarpsPerBlock - 1) / kWarpsPerBlock;
    dense_bid_kernel<T><<<static_cast<unsigned>(blocks), sslap::kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        ids, C, A, nvalid, prices, sigma, eps_of, bigp, neg, n, m, rows,
        no_bid, vec, tgt, bid, v1_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sslap_dense_bid_f32(const int32_t* ids, int64_t C, const float* A,
                        const int32_t* nvalid, const float* prices,
                        const int32_t* sigma, const float* eps_of, float bigp,
                        float neg, int32_t n, int32_t m, int32_t rows,
                        int32_t no_bid, int vec, int32_t* tgt, float* bid,
                        float* v1_out, void* stream) {
  return launch_dense_bid<float>(ids, C, A, nvalid, prices, sigma, eps_of,
                                 bigp, neg, n, m, rows, no_bid, vec, tgt, bid,
                                 v1_out, stream);
}

int sslap_dense_bid_i32(const int32_t* ids, int64_t C, const int32_t* A,
                        const int32_t* nvalid, const int32_t* prices,
                        const int32_t* sigma, const int32_t* eps_of,
                        int32_t bigp, int32_t neg, int32_t n, int32_t m,
                        int32_t rows, int32_t no_bid, int vec, int32_t* tgt,
                        int32_t* bid, int32_t* v1_out, void* stream) {
  return launch_dense_bid<int32_t>(ids, C, A, nvalid, prices, sigma, eps_of,
                                   bigp, neg, n, m, rows, no_bid, vec, tgt,
                                   bid, v1_out, stream);
}

}  // extern "C"
