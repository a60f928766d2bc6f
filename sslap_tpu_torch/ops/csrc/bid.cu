// K1: bid kernel over a compacted id list (sm_90a).
//
// Replaces sslap_tpu/ops/bid.py::_bid_kernel (the Pallas full-width bid),
// moved onto the compacted round of sslap_tpu/compact.py::compact_round:
// bid stage (compact.py:305-317) plus, with phase_start, the eps-CS
// violator scan (compact.py:319-334).
//
// Per live id (ids[i] < n), one thread:
//   w_k   = vals_m[id, k] - prices[cols[id, k]]        (one subtract)
//   v1    = max_k w_k, slot = first k reaching it      (lowest column)
//   v2    = max(neg, w_k for k != slot), or v1 - bigp when nvalid < 2
//   a*    = vals_m[id, slot] + 0                        (the reference's
//           one-hot sum: turns -0.0 into +0.0)
//   bid   = (a* - v2) + eps,  tgt = cols[id, slot] for bidders, else m.
// phase_start: cur = 0 + w at the row's current column (real slots only),
//   viol = sigma >= 0 && cur < v1 - eps; a violator clears owner[sigma]
//   and sigma[id] (race-free: an assignment is a matching, and each thread
//   writes only its own row and its own column) and bids in this round.
// Dead slots (id >= n) emit tgt = m, bid = 0.
//
// Bound on an H100: each live row reads K cols + K values (contiguous, 8K
// bytes) and gathers K prices at random columns; the price table (4 MB at
// m = 1M, f32) stays resident in the 50 MB L2, so a round is bounded by
// L2 gather latency and, on narrow ladder tiers, by launch latency.  This
// first version keeps one thread per row: simple, no shared memory, and
// enough independent rows per launch to fill the card at wide tiers.
#include "common.cuh"

namespace {

template <typename T>
__global__ void bid_kernel(const int32_t* __restrict__ ids, int64_t C,
                           const int32_t* __restrict__ cols,
                           const T* __restrict__ vals_m,
                           const int32_t* __restrict__ nvalid,
                           const T* __restrict__ prices,
                           int32_t* sigma, int32_t* owner,
                           int32_t n, int32_t m, int32_t K,
                           T eps, T bigp, T neg, T half_neg, int phase_start,
                           int32_t* __restrict__ tgt, T* __restrict__ bid) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= C) return;
  const int32_t id = ids[i];
  if (id >= n) {
    tgt[i] = m;
    bid[i] = T(0);
    return;
  }
  const int32_t* crow = cols + static_cast<int64_t>(id) * K;
  const T* vrow = vals_m + static_cast<int64_t>(id) * K;
  const int32_t nv = nvalid[id];
  const int32_t sig = phase_start ? sigma[id] : -1;

  int32_t c = crow[0];
  T w = vrow[0] - prices[c];
  T v1 = w, v2 = neg, cur = T(0);
  int32_t slot = 0;
  if (c == sig && w > half_neg) cur = cur + w;
  for (int32_t k = 1; k < K; ++k) {
    c = crow[k];
    w = vrow[k] - prices[c];
    if (w > v1) {
      v2 = v1 > v2 ? v1 : v2;
      v1 = w;
      slot = k;
    } else {
      v2 = w > v2 ? w : v2;
    }
    if (c == sig && w > half_neg) cur = cur + w;
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
  tgt[i] = bidding ? crow[slot] : m;
  bid[i] = (a_star - v2) + eps;
}

template <typename T>
int launch_bid(const int32_t* ids, int64_t C, const int32_t* cols,
               const T* vals_m, const int32_t* nvalid, const T* prices,
               int32_t* sigma, int32_t* owner, int32_t n, int32_t m,
               int32_t K, T eps, T bigp, T neg, T half_neg, int phase_start,
               int32_t* tgt, T* bid, void* stream) {
  if (C > 0) {
    bid_kernel<T><<<sslap::grid_for(C), sslap::kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        ids, C, cols, vals_m, nvalid, prices, sigma, owner, n, m, K, eps,
        bigp, neg, half_neg, phase_start, tgt, bid);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sslap_bid_f32(const int32_t* ids, int64_t C, const int32_t* cols,
                  const float* vals_m, const int32_t* nvalid,
                  const float* prices, int32_t* sigma, int32_t* owner,
                  int32_t n, int32_t m, int32_t K, float eps, float bigp,
                  float neg, float half_neg, int phase_start, int32_t* tgt,
                  float* bid, void* stream) {
  return launch_bid<float>(ids, C, cols, vals_m, nvalid, prices, sigma,
                           owner, n, m, K, eps, bigp, neg, half_neg,
                           phase_start, tgt, bid, stream);
}

int sslap_bid_i32(const int32_t* ids, int64_t C, const int32_t* cols,
                  const int32_t* vals_m, const int32_t* nvalid,
                  const int32_t* prices, int32_t* sigma, int32_t* owner,
                  int32_t n, int32_t m, int32_t K, int32_t eps, int32_t bigp,
                  int32_t neg, int32_t half_neg, int phase_start,
                  int32_t* tgt, int32_t* bid, void* stream) {
  return launch_bid<int32_t>(ids, C, cols, vals_m, nvalid, prices, sigma,
                             owner, n, m, K, eps, bigp, neg, half_neg,
                             phase_start, tgt, bid, stream);
}

}  // extern "C"
