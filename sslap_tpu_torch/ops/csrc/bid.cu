// K1: bid kernel over a compacted id list (sm_90a).
//
// Replaces sslap_tpu/ops/bid.py::_bid_kernel (the Pallas full-width bid),
// moved onto the compacted round of sslap_tpu/compact.py::compact_round:
// bid stage (compact.py:305-317) plus, with phase_start, the eps-CS
// violator scan (compact.py:319-334).
//
// Per live id (ids[i] < n), one thread runs round.cuh's bid_row (top-2
// of vals_m - prices[cols], the bid, and with phase_start the eps-CS
// violator scan): tgt = the row's best column for bidders, else m.  Dead
// slots (id >= n) emit tgt = m, bid = 0.  The eps-phase ladder (ladder.cu)
// runs the same bid_row in its stage A; this standalone launch serves the
// full-width Jacobi round (auction.jacobi_round); the batched entry serves
// the batched Jacobi solve (batch.py), where each row reads eps and bigp
// of its own instance.
//
// Bound on an H100: each live row reads K cols + K values (contiguous, 8K
// bytes) and gathers K prices at random columns; the price table (4 MB at
// m = 1M, f32) stays resident in the 50 MB L2, so a round is bounded by
// L2 gather latency and, on narrow ladder tiers, by launch latency.  This
// first version keeps one thread per row: simple, no shared memory, and
// enough independent rows per launch to fill the card at wide tiers.
#include "round.cuh"

namespace {

template <typename T>
__global__ void bid_kernel(const int32_t* __restrict__ ids, int64_t C,
                           const int32_t* __restrict__ cols,
                           const T* __restrict__ vals_m,
                           const int32_t* __restrict__ nvalid,
                           const T* __restrict__ prices,
                           int32_t* sigma, int32_t* owner,
                           int32_t n, int32_t m, int32_t K,
                           T eps, T bigp, const T* __restrict__ eps_of,
                           const T* __restrict__ bigp_of, int32_t rows_per,
                           T neg, T half_neg, int phase_start,
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
  if (eps_of != nullptr) {  // batched entry: the scalars of id's instance
    eps = eps_of[id / rows_per];
    bigp = bigp_of[id / rows_per];
  }
  // prices are not written during this launch: the read-only path is safe
  tgt[i] = sslap::bid_row<T>(
      id, cols, vals_m, nvalid[id], phase_start ? sigma[id] : -1,
      [=](int32_t c) { return __ldg(prices + c); }, m, K, eps, bigp, neg, half_neg,
      phase_start != 0, sigma, owner, &bid[i]);
}

template <typename T>
int launch_bid(const int32_t* ids, int64_t C, const int32_t* cols,
               const T* vals_m, const int32_t* nvalid, const T* prices,
               int32_t* sigma, int32_t* owner, int32_t n, int32_t m,
               int32_t K, T eps, T bigp, const T* eps_of, const T* bigp_of,
               int32_t rows_per, T neg, T half_neg, int phase_start,
               int32_t* tgt, T* bid, void* stream) {
  if (C > 0) {
    bid_kernel<T><<<sslap::grid_for(C), sslap::kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        ids, C, cols, vals_m, nvalid, prices, sigma, owner, n, m, K, eps,
        bigp, eps_of, bigp_of, rows_per, neg, half_neg, phase_start, tgt,
        bid);
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
                           owner, n, m, K, eps, bigp, nullptr, nullptr, 1,
                           neg, half_neg, phase_start, tgt, bid, stream);
}

int sslap_bid_i32(const int32_t* ids, int64_t C, const int32_t* cols,
                  const int32_t* vals_m, const int32_t* nvalid,
                  const int32_t* prices, int32_t* sigma, int32_t* owner,
                  int32_t n, int32_t m, int32_t K, int32_t eps, int32_t bigp,
                  int32_t neg, int32_t half_neg, int phase_start,
                  int32_t* tgt, int32_t* bid, void* stream) {
  return launch_bid<int32_t>(ids, C, cols, vals_m, nvalid, prices, sigma,
                             owner, n, m, K, eps, bigp, nullptr, nullptr, 1,
                             neg, half_neg, phase_start, tgt, bid, stream);
}

// The batched entry: ids, cols and the [n] / [m] tables are a batch's,
// flattened (row b * rows_per + r, column b * m_inst + c), and each row
// reads eps and bigp of its instance, eps_of[id / rows_per] and
// bigp_of[id / rows_per].
int sslap_bid_batched_f32(const int32_t* ids, int64_t C, const int32_t* cols,
                          const float* vals_m, const int32_t* nvalid,
                          const float* prices, int32_t* sigma, int32_t* owner,
                          int32_t n, int32_t m, int32_t K,
                          const float* eps_of, const float* bigp_of,
                          int32_t rows_per, float neg, float half_neg,
                          int phase_start, int32_t* tgt, float* bid,
                          void* stream) {
  return launch_bid<float>(ids, C, cols, vals_m, nvalid, prices, sigma,
                           owner, n, m, K, 0.0f, 0.0f, eps_of, bigp_of,
                           rows_per, neg, half_neg, phase_start, tgt, bid,
                           stream);
}

int sslap_bid_batched_i32(const int32_t* ids, int64_t C, const int32_t* cols,
                          const int32_t* vals_m, const int32_t* nvalid,
                          const int32_t* prices, int32_t* sigma,
                          int32_t* owner, int32_t n, int32_t m, int32_t K,
                          const int32_t* eps_of, const int32_t* bigp_of,
                          int32_t rows_per, int32_t neg, int32_t half_neg,
                          int phase_start, int32_t* tgt, int32_t* bid,
                          void* stream) {
  return launch_bid<int32_t>(ids, C, cols, vals_m, nvalid, prices, sigma,
                             owner, n, m, K, 0, 0, eps_of, bigp_of, rows_per,
                             neg, half_neg, phase_start, tgt, bid, stream);
}

}  // extern "C"
