// K3: serial FIFO Gauss-Seidel auction (sm_90a).
//
// Replaces sslap_tpu/ops/gs_kernel.py::_gs_kernel (the Pallas kernel behind
// gs_auction_device), with the bid semantics of the native auction_gs
// (sslap_tpu/native/sslap_native.cpp), its oracle.  Per bid:
//   u      = queue[head], head = (head + 1) mod cap
//   w_k    = (vals[u,k]+0) - (prices[cols[u,k]]+0) where vals[u,k] >
//            real_min, else neg                     (the +0 mirror the TPU
//            kernel's one-hot reads, which turn -0.0 into +0.0)
//   v1     = max_k w_k at the lowest slot reaching it; v2 = max of the
//            rest; v2 = v1 - bigp unless v2 > neg * 0.5
//   bid    = (a* - v2) + eps on j* = cols[u, slot]; the previous owner of
//            j* is pushed at the tail; prices[j*] = bid, owner[j*] = u.
// It stops when the ring is empty or after max_bids bids, and writes
// (bids, rows left in the ring).  Padding is the port's neg sentinel
// (real_min = half of it), not the TPU kernel's "vals <= -bigp", which
// misreads real entries of min problems whose costs are all >= 1.
//
// One CTA of one warp.  Each bid's row is spread over the lanes (slot k on
// lane k mod 32), so its K column/value loads and K price gathers are in
// flight together; a butterfly of shuffles merges the lanes' top-2
// summaries (ordered by w, then by the lowest slot); lane 0 reads the
// owner, writes the ring, the price and the owner.  The mutable tables
// (prices, owner, queue) are read with plain loads, never __ldg/.nc, and
// __syncwarp() after lane 0's writes orders them before the next bid's
// reads.  Ring positions and row offsets are 64-bit, so n*K has no int32
// bound.
//
// Bound on an H100: latency.  A bid is a chain of dependent accesses --
// queue slot, then the row's cols/vals, then the prices at those columns,
// then owner[j*] -- each an L2 (or, for row data beyond the 50 MB L2, HBM)
// round trip, with nothing else on the card to hide it: ~1-2 us per bid is
// the expected scale, above a host core's ~0.2-0.7 us on the same chain.
// This first version keeps the chain plain; prefetching the next queued
// row, as the TPU kernel's double-buffered DMA does, is the next step.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNone = 0x7FFFFFFF;   // no slot seen yet (sorts after all)

__device__ __forceinline__ float fmax_sel(float a, float b) {
  return b > a ? b : a;
}

__global__ void gs_kernel(const int32_t* __restrict__ cols,
                          const float* __restrict__ vals, int32_t K,
                          int32_t* queue, int64_t cap, int64_t qcount,
                          float* prices, int32_t* owner, float eps,
                          float bigp, float neg, float half, float real_min,
                          int64_t max_bids, int64_t* stats) {
  const int lane = threadIdx.x;
  int64_t head = 0, tail = qcount, bids = 0;
  while (head != tail && bids < max_bids) {
    int32_t u = 0;
    if (lane == 0) u = queue[head];
    u = __shfl_sync(kFull, u, 0);
    head = head + 1 == cap ? 0 : head + 1;
    const int64_t row = static_cast<int64_t>(u) * K;

    // This lane's slots: a sequential top-2 with strict '>', so the
    // lowest slot keeps a tie.
    float v1 = neg, v2 = neg;
    int slot = kNone;
    for (int k = lane; k < K; k += 32) {
      const float vk = vals[row + k] + 0.0f;
      const float pk = prices[cols[row + k]] + 0.0f;
      const float w = vk > real_min ? vk - pk : neg;
      if (w > v1) {
        v2 = v1;
        v1 = w;
        slot = k;
      } else {
        v2 = fmax_sel(v2, w);
      }
    }
    // Merge the lanes: the higher v1 wins, then the lower slot; the loser's
    // v1 competes for the second place.
    for (int d = 16; d > 0; d >>= 1) {
      const float o1 = __shfl_xor_sync(kFull, v1, d);
      const float o2 = __shfl_xor_sync(kFull, v2, d);
      const int os = __shfl_xor_sync(kFull, slot, d);
      if (o1 > v1 || (o1 == v1 && os < slot)) {
        v2 = fmax_sel(v1, o2);
        v1 = o1;
        slot = os;
      } else {
        v2 = fmax_sel(v2, o1);
      }
    }

    int32_t prev = -1;
    if (lane == 0) {
      // No real slot (excluded by the contract): the TPU kernel's initial
      // j* = column 0 and a* = neg.
      const bool found = v1 > neg;
      const int32_t j = found ? cols[row + slot] : 0;
      const float astar = found ? vals[row + slot] + 0.0f : neg;
      if (!(v2 > half)) v2 = v1 - bigp;
      const float bid = (astar - v2) + eps;
      prev = owner[j];
      if (prev >= 0) queue[tail] = prev;
      prices[j] = bid;
      owner[j] = u;
    }
    prev = __shfl_sync(kFull, prev, 0);
    if (prev >= 0) tail = tail + 1 == cap ? 0 : tail + 1;
    ++bids;
    __syncwarp();
  }
  if (lane == 0) {
    stats[0] = bids;
    stats[1] = tail >= head ? tail - head : tail - head + cap;
  }
}

}  // namespace

extern "C" int sslap_gs_f32(const int32_t* cols, const float* vals,
                            int32_t K, int32_t* queue,
                            int64_t cap, int64_t qcount, float* prices,
                            int32_t* owner, float eps, float bigp, float neg,
                            float half, float real_min, int64_t max_bids,
                            int64_t* stats, void* stream) {
  gs_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      cols, vals, K, queue, cap, qcount, prices, owner, eps, bigp, neg, half,
      real_min, max_bids, stats);
  return static_cast<int>(cudaGetLastError());
}
