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
// misreads real entries of min problems whose costs are all >= 1.  The
// reference's bisect stubs are kept as SCAN: kConst bids (prices[cols[u,0]]
// + 0) + eps on the row's first slot, kNoPrices reads every price as 0.
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
// round trip, with nothing else on the card to hide it.  PREFETCH takes the
// first two links off the chain, as the TPU kernel's double-buffered DMA
// did: while a row bids, the next queued row's cols/vals are already on
// their way into the other slot of a two-slot shared-memory buffer
// (cp.async, 4 bytes a lane, one commit group per row; 16 * K bytes of
// dynamic shared memory).  Row data is immutable and ring entries before
// the tail are final, so reading them ahead is safe; prices and owner are
// not, and are still read in the bid's own step.  When the pop empties the
// ring and the bid pushes the evicted owner, that row is the one fetched
// (gs_kernel.py:204-209).  Measured on an H100 (700 W) over the 1M
// headline's 5.1M-bid tail, prefetch does not pay: the row loads are not
// the chain's long link (the lane merge and the price gathers are), and the
// cp.async path costs more than the loads it replaces (0.88 against 0.82
// us/bid, PERF.md).  It stays on by default, as in the reference.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNone = 0x7FFFFFFF;   // no slot seen yet (sorts after all)
enum Scan { kFullScan = 0, kConst = 1, kNoPrices = 2 };

__device__ __forceinline__ float fmax_sel(float a, float b) {
  return b > a ? b : a;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// This lane's slots of row u into buffer slot s, as one commit group.
__device__ __forceinline__ void fetch_row(int32_t* cbuf, float* vbuf, int s,
                                          int32_t K, const int32_t* cols,
                                          const float* vals, int32_t u,
                                          int lane) {
  const int64_t row = static_cast<int64_t>(u) * K;
  for (int k = lane; k < K; k += 32) {
    cp_async4(cbuf + s * K + k, cols + row + k);
    cp_async4(vbuf + s * K + k, vals + row + k);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int SCAN, bool PREFETCH>
__global__ void gs_kernel(const int32_t* __restrict__ cols,
                          const float* __restrict__ vals, int32_t K,
                          int32_t* queue, int64_t cap, int64_t qcount,
                          float* prices, int32_t* owner, float eps,
                          float bigp, float neg, float half, float real_min,
                          int64_t max_bids, int64_t* stats) {
  extern __shared__ int32_t sbuf[];     // PREFETCH: [2][K] cols, [2][K] vals
  int32_t* cbuf = sbuf;
  float* vbuf = reinterpret_cast<float*>(sbuf + 2 * K);
  const int lane = threadIdx.x;
  int64_t head = 0, tail = qcount, bids = 0;
  int s = 0;                             // buffer slot of the current row
  int32_t u = 0;                         // PREFETCH: the row in slot s
  if (PREFETCH && qcount > 0 && max_bids > 0) {
    if (lane == 0) u = queue[0];
    u = __shfl_sync(kFull, u, 0);
    fetch_row(cbuf, vbuf, 0, K, cols, vals, u, lane);
  }
  while (head != tail && bids < max_bids) {
    if (!PREFETCH) {
      if (lane == 0) u = queue[head];
      u = __shfl_sync(kFull, u, 0);
    }
    head = head + 1 == cap ? 0 : head + 1;
    int32_t next = 0;
    if (PREFETCH) {
      // The next row, if the ring still holds one, streams in behind this
      // row's bid; then wait for this row's group only.
      const bool ahead = head != tail && bids + 1 < max_bids;
      if (ahead) {
        if (lane == 0) next = queue[head];
        next = __shfl_sync(kFull, next, 0);
        fetch_row(cbuf, vbuf, 1 - s, K, cols, vals, next, lane);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();                      // lane 0 reads the winner's slot
    }
    const int64_t row = static_cast<int64_t>(u) * K;
    const int32_t* crow = PREFETCH ? cbuf + s * K : cols + row;
    const float* vrow = PREFETCH ? vbuf + s * K : vals + row;

    float v1 = neg, v2 = neg;
    int slot = kNone;
    if (SCAN != kConst) {
      // This lane's slots: a sequential top-2 with strict '>', so the
      // lowest slot keeps a tie.
      for (int k = lane; k < K; k += 32) {
        const float vk = vrow[k] + 0.0f;
        const float pk = SCAN == kNoPrices ? 0.0f : prices[crow[k]] + 0.0f;
        const float w = vk > real_min ? vk - pk : neg;
        if (w > v1) {
          v2 = v1;
          v1 = w;
          slot = k;
        } else {
          v2 = fmax_sel(v2, w);
        }
      }
      // Merge the lanes: the higher v1 wins, then the lower slot; the
      // loser's v1 competes for the second place.
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
    }

    int32_t prev = -1;
    if (lane == 0) {
      int32_t j;
      float bid;
      if (SCAN == kConst) {
        j = crow[0];
        bid = (prices[j] + 0.0f) + eps;
      } else {
        // No real slot (excluded by the contract): the TPU kernel's
        // initial j* = column 0 and a* = neg.
        const bool found = v1 > neg;
        j = found ? crow[slot] : 0;
        const float astar = found ? vrow[slot] + 0.0f : neg;
        if (!(v2 > half)) v2 = v1 - bigp;
        bid = (astar - v2) + eps;
      }
      prev = owner[j];
      if (prev >= 0) queue[tail] = prev;
      prices[j] = bid;
      owner[j] = u;
    }
    prev = __shfl_sync(kFull, prev, 0);
    if (prev >= 0) {
      // The pop emptied the ring: the evicted row just pushed is next.
      if (PREFETCH && head == tail && bids + 1 < max_bids) {
        next = prev;
        fetch_row(cbuf, vbuf, 1 - s, K, cols, vals, next, lane);
      }
      tail = tail + 1 == cap ? 0 : tail + 1;
    }
    ++bids;
    if (PREFETCH) {
      u = next;
      s ^= 1;
    }
    __syncwarp();
  }
  if (PREFETCH) asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (lane == 0) {
    stats[0] = bids;
    stats[1] = tail >= head ? tail - head : tail - head + cap;
  }
}

template <int SCAN, bool PREFETCH>
cudaError_t launch(const int32_t* cols, const float* vals, int32_t K,
                   int32_t* queue, int64_t cap, int64_t qcount, float* prices,
                   int32_t* owner, float eps, float bigp, float neg,
                   float half, float real_min, int64_t max_bids,
                   int64_t* stats, cudaStream_t stream) {
  const size_t smem = PREFETCH ? 16 * static_cast<size_t>(K) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gs_kernel<SCAN, PREFETCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gs_kernel<SCAN, PREFETCH><<<1, 32, smem, stream>>>(
      cols, vals, K, queue, cap, qcount, prices, owner, eps, bigp, neg, half,
      real_min, max_bids, stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sslap_gs_f32(const int32_t* cols, const float* vals,
                            int32_t K, int32_t* queue,
                            int64_t cap, int64_t qcount, float* prices,
                            int32_t* owner, float eps, float bigp, float neg,
                            float half, float real_min, int64_t max_bids,
                            int prefetch, int scan, int64_t* stats,
                            void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define SSLAP_GS(SCAN, PF)                                                  \
  launch<SCAN, PF>(cols, vals, K, queue, cap, qcount, prices, owner, eps,  \
                   bigp, neg, half, real_min, max_bids, stats, st)
  cudaError_t err = cudaErrorInvalidValue;
  if (prefetch) {
    if (scan == kFullScan) err = SSLAP_GS(kFullScan, true);
    if (scan == kConst) err = SSLAP_GS(kConst, true);
    if (scan == kNoPrices) err = SSLAP_GS(kNoPrices, true);
  } else {
    if (scan == kFullScan) err = SSLAP_GS(kFullScan, false);
    if (scan == kConst) err = SSLAP_GS(kConst, false);
    if (scan == kNoPrices) err = SSLAP_GS(kNoPrices, false);
  }
#undef SSLAP_GS
  return static_cast<int>(err);
}
