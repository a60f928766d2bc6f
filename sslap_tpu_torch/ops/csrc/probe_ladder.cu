// P16-P17: K3 rebuilt in stages, on one unified int32 state table or on
// three tables (sm_90a).
//
// Replaces benchmarks/probe_mosaic_gs.py::_gs_ladder_uni (:838) and
// ::_gs_ladder (:997).  Per bid, until the ring is empty or max_bids:
//   stage 1: u = queue[head]; fetch row u's window of cols/vals; j =
//            cols[u, 0], v0 = vals[u, 0] + 0, pk = prices[j] + 0;
//            acc = (acc + pk) + v0
//   stage 2: + prices[j] = pk + 0.5, owner[j] = u
//   stage 3: + prev = owner[j] read first, pushed at the tail if >= 0
// and it writes (bids, rows left) and acc.  acc is the stage's only use of
// the loads in stage 1; without it as an output the compiler could delete
// them and the stage's time would mean nothing.  The +0 on price and value
// reads give the TPU kernel's one-hot read bits (-0.0 -> +0.0).
//
// UNIFIED keeps the price column as int32 bits in one state table (rows
// queue | price bits | owner, each `width` wide), read and written through
// __int_as_float / __float_as_int; otherwise prices is its own f32 table.
// The TPU needed the unified table because its second and third aliased
// VMEM tables read zeros; on the GPU both layouts are flat global arrays.
//
// The row fetch is the TPU's NL-line DMA window (gs_kernel.py:232-241): a
// cp.async.bulk of the 16-byte-aligned window [4 floor(uK / 4), + WIN)
// with WIN = roundup4(K + 3) entries, which covers the row's K entries at
// any offset, per operand, both completing on one mbarrier.  The arrays
// are padded so the last row's window stays in bounds (the reference's
// line packing pads NL lines; the wrapper checks).
//
// Bound: latency; the chain per bid is queue slot -> window copy -> price
// (-> owner -> stores).  One thread runs it: the chain is scalar, and the
// TPU's 128-lane one-hot reads have no counterpart to spread over lanes.
#include "common.cuh"
#include "tma.cuh"

namespace {

__host__ __device__ constexpr int32_t window(int32_t K) {
  return (K + 3 + 3) / 4 * 4;
}

template <bool UNIFIED>
__device__ __forceinline__ float load_price(void* p, int32_t j) {
  return UNIFIED ? __int_as_float(static_cast<int32_t*>(p)[j])
                 : static_cast<float*>(p)[j];
}

template <bool UNIFIED>
__device__ __forceinline__ void store_price(void* p, int32_t j, float v) {
  if (UNIFIED)
    static_cast<int32_t*>(p)[j] = __float_as_int(v);
  else
    static_cast<float*>(p)[j] = v;
}

template <int STAGE, bool UNIFIED>
__global__ void probe_ladder_kernel(const int32_t* __restrict__ clines,
                                    const float* __restrict__ vlines,
                                    int32_t K, int32_t* q, void* prices,
                                    int32_t* owner, int64_t qcount,
                                    int64_t max_bids, int64_t cap,
                                    int32_t* stats, float* acc_out) {
  extern __shared__ __align__(16) int32_t cwin[];   // [WIN] cols, [WIN] vals
  __shared__ __align__(8) uint64_t bar;
  const int32_t win = window(K);
  float* vwin = reinterpret_cast<float*>(cwin + win);
  const uint32_t bytes = static_cast<uint32_t>(win) * 4;
  sslap::mbar_init(&bar);
  uint32_t parity = 0;
  int64_t head = 0, tail = qcount, bids = 0;
  float acc = 0.0f;
  while (head != tail && bids < max_bids) {
    const int32_t u = q[head];
    head = head + 1 == cap ? 0 : head + 1;
    const int64_t at = static_cast<int64_t>(u) * K;
    const int64_t start = at & ~static_cast<int64_t>(3);
    sslap::mbar_expect_tx(&bar, 2 * bytes);
    sslap::bulk_g2s(cwin, clines + start, bytes, &bar);
    sslap::bulk_g2s(vwin, vlines + start, bytes, &bar);
    sslap::mbar_wait(&bar, parity);
    parity ^= 1;
    const int off = static_cast<int>(at - start);
    const int32_t j = cwin[off];
    const float v0 = vwin[off] + 0.0f;
    const float pk = load_price<UNIFIED>(prices, j) + 0.0f;
    acc = (acc + pk) + v0;
    if (STAGE >= 3) {
      const int32_t prev = owner[j];
      if (prev >= 0) {
        q[tail] = prev;
        tail = tail + 1 == cap ? 0 : tail + 1;
      }
    }
    if (STAGE >= 2) {
      store_price<UNIFIED>(prices, j, pk + 0.5f);
      owner[j] = u;
    }
    ++bids;
  }
  stats[0] = static_cast<int32_t>(bids);
  stats[1] = static_cast<int32_t>(tail >= head ? tail - head
                                               : tail - head + cap);
  acc_out[0] = acc;
}

template <int STAGE, bool UNIFIED>
cudaError_t launch(const int32_t* clines, const float* vlines, int32_t K,
                   int32_t* q, void* prices, int32_t* owner, int64_t qcount,
                   int64_t max_bids, int64_t cap, int32_t* stats,
                   float* acc, cudaStream_t stream) {
  const size_t smem = 8 * static_cast<size_t>(window(K));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_ladder_kernel<STAGE, UNIFIED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  probe_ladder_kernel<STAGE, UNIFIED><<<1, 1, smem, stream>>>(
      clines, vlines, K, q, prices, owner, qcount, max_bids, cap, stats, acc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sslap_probe_ladder(int stage, int unified,
                                  const int32_t* clines, const float* vlines,
                                  int32_t K, int32_t* q, void* prices,
                                  int32_t* owner, int64_t qcount,
                                  int64_t max_bids, int64_t cap,
                                  int32_t* stats, float* acc, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define SSLAP_LADDER(S, U)                                                  \
  launch<S, U>(clines, vlines, K, q, prices, owner, qcount, max_bids, cap, \
               stats, acc, st)
  cudaError_t err = cudaErrorInvalidValue;
  if (unified) {
    if (stage == 1) err = SSLAP_LADDER(1, true);
    if (stage == 2) err = SSLAP_LADDER(2, true);
    if (stage == 3) err = SSLAP_LADDER(3, true);
  } else {
    if (stage == 1) err = SSLAP_LADDER(1, false);
    if (stage == 2) err = SSLAP_LADDER(2, false);
    if (stage == 3) err = SSLAP_LADDER(3, false);
  }
#undef SSLAP_LADDER
  return static_cast<int>(err);
}
