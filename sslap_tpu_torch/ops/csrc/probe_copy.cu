// P1-P3: a 2-row async copy at a dynamic row into shared scratch at a
// runtime offset (sm_90a).
//
// Replaces benchmarks/probe_mosaic_gs.py::dma_hbm_dynrows (:38, static
// scratch offset 0), ::dma_vmem_dynoff2 (:65, offset slot * 2) and
// ::dma_vmem_dynoff8 (:94, offset slot * 8): rows [row, row + 2) of a
// [rows, 128] int32 table are copied into scratch rows [off, off + 2) and
// written out as [2, 128].  The TPU's make_async_copy + DMA semaphore
// becomes one 1 KB cp.async.bulk completing on an mbarrier (tma.cuh); a
// 512-byte row keeps every source and target 16-byte aligned at any row and
// offset, which the bulk copy requires.  The three probes differ only in
// how the offset is formed, which the wrapper does.
//
// Bound: latency of one copy (an L2/HBM round trip) plus the barrier wait;
// nothing to overlap.  The design issues the copy as early as the block
// starts and reads the scratch with all 32 lanes.
#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int kLine = 128;

__global__ void probe_copy_kernel(const int32_t* __restrict__ src,
                                  int64_t row, int32_t off, int32_t* out) {
  extern __shared__ __align__(16) int32_t scratch[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    sslap::mbar_init(&bar);
    sslap::mbar_expect_tx(&bar, 2 * kLine * 4);
    sslap::bulk_g2s(scratch + off * kLine, src + row * kLine, 2 * kLine * 4,
                    &bar);
  }
  __syncwarp();
  sslap::mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < 2 * kLine; i += 32)
    out[i] = scratch[off * kLine + i];
}

}  // namespace

extern "C" int sslap_probe_copy(const int32_t* src, int64_t row, int32_t off,
                                int32_t scratch_rows, int32_t* out,
                                void* stream) {
  probe_copy_kernel<<<1, 32, scratch_rows * kLine * 4,
                      static_cast<cudaStream_t>(stream)>>>(src, row, off,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}
