// Hopper's bulk-copy primitives for the GS probe kernels (sm_90a): the
// counterparts of the TPU's pltpu.make_async_copy and DMA semaphores.
//
//   TPU (Pallas)                         Hopper (this header)
//   copy.start() HBM -> VMEM             bulk_g2s: cp.async.bulk (the TMA's
//                                        1-D copy) completing on an mbarrier
//   copy.wait() on sem.at[...]           mbar_wait on that mbarrier's phase
//   copy.start()/wait() VMEM -> HBM      bulk_s2g + bulk_wait_read (a bulk
//                                        group)
//
// A bulk copy moves a multiple of 16 bytes between 16-byte-aligned
// addresses; one thread issues it, arrive.expect_tx tells the barrier how
// many bytes complete its phase.  Every barrier here counts one arrival.
#pragma once

#include <cstdint>

namespace sslap {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread, before any use of the barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A plain arrival (a consumer's release of a ring slot).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Global -> shared, `bytes` a multiple of 16, both addresses 16-aligned.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Spin until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Every thread that wrote shared memory a bulk copy will read runs this
// before the barrier that precedes the copy (generic -> async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared -> global as one bulk group (after fence_async_smem and a barrier).
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until every bulk group of this thread has read its shared source (which
// may then be overwritten, or freed at the block's exit); the global writes
// complete before the kernel does.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace sslap
