// Block-scope synchronisation shared by the kernels whose warps take roles
// (a commit warp or thread beside look-ahead warps: gs.cu, probe_ladder.cu)
// (sm_90a).  Loads and stores of a table that one thread writes while
// others read it are relaxed .cta atomics; a count or tag that publishes
// those stores is written behind a release and read behind an acquire.
// All warps of a block share the SM's L1, so the block scope suffices.
#pragma once

#include <cuda/atomic>

#include <cstdint>

namespace sslap {

template <class T>
__device__ __forceinline__ T ld_rlx(T* p) {
  return cuda::atomic_ref<T, cuda::thread_scope_block>(*p).load(
      cuda::memory_order_relaxed);
}
template <class T>
__device__ __forceinline__ T ld_acq(T* p) {
  return cuda::atomic_ref<T, cuda::thread_scope_block>(*p).load(
      cuda::memory_order_acquire);
}
template <class T>
__device__ __forceinline__ void st_rlx(T* p, T v) {
  cuda::atomic_ref<T, cuda::thread_scope_block>(*p).store(
      v, cuda::memory_order_relaxed);
}
template <class T>
__device__ __forceinline__ void st_rel(T* p, T v) {
  cuda::atomic_ref<T, cuda::thread_scope_block>(*p).store(
      v, cuda::memory_order_release);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait loop that sees no progress for this long traps (the launch then
// fails) instead of hanging the card.
constexpr unsigned long long kStallNs = 10'000'000'000ull;

// Counts a wait loop's turns; every 1024th reads the clock, and traps once
// kStallNs have passed since the first reading.
struct Watchdog {
  unsigned spins = 0;
  unsigned long long since = 0;
  __device__ __forceinline__ void tick() {
    if ((++spins & 1023u) != 0) return;
    const unsigned long long now = globaltimer();
    if (since == 0) since = now;
    else if (now - since > kStallNs) __trap();
  }
};

}  // namespace sslap
