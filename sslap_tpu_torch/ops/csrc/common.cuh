// Shared pieces of the port's hand-written kernels (sm_90a).
//
// Every C entry point launches on the caller's stream (PyTorch's current
// stream, passed as a void*), allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sslap {

constexpr int kBlock = 256;

inline unsigned grid_for(int64_t count) {
  return static_cast<unsigned>((count + kBlock - 1) / kBlock);
}

}  // namespace sslap
