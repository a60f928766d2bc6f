// Error text for the codes the kernel entry points return, the device
// limit the wrappers check before a launch that asks for shared memory, and
// an empty kernel (a launch's floor, which chip_smoke.py measures).
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch of a kernel that does nothing, on `stream`.
extern "C" int sslap_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sslap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a block may opt in to on `device`, in bytes, or
// minus the CUDA error code.
extern "C" int sslap_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}
