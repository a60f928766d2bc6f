// Error text for the codes the kernel entry points return, and the device
// limit the wrappers check before a launch that asks for shared memory.
#include "common.cuh"

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
