// Shared C entry for the lc3jax_torch kernel library: error text for the
// cudaError_t codes the launch entries return.
#include <cuda_runtime.h>

extern "C" const char* lc3t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
