// Shared C entry point of the kernel library: the text of a CUDA error
// code, so the Python wrappers can raise with a readable message.
#include <cuda_runtime.h>

extern "C" const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
