// Error text for the cudaError_t values the other entry points return.

#include <cuda_runtime.h>

extern "C" const char* vd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
