// Error text for the codes the C entry points return (cudaGetLastError()).
#include "common.cuh"

LEDNET_API const char* lednet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
