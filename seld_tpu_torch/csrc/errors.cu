// Error text for the codes the other entry points return.
#include "common.cuh"

extern "C" const char* seld_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
