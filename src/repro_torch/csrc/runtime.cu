// Error text for the codes the kernel entry points return
// (repro_torch/kernels/_build.py:check).
#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
