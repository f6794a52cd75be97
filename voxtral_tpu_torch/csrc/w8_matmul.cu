// K2: the W8A8 GEMM (port of voxtral_tpu/ops/w8_pallas.py::w8_matmul_pallas).
// Device code in w8_common.cuh; this file holds the C entry point that
// voxtral_tpu_torch/ops/w8_kernel.py loads with ctypes.
#include "w8_common.cuh"

extern "C" int vx_w8_matmul(const void* xq, const void* sx, const void* codes,
                            const void* scale, void* out, int M, int N, int K,
                            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  vx::launch_w8_matmul(static_cast<const int8_t*>(xq),
                       static_cast<const float*>(sx),
                       static_cast<const int8_t*>(codes),
                       static_cast<const float*>(scale), nullptr,
                       static_cast<float*>(out), M, N, K,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
