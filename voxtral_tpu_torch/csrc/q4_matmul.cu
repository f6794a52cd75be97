// K3: fused Q4_0 dequant + matmul on nibble-packed weights.
//
// Port of voxtral_tpu/ops/q4_pallas.py::q4_matmul_pallas (kernel body
// _q4_matmul_kernel).  Layouts (the JAX package's packed q4 format):
//   x        [M, K] f32 (M <= 8: decode rows)
//   packed   [K/8, N] int32: word (i, n) holds the unsigned nibble
//            code[n, 8i + j] + 8 in bits 4j .. 4j + 3
//   scales_t [K/32, N] bf16: the group scales, transposed
//   out      [M, N] f32
//
//   out[m, n] = sum_k bf16(x[m, k]) * bf16(nib[k, n] * s[k / 32, n])
//               - sum_b xb8[m, b] * s[b, n],
//   xb8[m, b] = 8 * sum of the f32 x[m, 32 b .. 32 b + 31]
//
// These are the TPU kernel's rounding points: x rounded to bf16 (its
// plane-permuted xp), each weight the bf16 product of the nibble and the
// bf16 scale (its w * s_cat), and the exact -8 offset correction through
// per-32-block sums of the f32 x.  The TPU kernel's plane permutation is
// a Mosaic layout trick; here k runs in natural order.
//
// What bounds it on the H100: the packed weights streamed from HBM
// (0.5 byte per weight + 2 bytes of scale per 32).  Design: one block of
// kWarps warps per 32 output columns; lane = column, so each warp reads
// 128 contiguous bytes of a packed row; the warps split K by groups of 32
// (4 packed rows + 1 scale row each).  x is staged in shared memory in
// chunks of kChunk elements, rounded to bf16 there, with its per-group
// sums xb8.  Every float sum accumulates in f64 (the products are exact)
// and rounds once to f32, so the kernel and its plain version
// (ops/q4_kernel.py::q4_matmul_plain) agree bit for bit whatever order
// each sums in.  Wider loads, more columns per warp and an f32 main sum
// with exact regrouping are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vx {
namespace {

constexpr int kWarps = 8;      // warps per block, splitting K
constexpr int kCols = 32;      // output columns per block (one per lane)
constexpr int kChunk = 1024;   // elements of each x row staged per pass
constexpr int kMaxRows = 8;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int M>
__global__ void __launch_bounds__(32 * kWarps) q4_matmul_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ packed,
    const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, int N,
    int K) {
  extern __shared__ double smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [M][kChunk] bf16(x)
  float* xb8 = xs + M * kChunk;                // [M][kChunk / 32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x * kCols + lane;
  double acc[M], cor[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = cor[m] = 0.0;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    const int gc = kc / 32;
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < M * kc; i += blockDim.x) {
      const int m = i / kc, kk = i - m * kc;
      xs[m * kChunk + kk] = round_bf16(x[static_cast<size_t>(m) * K + k0 + kk]);
    }
    for (int i = tid; i < M * gc; i += blockDim.x) {
      const int m = i / gc, g = i - m * gc;
      const float* xr = x + static_cast<size_t>(m) * K + k0 + 32 * g;
      double s = 0.0;
      for (int j = 0; j < 32; ++j) s += xr[j];
      xb8[m * (kChunk / 32) + g] = static_cast<float>(s) * 8.0f;
    }
    __syncthreads();
    for (int g = warp; g < gc; g += kWarps) {
      const int gg = k0 / 32 + g;  // group index along K
      const float s = __bfloat162float(scales[static_cast<size_t>(gg) * N + n]);
      int32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = __ldg(packed + static_cast<size_t>(4 * gg + r) * N + n);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float nib = static_cast<float>((w[r] >> (4 * j)) & 0xF);
          const double wv = round_bf16(nib * s);
          const int kk = 32 * g + 8 * r + j;
#pragma unroll
          for (int m = 0; m < M; ++m)
            acc[m] += static_cast<double>(xs[m * kChunk + kk]) * wv;
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m)
        cor[m] += static_cast<double>(xb8[m * (kChunk / 32) + g]) *
                  static_cast<double>(s);
    }
  }
  // Cross-warp sums in a fixed order; red reuses the x staging buffer.
  __syncthreads();
  double* red = smem;  // [kWarps][2][M][32]
#pragma unroll
  for (int m = 0; m < M; ++m) {
    red[((warp * 2 + 0) * M + m) * 32 + lane] = acc[m];
    red[((warp * 2 + 1) * M + m) * 32 + lane] = cor[m];
  }
  __syncthreads();
  for (int i = tid; i < M * 32; i += blockDim.x) {
    const int m = i >> 5, l = i & 31;
    double a = 0.0, c = 0.0;
    for (int wi = 0; wi < kWarps; ++wi) {
      a += red[((wi * 2 + 0) * M + m) * 32 + l];
      c += red[((wi * 2 + 1) * M + m) * 32 + l];
    }
    out[static_cast<size_t>(m) * N + blockIdx.x * kCols + l] =
        static_cast<float>(a) - static_cast<float>(c);
  }
}

constexpr size_t smem_bytes(int M) {
  // max(x staging, cross-warp partials)
  return M * (kChunk + kChunk / 32) * sizeof(float) >
                 static_cast<size_t>(kWarps) * 2 * M * 32 * sizeof(double)
             ? M * (kChunk + kChunk / 32) * sizeof(float)
             : static_cast<size_t>(kWarps) * 2 * M * 32 * sizeof(double);
}

}  // namespace
}  // namespace vx

// All pointers are device pointers (layouts above).  Needs 1 <= M <= 8,
// N % 32 == 0 and K % 32 == 0 (the wrapper holds the JAX shape gate,
// K % 256 == 0 and N % 128 == 0).
extern "C" int vx_q4_matmul(const void* x, const void* packed,
                            const void* scales, void* out, int M, int N,
                            int K, void* stream) {
  using namespace vx;
  if (M < 1 || M > kMaxRows || N <= 0 || K <= 0 || N % kCols || K % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / kCols), block(32 * kWarps);
  const float* xp = static_cast<const float*>(x);
  const int32_t* pp = static_cast<const int32_t*>(packed);
  const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(scales);
  float* op = static_cast<float*>(out);
  switch (M) {
#define VX_Q4_CASE(MM)                                                  \
  case MM:                                                              \
    q4_matmul_kernel<MM><<<grid, block, smem_bytes(MM), st>>>(xp, pp, sp, \
                                                              op, N, K); \
    break;
    VX_Q4_CASE(1)
    VX_Q4_CASE(2)
    VX_Q4_CASE(3)
    VX_Q4_CASE(4)
    VX_Q4_CASE(5)
    VX_Q4_CASE(6)
    VX_Q4_CASE(7)
    VX_Q4_CASE(8)
#undef VX_Q4_CASE
    default:
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
