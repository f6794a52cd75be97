// K1 mode (g): the GEMV of the dense-weight (bf16) decode step
// (decode_stack_step_pallas.py's wq8=False stream, :742-752, and its lm
// fold, :1274-1281):
//
//   out[m, n] = float(sum_k x[m, k] * w[n, k])  (+ resid[m, n])
//
// x [M, K] bf16 (the step's norm / ADA / SwiGLU row rounded to bf16, as
// JAX's prep casts it), w [N, K] bf16 (row n = output n: the {"nt": w}
// layout of fuse_decode_weights_bf16), out / resid [M, N] f32 row-major
// (resid may alias out).  A bf16 x bf16 product is exact in f32 (8 + 8
// significant bits); the products are summed in f64 and the sum rounds
// once to f32, as the plain version (decode_stack_step_plain) computes
// it, so kernel and plain version agree bit for bit in any order.
//
// The N output rows may lie in up to three segments (wq / wk / wv of the
// qkv phase, w1 / w3 of the FFN's): rows [0, n0) in seg[0], [n0, n0 + n1)
// in seg[1], the rest in seg[2].  The kernel streams the dense leaves
// themselves, so the fused stacks of the dense model share the prefill's
// buffers and nothing is concatenated (memory-neutral, as JAX's fuse).
//
// One warp per output row n, 16-byte loads of the weight row (8 bf16 per
// lane and step, neighbouring lanes on neighbouring addresses), R <= 8
// rows of x per pass over the K axis.  More rows (speculative decode: up
// to 64) take further passes inside the same warp: the first pass brings
// the weight row from HBM and the later ones find it in L1 / L2, so each
// weight byte leaves HBM once.  What bounds it on the H100: the weight
// bytes at one row (2 per weight, twice w8's); the f32 -> f64
// conversion of every product (FP64 pipe) as the rows grow.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w8_common.cuh"

namespace vx {
namespace {

struct BfSegs {
  const __nv_bfloat16* w[3];
  int n0, n1;  // rows of w[0] and w[1]; w[2] holds the rest
};

__device__ __forceinline__ const __nv_bfloat16* seg_row(const BfSegs& s,
                                                        int n, int K) {
  if (n < s.n0) return s.w[0] + static_cast<size_t>(n) * K;
  n -= s.n0;
  if (n < s.n1) return s.w[1] + static_cast<size_t>(n) * K;
  return s.w[2] + static_cast<size_t>(n - s.n1) * K;
}

// Eight bf16 values (one 16-byte load) widened to f32 (exact).
__device__ __forceinline__ void bf16x8(const int4 v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The dots of one warp's weight row w [K] bf16 with the activation rows
// x [mr, K] bf16 (row stride K, mr <= R): lane-strided 16-byte loads (vec:
// K % 8 == 0, 16-byte aligned rows) or single elements, each bf16 x bf16
// product exact in f32, summed in f64 per lane, then across the warp
// (warp_sum_f64): every lane holds acc[m] for m < mr.  Shared by the GEMV
// below and by K1 mode (i)'s fold over a bf16 table (lm_argmax.cuh), so
// the fold's logits are mode (g)'s bit for bit.  x is read with __ldg: a
// caller after pdl_wait passes it through after_wait (w8_common.cuh).
template <int R>
__device__ __forceinline__ void bf16_row_dots(
    const __nv_bfloat16* x, const __nv_bfloat16* __restrict__ w,
    int mr, int K, bool vec, int lane, double (&acc)[R]) {
#pragma unroll
  for (int m = 0; m < R; ++m) acc[m] = 0.0;
  if (vec) {
    const int4* w4 = reinterpret_cast<const int4*>(w);
    const int nv = K >> 3;
    for (int i = lane; i < nv; i += 32) {
      float wf[8];
      bf16x8(__ldg(w4 + i), wf);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m < mr) {
          float xf[8];
          bf16x8(__ldg(reinterpret_cast<const int4*>(
                           x + static_cast<size_t>(m) * K) + i),
                 xf);
          double a = acc[m];
#pragma unroll
          for (int e = 0; e < 8; ++e) a += static_cast<double>(wf[e] * xf[e]);
          acc[m] = a;
        }
      }
    }
  } else {
    for (int k = lane; k < K; k += 32) {
      const float wv = __bfloat162float(w[k]);
#pragma unroll
      for (int m = 0; m < R; ++m)
        if (m < mr)
          acc[m] += static_cast<double>(
              wv * __bfloat162float(x[static_cast<size_t>(m) * K + k]));
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m) acc[m] = warp_sum_f64(acc[m]);
}

template <int R>
__global__ void __launch_bounds__(256) bf16_gemv_kernel(
    const __nv_bfloat16* x, BfSegs segs, const float* resid,
    float* out, int M, int N, int K, bool vec) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  pdl_trigger();  // K1's one-row path launches it ahead of its predecessor
  pdl_wait();
  x = after_wait(x);  // bf16_row_dots reads it with __ldg
  if (n >= N) return;  // whole warps leave together
  const __nv_bfloat16* w = seg_row(segs, n, K);
  for (int m0 = 0; m0 < M; m0 += R) {
    const int mr = min(R, M - m0);
    double acc[R];
    bf16_row_dots<R>(x + static_cast<size_t>(m0) * K, w, mr, K, vec, lane,
                     acc);
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m >= mr) continue;
        float y = static_cast<float>(acc[m]);
        const size_t o = static_cast<size_t>(m0 + m) * N + n;
        if (resid != nullptr) y = resid[o] + y;
        out[o] = y;
      }
    }
  }
}

// The bf16 GEMV over M rows (any M: passes of up to 8 rows each).
inline void launch_bf16_gemv(const __nv_bfloat16* x, const BfSegs& segs,
                             const float* resid, float* out, int M, int N,
                             int K, cudaStream_t st) {
  bool vec = K % 8 == 0 && aligned16(x);
  for (int s = 0; s < 3; ++s)
    if (segs.w[s] != nullptr) vec = vec && aligned16(segs.w[s]);
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const dim3 block(32 * kGemvWarps);
  switch (M < kDp4aMaxM ? M : kDp4aMaxM) {
#define VX_BF16_CASE(RR)                                                   \
  case RR:                                                                 \
    bf16_gemv_kernel<RR><<<grid, block, 0, st>>>(x, segs, resid, out, M, N, \
                                                 K, vec);                  \
    break;
    VX_BF16_CASE(1)
    VX_BF16_CASE(2)
    VX_BF16_CASE(3)
    VX_BF16_CASE(4)
    VX_BF16_CASE(5)
    VX_BF16_CASE(6)
    VX_BF16_CASE(7)
    VX_BF16_CASE(8)
#undef VX_BF16_CASE
    default:
      break;
  }
}

}  // namespace
}  // namespace vx
