// Device code shared by K1 (decode_step.cu), K4 / K5 (decode_tp.cu,
// tp_gemv.cu) and K7 (decode_layer.cu):
// the f64 / f32 block reductions, the pair RoPE prologue of an attention
// block, the row kernel that norms, gates and int8-quantizes one
// activation row per block (row_quant) and its gate, scale and codes
// (quant_swiglu, quant_scale, quant_code), which K4 / K5's GEMVs share.
// Everything has internal linkage, so every translation unit may include
// it; see decode_step.cu for the rounding rules the kernels share with
// their plain versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "w8_common.cuh"

namespace vx {
namespace {

enum QuantMode { kQuantPlain = 0, kQuantNorm = 1, kQuantSwiglu = 2 };

constexpr int kQuantThreads = 512;  // row_quant: a block a row
constexpr int kQuantRegs = 18;      // values of the row a thread keeps
constexpr int kAttnThreads = 256;
constexpr int kMaxHeadDim = 256;  // P.V: up to 4 bf16 pairs per lane

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max / f64 sum; every thread gets the result.  ``red`` holds
// one value per warp.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();  // a previous reduction may still read red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < nw ? red[lane] : -INFINITY);
}

__device__ double block_sum_d(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum_d(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum_d(lane < nw ? red[lane] : 0.0);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The prologue of an attention block for row r, query head h (kv head
// jh): pair RoPE of q (scaled) and k with row r's vectors into shared
// memory (qf, kf; qb = bf16(q) when given), v into vf, and k_new / v_new
// as bf16 (one writer per kv head).  The caller synchronizes.
__device__ __forceinline__ void rope_row(
    const float* qkv, const float* __restrict__ cosv,
    const float* __restrict__ sinv, int rope_stride, int r, int h, int jh,
    int G, int n_heads, int n_kv, int hd, float scale, float* qf, float* qb,
    float* kf, float* vf, __nv_bfloat16* __restrict__ kn,
    __nv_bfloat16* __restrict__ vn) {
  const int nq = n_heads * hd, nkv = n_kv * hd, ld = nq + 2 * nkv;
  const float* row = qkv + static_cast<size_t>(r) * ld;
  const float* qh = row + static_cast<size_t>(h) * hd;
  const float* kh = row + nq + static_cast<size_t>(jh) * hd;
  const float* vh = row + nq + nkv + static_cast<size_t>(jh) * hd;
  const float* cr = cosv + static_cast<size_t>(r) * rope_stride;
  const float* sr = sinv + static_cast<size_t>(r) * rope_stride;
  const size_t kvo = (static_cast<size_t>(r) * n_kv + jh) * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    const float q = (qh[d] * cr[d] + qh[d ^ 1] * sr[d]) * scale;
    qf[d] = q;
    if (qb != nullptr) qb[d] = round_bf16(q);
    const float k = kh[d] * cr[d] + kh[d ^ 1] * sr[d];
    kf[d] = k;
    vf[d] = vh[d];
    if (h % G == 0) {  // one writer per kv head
      kn[kvo + d] = __float2bfloat16(k);
      vn[kvo + d] = __float2bfloat16(vh[d]);
    }
  }
}

// SwiGLU of one gate value g and up value u; the scale of a row from its
// absmax, and the code of one value: every kernel that gates or
// quantizes an activation row forms them here (row_quant_kernel, K5's w13
// GEMV and K4's wo GEMV in tp_gemv.cu), so they agree bit for bit
// wherever they are made.
__device__ __forceinline__ float quant_swiglu(float g, float u) {
  const float sig = 1.0f / (1.0f + expf(-g));
  return (g * sig) * u;
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(amax, 1e-8f) / 127.0f;
}

__device__ __forceinline__ int8_t quant_code(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.0f), 127.0f));
}

// One block per row b: h = f(x[b]) of width K, then xq[b] = int8 codes,
// sx[b] = max(absmax(h), 1e-8) / 127 with round-half-even of h / sx; or,
// with ``xb`` (mode (g)), xb[b] = bf16(h) and no quantization.
//   kQuantPlain:  h = x
//   kQuantNorm:   h = (x * (1 / sqrt(mean(x^2) + eps))) * w   (* ada),
//                 mean(x^2) summed in f64
//   kQuantSwiglu: h = (g * sigmoid(g)) * u, g = x[:K], u = x[K:2K]
// One pass over the row: thread t keeps h at k = t + j kQuantThreads,
// j < kQuantRegs, in registers (every decoder width: K <= 9216).  TAIL
// (wider rows only: the loops cost about 1 us a launch on the H100 even
// where they do not run) recomputes h at any k past them where a later
// step needs it, by the same operations.  The norm weights, which no
// predecessor writes, come in before pdl_wait.
template <bool TAIL>
__global__ void __launch_bounds__(kQuantThreads) row_quant_kernel(
    const float* x, int ldx, int K, const float* __restrict__ w,
    const float* __restrict__ ada, float eps, int mode,
    int8_t* __restrict__ xq, float* __restrict__ sx,
    __nv_bfloat16* __restrict__ xb) {
  __shared__ float red[32];
  __shared__ double red_d[32];
  const int b = blockIdx.x, t = threadIdx.x;
  const int kreg = kQuantRegs * kQuantThreads;  // the values in registers
  float wv[kQuantRegs], av[kQuantRegs];
  if (mode == kQuantNorm) {
#pragma unroll
    for (int j = 0; j < kQuantRegs; ++j) {
      const int k = t + j * kQuantThreads;
      wv[j] = k < K ? w[k] : 0.0f;
      av[j] = ada != nullptr && k < K ? ada[k] : 0.0f;
    }
  }
  pdl_trigger();
  pdl_wait();
  const float* xr = x + static_cast<size_t>(b) * ldx;
  float h[kQuantRegs], u[kQuantRegs];
#pragma unroll
  for (int j = 0; j < kQuantRegs; ++j) {
    const int k = t + j * kQuantThreads;
    h[j] = k < K ? xr[k] : 0.0f;
    u[j] = (mode == kQuantSwiglu && k < K) ? xr[K + k] : 0.0f;
  }
  float inv = 1.0f;
  if (mode == kQuantNorm) {
    double ss = 0.0;
#pragma unroll
    for (int j = 0; j < kQuantRegs; ++j) {
      const double v = h[j];
      ss += v * v;  // zero past K
    }
    if constexpr (TAIL) {
      for (int k = t + kreg; k < K; k += kQuantThreads) {
        const double v = xr[k];
        ss += v * v;
      }
    }
    ss = block_sum_d(ss, red_d);
    const float var = static_cast<float>(ss / static_cast<double>(K));
    inv = 1.0f / sqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < kQuantRegs; ++j) {
      float v = (h[j] * inv) * wv[j];
      if (ada != nullptr) v = v * av[j];
      h[j] = v;
    }
  } else if (mode == kQuantSwiglu) {
#pragma unroll
    for (int j = 0; j < kQuantRegs; ++j) h[j] = quant_swiglu(h[j], u[j]);
  }
  // h at a k past the registers.
  auto far = [&](int k) -> float {
    if (mode == kQuantNorm) {
      float v = (xr[k] * inv) * w[k];
      if (ada != nullptr) v = v * ada[k];
      return v;
    }
    if (mode == kQuantSwiglu) return quant_swiglu(xr[k], xr[K + k]);
    return xr[k];
  };
  if (xb != nullptr) {
    __nv_bfloat16* o = xb + static_cast<size_t>(b) * K;
#pragma unroll
    for (int j = 0; j < kQuantRegs; ++j) {
      const int k = t + j * kQuantThreads;
      if (k < K) o[k] = __float2bfloat16(h[j]);
    }
    if constexpr (TAIL) {
      for (int k = t + kreg; k < K; k += kQuantThreads)
        o[k] = __float2bfloat16(far(k));
    }
    return;
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kQuantRegs; ++j)
    if (t + j * kQuantThreads < K) amax = fmaxf(amax, fabsf(h[j]));
  if constexpr (TAIL) {
    for (int k = t + kreg; k < K; k += kQuantThreads)
      amax = fmaxf(amax, fabsf(far(k)));
  }
  amax = block_max(amax, red);
  const float s = quant_scale(amax);
  int8_t* q = xq + static_cast<size_t>(b) * K;
  auto code = [&](float v) { return quant_code(v, s); };
#pragma unroll
  for (int j = 0; j < kQuantRegs; ++j) {
    const int k = t + j * kQuantThreads;
    if (k < K) q[k] = code(h[j]);
  }
  if constexpr (TAIL) {
    for (int k = t + kreg; k < K; k += kQuantThreads) q[k] = code(far(k));
  }
  if (t == 0) sx[b] = s;
}

inline cudaError_t row_quant(const float* x, int ldx, int K, const float* w,
                             const float* ada, float eps, int mode, int B,
                             int8_t* xq, float* sx, __nv_bfloat16* xb,
                             cudaStream_t st, bool pdl = false) {
  if (K > kQuantRegs * kQuantThreads)
    return launch_pdl(row_quant_kernel<true>, dim3(B), dim3(kQuantThreads), 0,
                      st, pdl, x, ldx, K, w, ada, eps, mode, xq, sx, xb);
  return launch_pdl(row_quant_kernel<false>, dim3(B), dim3(kQuantThreads), 0,
                    st, pdl, x, ldx, K, w, ada, eps, mode, xq, sx, xb);
}

}  // namespace
}  // namespace vx
