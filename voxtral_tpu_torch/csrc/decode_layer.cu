// K7: one decoder layer of a single-token w8 decode step over the
// position-major prefill cache.
//
// Port of voxtral_tpu/ops/decode_step_pallas.py::decode_layer_step
// (kernel body _make_kernel).  Its only caller is the one-shot path's
// per-layer route (models/voxtral.py, route "layer"), which decodes in
// the prefill cache [L, B, S, n_kv, hd] itself, so no head-major copy of
// the cache exists beside it.  Per call:
//
//   row_quant(norm)      rmsnorm x attn_norm, per-row int8 quant
//   gemv qkv             W8A8 GEMV on layer ``layer`` of the wqkv stack
//   attn_layer           pair RoPE, GQA attention over the cache slots
//                        [max(0, off - window), off) and the row itself,
//                        one block per (row, query head); k_new / v_new
//   row_quant(plain)     int8 quant of the attention output
//   gemv wo (+ x)        residual fused into the epilogue
//   row_quant(norm, ada) rmsnorm x ffn_norm x ADA vector, int8 quant
//   gemv w13
//   row_quant(swiglu)    silu(gate) * up, int8 quant
//   gemv w2 (+ x)
//
// The row kernel and the GEMVs are K1's (decode_common.cuh,
// w8_common.cuh), indexed by ``layer`` into the stacks.  What differs
// from K1's attention is the rounding of the JAX kernel: the scaled q
// stays f32 against the bf16 cache (K1 rounds it to bf16), and the
// softmax weights stay f32 for P.V (K1 rounds them to bf16).  The cache
// is walked position-major: one slot of one kv head is hd contiguous
// bf16 (256 bytes at hd = 128), slots n_kv * hd apart, so each slot is
// read by one warp with one coalesced load per lane.
//
// What bounds it on the H100: the layer's int8 weights, 116.39 MB at
// full width (0.0347 ms at 3.35 TB/s), plus the visible cache slots;
// a layer-route step is 26 launches of this entry and the lm_head (K2).
// The GEMVs read each weight byte once for up to 64 rows; the route
// pays 26 host calls per step, and the attention, like K1's, is one
// block per (row, head).
//
// Bit-for-bit with the plain version (ops/decode_step.py::
// decode_layer_step_plain): every float reduction accumulates in f64 and
// rounds once to f32, and the build passes -fmad=false.
#include <cuda_bf16.h>
#include <math.h>

#include "decode_common.cuh"
#include "w8_common.cuh"

namespace vx {
namespace {

// One block per (query head h, row b); kv head jh = h / G.  The query
// sits at position ``off``; it attends the cache slots [lo, min(off, S)),
// lo = max(0, off - window) (window < 0: 0), and itself.  kc / vc: this
// layer's position-major cache [B, S, n_kv, hd] bf16.  Scores: one warp
// per slot, f32 q x bf16 k summed in f64; P.V: one warp per slot, a lane
// per pair of head dims, f32 weights x bf16 v in f64, per-warp partials
// summed over the warps in f64.  Dynamic shared memory: the partials
// (nw x hd doubles), q (scaled), k, v and ``span`` scores (span = the
// most slots the window lets a row see, from S and the window).
__global__ void __launch_bounds__(kAttnThreads) attn_layer_kernel(
    const float* __restrict__ qkv, const float* __restrict__ cosv,
    const float* __restrict__ sinv, int off,
    const __nv_bfloat16* __restrict__ kc, const __nv_bfloat16* __restrict__ vc,
    __nv_bfloat16* __restrict__ kn, __nv_bfloat16* __restrict__ vn,
    float* __restrict__ attn, int S, int window, int n_heads, int n_kv,
    int hd, float scale) {
  extern __shared__ double smem_d[];
  __shared__ float red[32];
  __shared__ double red_d[32];
  __shared__ float self_sh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = nt >> 5;
  double* part = smem_d;                                   // [nw * hd]
  float* qf = reinterpret_cast<float*>(smem_d + nw * hd);  // [hd] scaled q
  float* kf = qf + hd;                                     // [hd] roped k
  float* vf = kf + hd;                                     // [hd] v
  float* sc = vf + hd;                                     // [span]
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = n_heads / n_kv, jh = h / G;
  const int lo = window >= 0 ? max(0, off - window) : 0;
  const int n = max(min(off, S) - lo, 0);
  rope_row(qkv, cosv, sinv, 0, b, h, jh, G, n_heads, n_kv, hd, scale, qf,
           nullptr, kf, vf, kn, vn);
  __syncthreads();

  const size_t stride = static_cast<size_t>(n_kv) * hd;  // between slots
  const size_t head = (static_cast<size_t>(b) * S * n_kv + jh) * hd;
  const __nv_bfloat16* kbase = kc + head;
  const __nv_bfloat16* vbase = vc + head;
  // Cache scores: q . k over slots lo .. lo + n - 1, f64 sums.
  for (int t = warp; t < n; t += nw) {
    const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(
        kbase + static_cast<size_t>(lo + t) * stride);
    double p = 0.0;
    for (int d2 = lane; d2 < hd / 2; d2 += 32) {
      const float2 kv = __bfloat1622float2(kr[d2]);
      p += static_cast<double>(qf[2 * d2]) * kv.x;
      p += static_cast<double>(qf[2 * d2 + 1]) * kv.y;
    }
    p = warp_sum_d(p);
    if (lane == 0) sc[t] = static_cast<float>(p);
  }
  // Self score: the f32 q and k.
  if (warp == 0) {
    double p = 0.0;
    for (int d = lane; d < hd; d += 32)
      p += static_cast<double>(qf[d]) * kf[d];
    p = warp_sum_d(p);
    if (lane == 0) self_sh = static_cast<float>(p);
  }
  __syncthreads();
  // Softmax: f32 max over the cache scores and the self score; the cache
  // weights summed in f64, then the self weight added in f32.
  const float self_s = self_sh;
  float m = self_s;
  for (int t = tid; t < n; t += nt) m = fmaxf(m, sc[t]);
  m = block_max(m, red);
  double s = 0.0;
  for (int t = tid; t < n; t += nt) {
    const float e = expf(sc[t] - m);
    s += e;
    sc[t] = e;
  }
  s = block_sum_d(s, red_d);  // its barriers order the sc writes above
  const float e_self = expf(self_s - m);
  const float den = static_cast<float>(s) + e_self;
  // P.V over the cache (f32 weights x bf16 v, f64 sums), then the self
  // term in f32.
  constexpr int kPairs = kMaxHeadDim / 64;  // bf16 pairs per lane
  double acc2[kPairs][2];
#pragma unroll
  for (int c = 0; c < kPairs; ++c) acc2[c][0] = acc2[c][1] = 0.0;
  for (int t = warp; t < n; t += nw) {
    const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(
        vbase + static_cast<size_t>(lo + t) * stride);
    const double w = sc[t];
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int d2 = lane + 32 * c;
      if (d2 < hd / 2) {
        const float2 v2 = __bfloat1622float2(vr[d2]);
        acc2[c][0] += w * v2.x;
        acc2[c][1] += w * v2.y;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kPairs; ++c) {
    const int d2 = lane + 32 * c;
    if (d2 < hd / 2) {
      part[warp * hd + 2 * d2] = acc2[c][0];
      part[warp * hd + 2 * d2 + 1] = acc2[c][1];
    }
  }
  __syncthreads();
  float* out = attn + static_cast<size_t>(b) * n_heads * hd +
               static_cast<size_t>(h) * hd;
  for (int d = tid; d < hd; d += nt) {
    double acc = 0.0;
    for (int wi = 0; wi < nw; ++wi) acc += part[wi * hd + d];
    const float ctx = static_cast<float>(acc) + e_self * vf[d];
    out[d] = ctx / den;
  }
}

}  // namespace
}  // namespace vx

// All pointers are device pointers.  x, xo [B, D] f32; attn_norm,
// ffn_norm, ada [D] f32 (layer ``layer``'s); sqkv [nq + 2 nkv], so [D],
// s13 [2F], s2 [D] f32 row scales of layer ``layer``; cos / sin [hd] f32,
// pair-expanded, at position ``off``; kc / vc [B, S, n_kv, hd] bf16, the
// layer's position-major cache (read at slots < off only); the stacked
// int8 weights wqkv [L, nq + 2 nkv, D], wo [L, D, nq], w13 [L, 2F, D],
// w2 [L, D, F], of which layer ``layer`` is read; kn / vn [B, n_kv, hd]
// bf16.  Scratch: xq [B, max(D, nq, F)] int8, sx [B], qkv [B, nq + 2 nkv],
// attn [B, nq], up [B, 2F] f32.  window < 0: no lower bound.
extern "C" int vx_decode_layer_step(
    const void* x, void* xo, int layer, int off, const void* attn_norm,
    const void* ffn_norm, const void* ada, const void* sqkv, const void* so,
    const void* s13, const void* s2, const void* cosv, const void* sinv,
    const void* kc, const void* vc, const void* wqkv, const void* wo,
    const void* w13, const void* w2, void* kn, void* vn, void* xq_buf,
    void* sx_buf, void* qkv_buf, void* attn_buf, void* up_buf, int B, int D,
    int S, int n_heads, int n_kv, int hd, int F, int window, float eps,
    float scale, void* stream) {
  using namespace vx;
  if (hd > kMaxHeadDim || hd % 2 || n_kv <= 0 || n_heads % n_kv || B < 1 ||
      layer < 0 || off < 0 || off > S)
    return static_cast<int>(cudaErrorInvalidValue);
  const int span = (window >= 0 && window < S) ? window : S;
  const size_t smem = sizeof(double) * (kAttnThreads / 32) * hd +
                      sizeof(float) * (3 * static_cast<size_t>(hd) + span);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = n_heads * hd, nkv = n_kv * hd, nqkv = nq + 2 * nkv;
  float* X = static_cast<float*>(xo);
  int8_t* xq = static_cast<int8_t*>(xq_buf);
  float* sx = static_cast<float*>(sx_buf);
  float* qkv = static_cast<float*>(qkv_buf);
  float* att = static_cast<float*>(attn_buf);
  float* up = static_cast<float*>(up_buf);
  // Layer ``layer`` of an [L, N, K] int8 stack.
  auto wlayer = [&](const void* base, int N, int K) {
    return static_cast<const int8_t*>(base) +
           static_cast<size_t>(layer) * N * K;
  };
  auto gemv = [&](const void* W, int N, int K, const void* scale_row,
                  const float* resid, float* out) {
    launch_w8_gemv(xq, sx, wlayer(W, N, K),
                   static_cast<const float*>(scale_row), resid, out, B, N, K,
                   st);
  };

  cudaMemcpyAsync(X, x, sizeof(float) * static_cast<size_t>(B) * D,
                  cudaMemcpyDeviceToDevice, st);
  row_quant(X, D, D, static_cast<const float*>(attn_norm), nullptr, eps,
            kQuantNorm, B, xq, sx, nullptr, st);
  gemv(wqkv, nqkv, D, sqkv, nullptr, qkv);
  attn_layer_kernel<<<dim3(n_heads, B), kAttnThreads, smem, st>>>(
      qkv, static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      off, static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<__nv_bfloat16*>(kn),
      static_cast<__nv_bfloat16*>(vn), att, S, window, n_heads, n_kv, hd,
      scale);
  row_quant(att, nq, nq, nullptr, nullptr, eps, kQuantPlain, B, xq, sx,
            nullptr, st);
  gemv(wo, D, nq, so, X, X);
  row_quant(X, D, D, static_cast<const float*>(ffn_norm),
            static_cast<const float*>(ada), eps, kQuantNorm, B, xq, sx, nullptr,
            st);
  gemv(w13, 2 * F, D, s13, nullptr, up);
  row_quant(up, 2 * F, F, nullptr, nullptr, eps, kQuantSwiglu, B, xq, sx,
            nullptr, st);
  gemv(w2, D, F, s2, X, X);
  return static_cast<int>(cudaGetLastError());
}
