// K4, K5, K6: the tensor-parallel halves of a decode step, one shard's.
//
// Port of voxtral_tpu/ops/decode_tp_pallas.py: a decoder layer has two
// reduction points (after WO and after W2), so under tensor parallelism
// the layer splits there into two halves per shard, each emitting a
// PARTIAL that the caller sums over the model axis (psum) before the
// residual add:
//
//   K4 vx_attn_half_step (attn_half_step, :603-756; body _make_attn_half
//      :294, _spec_attn :145), one shard's heads (n_heads / tp query,
//      n_kv / tp kv heads):
//        quant(norm)        rmsnorm x attn_norm, per-row int8 quant
//        gemv qkv_l         the shard's q / k / v rows of layer ``layer``
//        attention          pair RoPE, GQA attention over the shard's
//                           local cache [Bc, n_kv_l, S, hd] (K1's launch,
//                           attn_step.cuh: one cluster per (stream, local
//                           kv head), offsets, window, spec rows;
//                           the head+ring mask, ring=; int8 codes with
//                           f32 scales [Bc, n_kv_l, S], cache_q; the
//                           chunked walk, cache_chunk: _make_attn_half
//                           :392-420, :456-540, _spec_attn's int8 rows)
//        quant(plain)       int8 quant of the LOCAL attention output, with
//                           the local row absmax (decode_tp_pallas.py:
//                           43-47, :555)
//        gemv wo_l          the WO partial, no residual
//   K5 vx_ffn_half_step (ffn_half_step, :763-834; body _make_ffn_half
//      :561), one shard's F rows:
//        quant(norm, ada), gemv w13_l, quant(swiglu) over the local F
//        (local absmax, :592), gemv w2_l: the W2 partial
//   K6 vx_lm_half_argmax (lm_half_argmax, :1285-1382; body _make_lm_half
//      :1228), one shard's vocab rows: row_quant(final norm) -- XLA's in
//      JAX, here the row kernel -- then the lm fold: over a g32 shard
//      from 5 rows the fold of K1's weight stream (k1_stream.cuh: one
//      table pass, one int8 mma a group and 16 rows, then
//      argmax_merge_kernel), else lm_argmax.cuh's; (max, first local
//      index) per row; tp_lm_head_token resolves the shards (pmax, then
//      the lowest global index).
//
// The building blocks are K1's (decode_common.cuh, w8_common.cuh,
// attn_step.cuh); the scales of wo and w2 are full-D and replicated, so a
// partial is (float(z_l) * sx_l) * s[n] with the shard's own sx_l.
//
// Two weight formats (wfmt): 0 = w8 (int8 codes, f32 row scales [N]),
// 1 = g32 (q4g: int8 codes = Q4_0 nibble - 8, f16 group scales
// [N, K/32]; the g32 halves of _half_plan / _stream_factory with wg,
// decode_tp_pallas.py:72-142, :294-352, :561-582, :1228-1279).  In g32
// each shard holds its own K/32 scale columns of wo and w2 (row-parallel:
// its K columns and their groups), so a partial is
// float(sum_g z_g * s[n, g]) * sx_l over the shard's groups: the g32
// GEMVs and the g32 fold of K1 mode (h) (w8_common.cuh,
// lm_argmax.cuh).  Bytes: 1.0625 per weight instead of 1 + 4 / K.
//
// K4 and K5 are each one chain of programmatic dependent launches (pdl):
// a kernel may start while its predecessor runs and touches nothing the
// predecessor writes before pdl_wait.  A quant(...) step and the GEMV
// after it are one launch or two, as the linear's plan says (tp_gemv.cu:
// the GEMV quantizes its row in its prologue, or follows the row
// kernel), and K5's w13 may put the SwiGLU in its epilogue, so w2's row
// needs no gate; the GEMVs load their first weights before the wait.
// The attention is K1's cluster launch, in stream order after the qkv
// GEMV (launched ahead it measured slower on the H100).  At one w8 row
// K4 is 4 launches and K5 3; the plans come from
// ops/decode_tp.py::tp_gemv_plan.  K6 launches its row kernel and
// lm_argmax.cuh's fold plainly (at one row 75 % of its bytes' bound);
// where it takes the stream's fold (g32, ops/decode_tp.py::
// lm_stream_plan) the fold and its merge go as programmatic dependent
// launches, the fold's first weight chunks loading under the row kernel.
//
// What bounds it on the H100, at tp = 2 and full width, one row: K4 the
// layer's local weights, 9.44 MB of wqkv_l + 6.29 MB of wo_l (16.71 MB
// of codes and f16 group scales in g32), and the visible slots of the
// local cache (bf16, or int8 codes and their scales: what K1's (d) /
// (e) / (f) read, over half the heads); K5 28.31 + 14.16 MB of w13_l /
// w2_l (45.12 MB in g32); K6 the 201.6 MB vocab shard (213.9 MB in
// g32).  A position costs 26 x (K4 + K5) calls per shard from the host,
// the same host cost as the per-layer route (K7).
//
// Bit for bit with the plain versions (ops/decode_tp.py): every float
// reduction accumulates in f64 and rounds once, and the build passes
// -fmad=false.
#include <cuda_bf16.h>
#include <math.h>

#include <initializer_list>

#include "attn_step.cuh"
#include "decode_common.cuh"
#include "k1_stream.cuh"
#include "lm_argmax.cuh"
#include "w8_common.cuh"

namespace vx {
// One linear of a half (tp_gemv.cu).
cudaError_t tp_linear(int wfmt, int plan, int qm, const float* x, int ldx,
                      int K, const float* w, const float* ada, float eps,
                      int8_t* xq, float* sx, const int8_t* codes,
                      const void* scale, float* out, int M, int N,
                      bool gated, cudaStream_t st, bool pdl);
// Whether it runs w13 with the SwiGLU in its epilogue (tp_gemv.cu).
bool tp_swiglu_fits(int wfmt, int plan, int M, int K, const void* codes,
                    const void* xq);
}  // namespace vx

namespace {

constexpr int kW8Fmt = 0, kG32Fmt = 1;

// g32 needs every contraction width % 32 and 16-byte aligned code rows.
bool g32_ok(int wfmt, std::initializer_list<int> widths,
            std::initializer_list<const void*> codes) {
  if (wfmt == kW8Fmt) return true;
  if (wfmt != kG32Fmt) return false;
  for (int k : widths)
    if (k % 32) return false;
  for (const void* p : codes)
    if (!vx::aligned16(p)) return false;
  return true;
}

}  // namespace

// All pointers are device pointers.  x, yo [B, D] f32; attn_norm [D],
// sqkv [nq + 2 nkv], so [D] f32 (layer ``layer``'s; nq = n_heads * hd and
// nkv = n_kv * hd the shard's); cos / sin [hd] (rope_stride 0) or
// [B, hd] (rope_stride hd) f32, pair-expanded; kc / vc [Bc, n_kv, S, hd]
// bf16, or int8 codes with k_scales / v_scales [Bc, n_kv, S] f32 (mode
// (e)), the shard's cache of this layer (read at its visible slots only);
// wqkv [L, nq + 2 nkv, D] and wo [L, D, nq] int8 stacks, layer ``layer``
// read; wfmt 1 (g32): sqkv [nq + 2 nkv, D/32] and so [D, nq/32] f16;
// kn / vn [B, n_kv, hd] bf16 (also over an int8 cache: the caller
// quantizes them for its append); offs [Bc] int32 or NULL (then off0 for
// every stream); B = Bc x spec rows ordered (stream, draft slot).
// ring_size > 0: mode (d), a head+ring cache of ring_head + ring_size <=
// S slots, the offsets absolute positions.  chunk > 0: mode (f), the
// attention walks the cache in chunks of ``chunk`` slots (chunk divides
// S; spec must be 1).  The attention launch is K1's (attn_step.cuh::
// prepare_attention / launch_attention).  Scratch: xq [B, max(D, nq)]
// int8, sx [B], qkv [B, nq + 2 nkv], attn [B, nq] f32.  window < 0: no
// lower bound.  plan_qkv / plan_wo: the two linears' plans (tp_gemv.cu);
// pdl 1: the linears' launches go ahead as their plans say (0: plain
// stream order).
extern "C" int vx_attn_half_step(
    const void* x, void* yo, int layer, const void* attn_norm,
    const void* sqkv, const void* so, const void* cosv, const void* sinv,
    const void* kc, const void* vc, const void* k_scales,
    const void* v_scales, const void* wqkv, const void* wo, void* kn,
    void* vn, void* xq_buf, void* sx_buf, void* qkv_buf, void* attn_buf,
    const void* offs, int B, int D, int S, int n_heads, int n_kv, int hd,
    int off0, int spec, int rope_stride, int window, int ring_head,
    int ring_size, int chunk, int wfmt, float eps, float scale,
    int plan_qkv, int plan_wo, int pdl, void* stream) {
  using namespace vx;
  const bool ring = ring_size > 0;
  const bool kv8 = k_scales != nullptr;
  if (!g32_ok(wfmt, {D, n_heads * hd}, {wqkv, wo}) || hd > kMaxHeadDim ||
      hd % 2 || n_kv <= 0 || n_heads % n_kv ||
      spec < 1 || B % spec || layer < 0 ||
      (offs == nullptr && (off0 < 0 || (!ring && off0 > S))) ||
      (ring && (ring_head < 0 || ring_head + ring_size > S)) ||
      (kv8 && (v_scales == nullptr || hd % 4)) ||
      (chunk != 0 && (chunk < 0 || S % chunk || spec != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnPrep prep;
  const cudaError_t pe = prepare_attention(B, spec, n_heads, n_kv, hd, S,
                                           window, ring_size, chunk, kv8,
                                           &prep);
  if (pe != cudaSuccess) return static_cast<int>(pe);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = n_heads * hd, nkv = n_kv * hd, nqkv = nq + 2 * nkv;
  int8_t* xq = static_cast<int8_t*>(xq_buf);
  float* sx = static_cast<float*>(sx_buf);
  float* qkv = static_cast<float*>(qkv_buf);
  float* att = static_cast<float*>(attn_buf);
  cudaError_t e = tp_linear(
      wfmt, plan_qkv, kQuantNorm, static_cast<const float*>(x), D, D,
      static_cast<const float*>(attn_norm), nullptr, eps, xq, sx,
      static_cast<const int8_t*>(wqkv) + static_cast<size_t>(layer) * nqkv * D,
      sqkv, qkv, B, nqkv, false, st, pdl != 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const AttnLaunch at{qkv, static_cast<const float*>(cosv),
                      static_cast<const float*>(sinv), rope_stride,
                      static_cast<const int*>(offs), off0, B, spec, kc, vc,
                      static_cast<const float*>(k_scales),
                      static_cast<const float*>(v_scales),
                      static_cast<__nv_bfloat16*>(kn),
                      static_cast<__nv_bfloat16*>(vn), att, S, window,
                      ring_head, ring_size, chunk, n_heads, n_kv, hd, scale};
  e = launch_attention(at, prep, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = tp_linear(wfmt, plan_wo, kQuantPlain, att, nq, nq, nullptr, nullptr,
                eps, xq, sx,
                static_cast<const int8_t*>(wo) +
                    static_cast<size_t>(layer) * D * nq,
                so, static_cast<float*>(yo), B, D, false, st, pdl != 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// x, zo [B, D] f32; ffn_norm, ada [D], s13 [2F], s2 [D] f32 (layer
// ``layer``'s; F the shard's hidden rows); w13 [L, 2F, D] (the shard's w1
// rows, then its w3 rows) and w2 [L, D, F] int8 stacks; wfmt 1 (g32):
// s13 [2F, D/32] and s2 [D, F/32] f16.  Scratch: xq [B, max(D, F)] int8,
// sx [B], up [B, 2F] f32 (the w13 outputs, or h = SwiGLU of them in its
// first B x F where plan_w13 puts the gate in w13's epilogue).
// plan_w13 / plan_w2: the two linears' plans; pdl 1: their launches go
// ahead as the plans say (0: plain stream order).
extern "C" int vx_ffn_half_step(
    const void* x, void* zo, int layer, const void* ffn_norm,
    const void* ada, const void* s13, const void* s2, const void* w13,
    const void* w2, void* xq_buf, void* sx_buf, void* up_buf, int B, int D,
    int F, int wfmt, float eps, int plan_w13, int plan_w2, int pdl,
    void* stream) {
  using namespace vx;
  if (!g32_ok(wfmt, {D, F}, {w13, w2}) || B < 1 || D < 1 || F < 1 ||
      layer < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* xq = static_cast<int8_t*>(xq_buf);
  float* sx = static_cast<float*>(sx_buf);
  float* up = static_cast<float*>(up_buf);
  const int8_t* w13_l =
      static_cast<const int8_t*>(w13) + static_cast<size_t>(layer) * 2 * F * D;
  const bool gated = tp_swiglu_fits(wfmt, plan_w13, B, D, w13_l, xq);
  cudaError_t e = tp_linear(
      wfmt, plan_w13, kQuantNorm, static_cast<const float*>(x), D, D,
      static_cast<const float*>(ffn_norm), static_cast<const float*>(ada),
      eps, xq, sx, w13_l, s13, up, B, 2 * F, gated, st, pdl != 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = tp_linear(wfmt, plan_w2, gated ? kQuantPlain : kQuantSwiglu, up,
                gated ? F : 2 * F, F, nullptr, nullptr, eps, xq, sx,
                static_cast<const int8_t*>(w2) +
                    static_cast<size_t>(layer) * D * F,
                s2, static_cast<float*>(zo), B, D, false, st, pdl != 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// x [B, D] f32 (the stack's output, replicated); final_norm [D] f32;
// codes [V, D] int8 and scale [V] f32 (wfmt 1, g32: [V, D/32] f16), this
// shard's vocab rows; vmax [B]
// f32 and vidx [B] int32: the largest logit of each row and its first
// LOCAL index.  plan (host memory): {kc, stages, grid} of the weight
// stream's fold over the shard (ops/decode_tp.py::lm_stream_plan; kc 0:
// lm_argmax.cuh's fold).  Scratch: xq [B, D] int8, sx [B], tmax / tidx
// [B, ceil(V / 16)] f32 / int32.
extern "C" int vx_lm_half_argmax(
    const void* x, const void* final_norm, const void* codes,
    const void* scale, void* vmax, void* vidx, void* xq_buf, void* sx_buf,
    void* tmax_buf, void* tidx_buf, int B, int D, int V, int wfmt, float eps,
    const int* plan, void* stream) {
  using namespace vx;
  if (!g32_ok(wfmt, {D}, {codes}) || B < 1 || D < 1 || V < 1 ||
      plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fmt = wfmt == kG32Fmt ? kG32 : kW8;
  const StreamPlan p{plan[0], plan[1], plan[2]};
  cudaError_t e = prepare_stream(fmt, B, D, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* xq = static_cast<int8_t*>(xq_buf);
  float* sx = static_cast<float*>(sx_buf);
  e = row_quant(static_cast<const float*>(x), D, D,
                static_cast<const float*>(final_norm), nullptr, eps,
                kQuantNorm, B, xq, sx, nullptr, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const StreamSegs sg{{static_cast<const char*>(codes), nullptr, nullptr},
                      V, 0};
  if (p.kc > 0) {  // the stream's fold: a group's partials, then the merge
    if (!stream_aligned(xq, sg, fmt == kG32 ? scale : nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const StreamArgs a{xq, sx, sg, scale, nullptr, nullptr,
                       static_cast<float*>(tmax_buf),
                       static_cast<int*>(tidx_buf), B, V, D, 0, 0};
    e = launch_stream(fmt, p, a, st, true);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = launch_pdl(argmax_merge_kernel, dim3(B), dim3(256), 0, st, true,
                   static_cast<const float*>(tmax_buf),
                   static_cast<const int*>(tidx_buf),
                   (V + stream_fmt(fmt).rows - 1) / stream_fmt(fmt).rows,
                   static_cast<float*>(vmax), static_cast<int*>(vidx));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  launch_argmax(fmt, xq, sx, codes, scale, B, V, D,
                static_cast<float*>(tmax_buf),
                static_cast<int*>(tidx_buf), static_cast<float*>(vmax),
                static_cast<int*>(vidx), st);
  return static_cast<int>(cudaGetLastError());
}
