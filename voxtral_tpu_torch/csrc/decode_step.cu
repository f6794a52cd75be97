// K1: one decode step through every decoder layer, then the final norm
// and the tied lm_head folded to logits.
//
// Port of voxtral_tpu/ops/decode_step_pallas.py::decode_stack_step
// (kernel body _make_stack_kernel) in its modes
//   (a) w8 weights, bf16 bounded head-major cache, scalar offset,
//       sliding window, lm fold to logits;
//   (b) spec = K: B = Bc x K rows ordered (stream b, draft slot j); the
//       K rows of a stream share its cache row, row j's query sits at
//       offs[b] + j and also attends the fresh K/V of rows i < j
//       (_make_stack_kernel's spec branch, :783-986) -- K drafted tokens
//       verified in one pass over the weights;
//   (c) per-stream offsets as an int32 device vector and per-row RoPE
//       vectors (build_valid, :1005-1043), read by each attention block
//       itself, so the host launches a step without reading an offset.
//   (d) head+ring cache (ring_size > 0), the unbounded stream's: slots
//       [0, head) hold positions [0, head) for good, ring slot r holds
//       the largest position head + r + size * c below the offset
//       (build_valid's ring branch, :1020-1042; spec rows :813-829).
//       The block walks all S slots in slot order, computes each slot's
//       (absolute position, written) exactly as build_valid and as the
//       plain version does, and scores / loads only the visible ones
//       (written, and within the window of the row's absolute query
//       position); the score buffer holds S floats.  Combines with every
//       other mode: the mask reads offs[b] per stream.
//   (h) g32 (q4g) weights: int8 codes (Q4_0 nibble - 8) with f16 group
//       scales [N, K/32] in place of the w8 row scales, for the four
//       stacks and the lm fold (_g32_mask_codes / _g32_matmul_tile,
//       :84-123): the group-32 GEMVs of w8_common.cuh.  The JAX layouts
//       [L, SB, N, 128] / [L, 4 SB, 1, N] f32 exist for Mosaic; here the
//       codes keep the w8 layout [L, N, K] and the scales stay f16
//       (1.0625 instead of 1.125 bytes per weight, the same values).
//   (e) int8 KV cache (k_scales / v_scales given): int8 codes with one
//       f32 scale per cached vector [L, Bc, n_kv, S] (scores_of / ctx_of,
//       :1045-1080; the spec branch's fresh-row roundtrip, :831-929).
//       q is quantized per query head, the scores are integer dots
//       (__dp4a) times sq * ks[t], the softmax weights times vs[t] are
//       requantized in one group per row (cache slots and fresh rows
//       together) and P.V is an integer dot again: attn_kv_kernel<true>.
//   (g) bf16 weights (wfmt 2; wq8=False, :558, :667-677, :742-752, the
//       lm fold :1274-1281): the dense {"nt": w} leaves of
//       fuse_decode_weights_bf16, [L, N, K] bf16, streamed as they are
//       (the qkv phase in up to three segments wq / wk / wv, the FFN's in
//       w1 / w3), no scales.  row_quant writes the norm / ADA / SwiGLU row
//       as bf16 instead of int8 codes, and the bf16 GEMV of bf16_gemv.cuh
//       sums the exact bf16 x bf16 products in f64.  The attention
//       kernels are the same, so (g) combines with (b)-(f).  Bytes: 2 per
//       weight, 6.86 GB per step at full width with the lm table.
//   (f) chunked cache (chunk = Sc > 0, spec = 1; :1085-1180): an online
//       softmax over chunks of Sc slots in slot order, carrying
//       (m, denom, ctx); only the chunks c_lo .. n_used - 1 that some
//       row of the batch can see are visited (the offsets' min / max are
//       read by every block on the device).  bf16 weights round against
//       the running max and the int8 requant group is per chunk, so the
//       carry is sequential: one block per (row, head) walks its chunks.
//       The score buffer holds Sc floats, not S, so shared memory no
//       longer bounds S.  attn_kv_kernel<false / true>.
//       Bytes: what bounds (e) and (f) are the visible slots' int8 codes
//       (half the bf16 cache) and their scale planes.
//   (i) lm_argmax (w8; :1285-1300, :1479, :1605): the greedy argmax
//       folded into the lm_head (lm_argmax.cuh: per vocab tile the
//       (max, first index), then the tiles merged), so the [B, V] logits
//       are never written; the step returns the token of each row.  Its
//       caller is the data-parallel greedy decode (parallel/dp_decode.py).
// The TPU kernel is one pallas_call whose sequential grid carries the
// residual across layers in VMEM.  CUDA blocks run in no order, so here
// the step is a fixed sequence of small kernels on one stream, with the
// residual in a [B, D] f32 buffer in HBM; per layer:
//
//   row_quant(norm)      rmsnorm x attn_norm, per-row int8 quant
//   gemv qkv             W8A8 or g32 GEMV (w8_common.cuh)
//   attn_step            pair RoPE, GQA attention over the bf16 cache
//                        slots [max(0, off + j - window), off), the fresh
//                        rows i < j of the stream and the row itself, one
//                        block per (row, query head); k_new / v_new
//   row_quant(plain)     int8 quant of the attention output
//   gemv wo (+ x)        residual fused into the epilogue
//   row_quant(norm, ada) rmsnorm x ffn_norm x ADA vector, int8 quant
//   gemv w13
//   row_quant(swiglu)    silu(gate) * up, int8 quant
//   gemv w2 (+ x)
//
// then row_quant(final norm) and the lm_head GEMV (mode (g): bf16 rows and
// the bf16 GEMV in the same places).  9 launches per layer
// + 2.  What bounds it on the H100: the int8 weights streamed per step
// (3.4 GB at full width, lm_head included); the GEMVs read each weight
// byte once with 16-byte loads for up to 64 rows (spec: 8 streams x
// K = 8), everything else is a few KB per launch.  Launch gaps and the
// unfused epilogues are later work (CUDA graph, persistent kernel).
//
// Rounding points follow the JAX kernel: q is scaled in f32 and cast to
// bf16 for the cache scores; the self score and the fresh scores use the
// unrounded f32 q and k; the cache's softmax weights are cast to bf16
// for P.V; the fresh terms e_i * v_i and the self term use the f32 v;
// the softmax denominator is the cache sum, then each e_i, then e_self;
// k_new / v_new are stored as bf16.
//
// Bit-for-bit with the plain version (ops/decode_step.py): every float
// reduction (sum of squares, scores, softmax sum, P.V) accumulates in
// f64 and rounds once to f32, so its value does not depend on the
// summation order; the build passes -fmad=false, so each float op
// rounds on its own as PyTorch's ops do.  Without this, f32 order
// differences flip int8 activation codes, and over 26 layers of random
// weights those flips grow to ~8% of the logits.
#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "attn_step.cuh"
#include "bf16_gemv.cuh"
#include "decode_common.cuh"
#include "lm_argmax.cuh"
#include "w8_common.cuh"

namespace vx {
namespace {

// The weight format of the host entry's ``wfmt``.
enum WeightFormat { kW8 = 0, kG32 = 1, kBf16 = 2 };

// Modes (e) and (f): the attention block over an int8 cache (kInt8: codes
// with one f32 scale per cached vector, ks / vs [Bc, n_kv, S] for this
// layer) and / or walked in chunks of ``chunk`` slots (chunk > 0, spec = 1;
// chunk == 0: the whole span at once, as attn_step_kernel).  Grid, rows,
// RoPE, offsets, window and ring mask as attn_step_kernel.
//
// int8 (scores_of / ctx_of, decode_step_pallas.py:1045-1080): the scaled
// q is quantized per query head, sq = max(absmax, 1e-8) / 127; the score
// of slot t is float(qq . kcodes[t]) * sq * ks[t]; the self score stays
// the f32 q . k.  The softmax weights e[t] * vs[t] are requantized with
// se = max(absmax, 1e-30) / 127 (one group per row, or per chunk) and
// ctx = float(eq . vcodes) * se.  With spec > 1 (:831-929) the fresh rows
// i < j read as the sequential step would read them back: through bf16
// and the per-vector quantization, their weights in the cache's requant
// group.  Every dot is an integer sum, exact in any order.
//
// Chunked (:1085-1180): (m, den, ctx) start at (-1e30, 0, 0); per chunk
// m_new = max(m, max s), alpha = exp(m - m_new), e = exp(s - m_new),
// den = den * alpha + sum e, ctx = ctx * alpha + P.V(chunk); the self
// term merges last.  Chunks c_lo .. n_used - 1 of the whole batch are
// walked (bounded: from max(min_off - window, 0) / chunk to
// ceil(max_off / chunk); ring: from 0 to ceil(min(max_off, head + size)
// / chunk)); a chunk this row sees nothing of leaves its carry as it was.
// Dynamic shared memory: P.V partials (nw x hd doubles), q, its bf16
// rounding or int8 codes, k, v, fresh scores and fresh v scales (spec
// each), and ``span`` scores (the chunk, or as attn_step_kernel).
template <bool kInt8>
__global__ void __launch_bounds__(kAttnThreads) attn_kv_kernel(
    const float* __restrict__ qkv, const float* __restrict__ cosv,
    const float* __restrict__ sinv, int rope_stride,
    const int* __restrict__ offs, int off0, int n_streams, int spec,
    const void* __restrict__ kc_, const void* __restrict__ vc_,
    const float* __restrict__ ks, const float* __restrict__ vs,
    __nv_bfloat16* __restrict__ kn, __nv_bfloat16* __restrict__ vn,
    float* __restrict__ attn, int S, int window, int ring_head, int ring_size,
    int chunk, int n_heads, int n_kv, int hd, float scale) {
  using cache_t = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  extern __shared__ double smem_d[];
  __shared__ float red[32];
  __shared__ double red_d[32];
  __shared__ float self_sh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = nt >> 5;
  double* part = smem_d;                                   // [nw * hd]
  float* qf = reinterpret_cast<float*>(smem_d + nw * hd);  // [hd] scaled q
  float* qb = qf + hd;             // [hd] bf16(q), or hd int8 codes of q
  float* kf = qb + hd;             // [hd] roped k
  float* vf = kf + hd;             // [hd] v
  float* fs = vf + hd;             // [spec] fresh scores, then weights
  float* fvs = fs + spec;          // [spec] fresh v scales (int8)
  float* sc = fvs + spec;          // [span]
  const int8_t* qq = reinterpret_cast<const int8_t*>(qb);
  const int h = blockIdx.x, r = blockIdx.y;
  const int b = r / spec, j = r - b * spec;
  const int G = n_heads / n_kv, jh = h / G;
  const int nq = n_heads * hd, nkv = n_kv * hd, ld = nq + 2 * nkv;
  const int off = offs != nullptr ? offs[b] : off0;
  const bool ring = ring_size > 0;
  rope_row(qkv, cosv, sinv, rope_stride, r, h, jh, G, n_heads, n_kv, hd, scale,
           qf, kInt8 ? nullptr : qb, kf, vf, kn, vn);
  __syncthreads();

  float sq = 1.0f;
  if constexpr (kInt8) {
    float qa = 0.0f;
    for (int d = tid; d < hd; d += nt) qa = fmaxf(qa, fabsf(qf[d]));
    qa = block_max(qa, red);
    sq = fmaxf(qa, 1e-8f) / 127.0f;
    int8_t* qw = reinterpret_cast<int8_t*>(qb);
    for (int d = tid; d < hd; d += nt)
      qw[d] = static_cast<int8_t>(
          fminf(fmaxf(rintf(qf[d] / sq), -127.0f), 127.0f));
    __syncthreads();
  }
  const size_t head = (static_cast<size_t>(b) * n_kv + jh) * S;
  const cache_t* kbase = static_cast<const cache_t*>(kc_) + head * hd;
  const cache_t* vbase = static_cast<const cache_t*>(vc_) + head * hd;
  const float* ksb = kInt8 ? ks + head : nullptr;
  const float* vsb = kInt8 ? vs + head : nullptr;

  // Is cache slot ``slot`` visible to this row (written, and within the
  // window of the query at off + j)?
  auto visible = [&](int slot) {
    if (ring) return ring_visible(slot, off, j, window, ring_head, ring_size);
    return slot < off && slot < S &&
           (window < 0 || off + j - slot <= window);
  };
  // The score of a visible slot.
  auto score = [&](int slot) -> float {
    if constexpr (kInt8) {
      const int* kr = reinterpret_cast<const int*>(
          kbase + static_cast<size_t>(slot) * hd);
      const int* qi = reinterpret_cast<const int*>(qq);
      int acc = 0;
#pragma unroll 8
      for (int w = 0; w < hd / 4; ++w) acc = __dp4a(kr[w], qi[w], acc);
      return (static_cast<float>(acc) * sq) * ksb[slot];
    }
    const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(
        kbase + static_cast<size_t>(slot) * hd);
    double p = 0.0;
#pragma unroll 8
    for (int d2 = 0; d2 < hd / 2; ++d2) {
      const float2 kv = __bfloat1622float2(kr[d2]);
      p += static_cast<double>(qb[2 * d2]) * kv.x;
      p += static_cast<double>(qb[2 * d2 + 1]) * kv.y;
    }
    return static_cast<float>(p);
  };
  // P.V over slots base .. base + n - 1 with the weights sc[0 .. n): bf16
  // weights x bf16 v in f64, or int8 codes x int8 v in int32 (exact);
  // one warp per slot, per-warp partial sums into part, then
  // __syncthreads.  A weight of 0 adds nothing and loads nothing.
  constexpr int kWords = kMaxHeadDim / (kInt8 ? 128 : 64);  // per lane
  auto pv = [&](int base, int n) {
    double accd[kInt8 ? 1 : kWords][2];
    int acci[kInt8 ? kWords : 1][4];
#pragma unroll
    for (int c = 0; c < kWords; ++c) {
      if constexpr (kInt8) {
        acci[c][0] = acci[c][1] = acci[c][2] = acci[c][3] = 0;
      } else {
        accd[c][0] = accd[c][1] = 0.0;
      }
    }
#pragma unroll 4
    for (int t = warp; t < n; t += nw) {
      const float w = sc[t];
      if (w == 0.0f) continue;
      if constexpr (kInt8) {
        const int wi = static_cast<int>(w);
        const int* vr = reinterpret_cast<const int*>(
            vbase + static_cast<size_t>(base + t) * hd);
#pragma unroll
        for (int c = 0; c < kWords; ++c) {
          const int w4 = lane + 32 * c;
          if (w4 < hd / 4) {
            const int word = vr[w4];
            acci[c][0] += wi * static_cast<int8_t>(word & 0xff);
            acci[c][1] += wi * static_cast<int8_t>((word >> 8) & 0xff);
            acci[c][2] += wi * static_cast<int8_t>((word >> 16) & 0xff);
            acci[c][3] += wi * static_cast<int8_t>((word >> 24) & 0xff);
          }
        }
      } else {
        const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(
            vbase + static_cast<size_t>(base + t) * hd);
        const double wd = w;
#pragma unroll
        for (int c = 0; c < kWords; ++c) {
          const int d2 = lane + 32 * c;
          if (d2 < hd / 2) {
            const float2 v2 = __bfloat1622float2(vr[d2]);
            accd[c][0] += wd * v2.x;
            accd[c][1] += wd * v2.y;
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kWords; ++c) {
      const int w4 = lane + 32 * c;
      if constexpr (kInt8) {
        if (w4 < hd / 4)
          for (int k = 0; k < 4; ++k)
            part[warp * hd + 4 * w4 + k] = static_cast<double>(acci[c][k]);
      } else if (w4 < hd / 2) {
        part[warp * hd + 2 * w4] = accd[c][0];
        part[warp * hd + 2 * w4 + 1] = accd[c][1];
      }
    }
    __syncthreads();
  };
  // Thread d's P.V sum over the warps, rounded once to f32.
  auto pv_sum = [&](int d) -> float {
    double acc = 0.0;
    for (int wi = 0; wi < nw; ++wi) acc += part[wi * hd + d];
    return static_cast<float>(acc);
  };
  auto to_code = [](float v) {
    return fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  };

  // Self score: the unrounded f32 q and k.
  if (warp == 0) {
    double p = 0.0;
    for (int d = lane; d < hd; d += 32)
      p += static_cast<double>(qf[d]) * kf[d];
    p = warp_sum_d(p);
    if (lane == 0) self_sh = static_cast<float>(p);
  }
  float* out = attn + static_cast<size_t>(r) * nq + static_cast<size_t>(h) * hd;

  if (chunk > 0) {
    // Mode (f).  The chunk range is the whole batch's.
    int mn = off0, mx = off0;
    if (offs != nullptr) {
      mn = mx = offs[0];
      for (int i = 1; i < n_streams; ++i) {
        mn = min(mn, offs[i]);
        mx = max(mx, offs[i]);
      }
    }
    const int used = ring ? min(mx, ring_head + ring_size) : mx;
    const int lo_pos = (!ring && window >= 0) ? max(mn - window, 0) : 0;
    const int c_lo = lo_pos / chunk;
    const int n_used = min((used + chunk - 1) / chunk, S / chunk);
    float m = -1e30f, den = 0.0f, ctx = 0.0f;  // ctx: dim tid (tid < hd)
    for (int c = c_lo; c < n_used; ++c) {
      const int base = c * chunk;
      float cm = -INFINITY;
      for (int t = tid; t < chunk; t += nt) {
        const float s = visible(base + t) ? score(base + t) : -INFINITY;
        sc[t] = s;
        cm = fmaxf(cm, s);
      }
      const float m_new = fmaxf(m, block_max(cm, red));
      const float alpha = expf(m - m_new);
      double s = 0.0;
      float ea = 0.0f;
      for (int t = tid; t < chunk; t += nt) {
        const bool vis = sc[t] != -INFINITY;
        const float e = expf(sc[t] - m_new);
        s += e;
        if constexpr (kInt8) {
          const float ew = vis ? e * vsb[base + t] : 0.0f;
          ea = fmaxf(ea, fabsf(ew));
          sc[t] = ew;
        } else {
          sc[t] = round_bf16(e);
        }
      }
      s = block_sum_d(s, red_d);
      den = den * alpha + static_cast<float>(s);
      float se = 1.0f;
      if constexpr (kInt8) {
        se = fmaxf(block_max(ea, red), 1e-30f) / 127.0f;
        for (int t = tid; t < chunk; t += nt) sc[t] = to_code(sc[t] / se);
        __syncthreads();
      }
      pv(base, chunk);
      if (tid < hd) {
        const float p = pv_sum(tid);
        ctx = ctx * alpha + (kInt8 ? p * se : p);
      }
      m = m_new;
      __syncthreads();  // sc and part are rewritten by the next chunk
    }
    __syncthreads();  // self_sh
    const float self_s = self_sh;
    const float m_f = fmaxf(m, self_s);
    const float alpha = expf(m - m_f);
    const float e_self = expf(self_s - m_f);
    den = den * alpha + e_self;
    if (tid < hd) out[tid] = (ctx * alpha + e_self * vf[tid]) / den;
    return;
  }

  // Mode (e), the whole span at once (chunk == 0; kInt8 only).
  const int lo = ring ? 0 : (window >= 0 ? max(0, off + j - window) : 0);
  const int n = ring ? S : max(min(off, S) - lo, 0);
  for (int t = tid; t < n; t += nt)
    sc[t] = visible(lo + t) ? score(lo + t) : -INFINITY;
  auto fresh = [&](int i) { return window < 0 || j - i <= window; };
  // Fresh rows i < j, one warp each: k_i RoPE'd with row i's vectors,
  // through bf16 and the per-vector quantization; the score is
  // float(qq . kq_i) * sq * ks_i.  v_i's scale is kept for the weights.
  constexpr int kPer = kMaxHeadDim / 32;
  for (int i = warp; i < j; i += nw) {
    const int ri = r - j + i;
    const float* rowi = qkv + static_cast<size_t>(ri) * ld;
    const float* ki = rowi + nq + static_cast<size_t>(jh) * hd;
    const float* vi = rowi + nq + nkv + static_cast<size_t>(jh) * hd;
    const float* ci = cosv + static_cast<size_t>(ri) * rope_stride;
    const float* si = sinv + static_cast<size_t>(ri) * rope_stride;
    float kb[kPer];
    float ka = 0.0f, va = 0.0f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int d = lane + 32 * c;
      kb[c] = 0.0f;
      if (d < hd) {
        kb[c] = round_bf16(ki[d] * ci[d] + ki[d ^ 1] * si[d]);
        ka = fmaxf(ka, fabsf(kb[c]));
        va = fmaxf(va, fabsf(round_bf16(vi[d])));
      }
    }
    const float ksf = fmaxf(warp_max(ka), 1e-8f) / 127.0f;
    const float vsf = fmaxf(warp_max(va), 1e-8f) / 127.0f;
    int dot = 0;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int d = lane + 32 * c;
      if (d < hd)
        dot += static_cast<int>(to_code(kb[c] / ksf)) *
               static_cast<int>(qq[d]);
    }
    dot = warp_sum_i(dot);
    if (lane == 0) {
      fs[i] = fresh(i) ? (static_cast<float>(dot) * sq) * ksf : -INFINITY;
      fvs[i] = vsf;
    }
  }
  __syncthreads();
  // Softmax: f32 max over cache, self and fresh scores; f64 sum of the
  // cache weights, then the fresh weights and the self weight in f32;
  // the weights times their v scales requantized in one group.
  const float self_s = self_sh;
  float m = self_s;
  for (int t = tid; t < n; t += nt) m = fmaxf(m, sc[t]);
  for (int i = tid; i < j; i += nt) m = fmaxf(m, fs[i]);
  m = block_max(m, red);
  double s = 0.0;
  float ea = 0.0f;
  for (int t = tid; t < n; t += nt) {
    const bool vis = sc[t] != -INFINITY;
    const float e = expf(sc[t] - m);
    s += e;
    const float ew = vis ? e * vsb[lo + t] : 0.0f;
    ea = fmaxf(ea, fabsf(ew));
    sc[t] = ew;
  }
  s = block_sum_d(s, red_d);  // its barriers order the fs reads above
  for (int i = tid; i < j; i += nt) fs[i] = expf(fs[i] - m);  // e_i
  ea = block_max(ea, red);    // and its barriers the fs writes
  const float e_self = expf(self_s - m);
  float den = static_cast<float>(s);
  for (int i = 0; i < j; ++i) {
    if (!fresh(i)) continue;
    den = den + fs[i];
    ea = fmaxf(ea, fabsf(fs[i] * fvs[i]));
  }
  den = den + e_self;
  const float se = fmaxf(ea, 1e-30f) / 127.0f;
  for (int t = tid; t < n; t += nt) sc[t] = to_code(sc[t] / se);
  __syncthreads();
  pv(lo, n);
  for (int d = tid; d < hd; d += nt) {
    float ctx = pv_sum(d) * se;
    for (int i = 0; i < j; ++i) {
      if (!fresh(i)) continue;
      const float vi = round_bf16(
          qkv[static_cast<size_t>(r - j + i) * ld + nq + nkv +
              static_cast<size_t>(jh) * hd + d]);
      const float eqi = to_code((fs[i] * fvs[i]) / se);
      ctx = ctx + (eqi * to_code(vi / fvs[i])) * se;
    }
    ctx = ctx + e_self * vf[d];
    out[d] = ctx / den;
  }
}

}  // namespace
}  // namespace vx

// All pointers are device pointers; lm_codes == NULL skips the lm fold.
// B rows = Bc streams x spec draft rows, ordered (stream, slot).
// wfmt: kW8, kG32 (mode (h)) or kBf16 (mode (g)).
// Layouts: x, xo [B, D] f32; norms / ada [L, D] f32; scales [L, N] f32
// (g32: [L, N, K/32] f16, lm_scale [V, D/32] f16; bf16: unused, NULL);
// cos / sin [hd] (rope_stride 0) or [B, hd] (rope_stride hd) f32,
// pair-expanded; offs [Bc] int32 or NULL (then off0 for every stream);
// caches [L, Bc, n_kv, S, hd] bf16 (int8 in mode (e)); wqkv [L, nq + 2 nkv, D], wo [L, D, nq],
// w13 [L, 2F, D], w2 [L, D, F] int8; lm_codes [V, D] int8, lm_scale [V]
// f32; kn / vn [L, B, n_kv, hd] bf16; logits [B, V] f32.  Mode (g): the
// four stacks and lm_codes are bf16, and the qkv stack may come in three
// segments wqkv [L, nqkv_a, D], wqkv_b [L, nqkv_b, D], wqkv_c (the rest)
// and w13 in two, w13 [L, F, D] and w13_b [L, F, D] (NULL: one stack).
// Scratch: xq [B, max(D, nq, F)] int8 (bf16 in mode (g)), sx [B],
// qkv [B, nq + 2 nkv], attn [B, nq],
// up [B, 2F] f32.  window < 0: no lower bound.  ring_size > 0: mode (d),
// the caches are head+ring buffers of ring_head + ring_size <= S slots
// and the offsets absolute positions.  k_scales / v_scales != NULL: mode
// (e), the caches are int8 codes with f32 scales [L, Bc, n_kv, S].
// chunk > 0: mode (f), the attention walks the cache in chunks of
// ``chunk`` slots (chunk divides S; spec must be 1).  lm_argmax != 0:
// mode (i), w8 only: the lm fold writes token [B] int32, the first index
// of each row's largest logit, instead of the logits (lm_argmax.cuh;
// scratch tmax / tidx [B, ceil(V / 32)] f32 / int32).  The host reads no
// offset: a pass launches without a device-to-host copy.
extern "C" int vx_decode_stack_step(
    const void* x, void* xo, const void* attn_norms, const void* ffn_norms,
    const void* ada, const void* sqkv, const void* so, const void* s13,
    const void* s2, const void* cosv, const void* sinv, const void* kc,
    const void* vc, const void* wqkv, const void* wo, const void* w13,
    const void* w2, const void* final_norm, const void* lm_codes,
    const void* lm_scale, void* kn, void* vn, void* logits, void* xq_buf,
    void* sx_buf, void* qkv_buf, void* attn_buf, void* up_buf,
    const void* offs, const void* k_scales, const void* v_scales,
    const void* wqkv_b, const void* wqkv_c, const void* w13_b, void* token,
    void* tmax_buf, void* tidx_buf, int B, int D, int L, int S, int n_heads,
    int n_kv, int hd, int F, int V, int off0, int spec, int rope_stride,
    int window, int wfmt, int nqkv_a, int nqkv_b, int ring_head,
    int ring_size, int chunk, int lm_argmax, float eps, float scale,
    void* stream) {
  using namespace vx;
  const bool ring = ring_size > 0;
  if (hd > kMaxHeadDim || hd % 2 || n_kv <= 0 || n_heads % n_kv ||
      spec < 1 || B % spec ||
      (offs == nullptr && (off0 < 0 || (!ring && off0 > S))) ||
      (ring && (ring_head < 0 || ring_head + ring_size > S)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool g32 = wfmt == kG32, bf16 = wfmt == kBf16;
  if ((wfmt != kW8 && !g32 && !bf16) ||
      (g32 && (D % 32 || (n_heads * hd) % 32 || F % 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool kv8 = k_scales != nullptr;
  if ((kv8 && (v_scales == nullptr || hd % 4)) ||
      (chunk != 0 && (chunk < 0 || S % chunk || spec != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lm_argmax &&
      (wfmt != kW8 || lm_codes == nullptr || token == nullptr ||
       tmax_buf == nullptr || tidx_buf == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = n_heads * hd, nkv = n_kv * hd, nqkv = nq + 2 * nkv;
  const int Bc = B / spec;
  if (bf16) {  // the qkv segments: nqkv_a, nqkv_b and the rest of the rows
    const int rest = nqkv - nqkv_a - nqkv_b;
    if (nqkv_a <= 0 || nqkv_b < 0 || rest < 0 ||
        (nqkv_b > 0) != (wqkv_b != nullptr) ||
        (rest > 0) != (wqkv_c != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // attn_step_kernel for the bf16 cache at once; attn_kv_kernel for an
  // int8 cache and / or a chunked walk (it holds spec more floats).
  const bool kv_kernel = kv8 || chunk > 0;
  const int span = chunk > 0 ? chunk
                   : (!ring && window >= 0 && window < S) ? window : S;
  const size_t smem =
      sizeof(double) * (kAttnThreads / 32) * hd +
      sizeof(float) *
          (4 * static_cast<size_t>(hd) + (kv_kernel ? 2 : 1) * spec + span);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e =
        !kv_kernel
            ? cudaFuncSetAttribute(attn_step_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem))
        : kv8 ? cudaFuncSetAttribute(attn_kv_kernel<true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem))
              : cudaFuncSetAttribute(attn_kv_kernel<false>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  float* X = static_cast<float*>(xo);
  int8_t* xq = static_cast<int8_t*>(xq_buf);
  // Mode (g): the rows go to the GEMVs as bf16, in the same scratch.
  __nv_bfloat16* xb = bf16 ? static_cast<__nv_bfloat16*>(xq_buf) : nullptr;
  float* sx = static_cast<float*>(sx_buf);
  float* qkv = static_cast<float*>(qkv_buf);
  float* att = static_cast<float*>(attn_buf);
  float* up = static_cast<float*>(up_buf);
  const float* an = static_cast<const float*>(attn_norms);
  const float* fn = static_cast<const float*>(ffn_norms);
  const float* av = static_cast<const float*>(ada);
  // Layer l of an [L, N, K] stack of 1-byte (w8 / g32) or 2-byte (bf16)
  // weights.
  const size_t wsize = bf16 ? 2 : 1;
  auto wlayer = [&](const void* base, int l, int N, int K) -> const void* {
    if (base == nullptr) return nullptr;
    return static_cast<const char*>(base) +
           wsize * static_cast<size_t>(l) * N * K;
  };
  // Mode (g): one linear of layer l over up to three [L, n_i, K] bf16
  // segments (n0, n1 rows; the last takes the rest of N).
  auto gemv_bf = [&](const void* s0, const void* s1, const void* s2, int n0,
                     int n1, int l, const float* resid, float* out, int N,
                     int K) {
    BfSegs sg;
    sg.n0 = n0;
    sg.n1 = n1;
    sg.w[0] = static_cast<const __nv_bfloat16*>(wlayer(s0, l, n0, K));
    sg.w[1] = static_cast<const __nv_bfloat16*>(wlayer(s1, l, n1, K));
    sg.w[2] = static_cast<const __nv_bfloat16*>(
        wlayer(s2, l, N - n0 - n1, K));
    launch_bf16_gemv(xb, sg, resid, out, B, N, K, st);
  };
  const int qa = bf16 ? nqkv_a : nqkv, qb = bf16 ? nqkv_b : 0;
  const int fa = (bf16 && w13_b != nullptr) ? F : 2 * F;
  // One linear of the step on the rows quantized in xq / sx: W8A8 (row
  // scales [N] f32) or g32 (group scales [N, K/32] f16, mode (h)).
  auto gemv = [&](const void* Wv, const void* Sc, const float* resid,
                  float* out, int N, int K) {
    const int8_t* W = static_cast<const int8_t*>(Wv);
    if (g32)
      launch_g32_gemv(xq, sx, W, static_cast<const __half*>(Sc), resid, out,
                      B, N, K, st);
    else
      launch_w8_gemv(xq, sx, W, static_cast<const float*>(Sc), resid, out, B,
                     N, K, st);
  };
  // Layer l's scales of an [L, N] (w8) or [L, N, K/32] (g32) stack.
  auto layer_scales = [&](const void* base, int l, int N,
                          int K) -> const void* {
    if (g32)
      return static_cast<const __half*>(base) +
             static_cast<size_t>(l) * N * (K / 32);
    return static_cast<const float*>(base) + static_cast<size_t>(l) * N;
  };
  const __nv_bfloat16* KC = static_cast<const __nv_bfloat16*>(kc);
  const __nv_bfloat16* VC = static_cast<const __nv_bfloat16*>(vc);
  __nv_bfloat16* KN = static_cast<__nv_bfloat16*>(kn);
  __nv_bfloat16* VN = static_cast<__nv_bfloat16*>(vn);

  cudaMemcpyAsync(X, x, sizeof(float) * static_cast<size_t>(B) * D,
                  cudaMemcpyDeviceToDevice, st);
  const size_t cache_layer = static_cast<size_t>(Bc) * n_kv * S * hd;
  const size_t new_layer = static_cast<size_t>(B) * n_kv * hd;
  for (int l = 0; l < L; ++l) {
    row_quant(X, D, D, an + static_cast<size_t>(l) * D, nullptr, eps,
              kQuantNorm, B, xq, sx, xb, st);
    if (bf16)
      gemv_bf(wqkv, wqkv_b, wqkv_c, qa, qb, l, nullptr, qkv, nqkv, D);
    else
      gemv(wlayer(wqkv, l, nqkv, D), layer_scales(sqkv, l, nqkv, D), nullptr,
           qkv, nqkv, D);
    const float* cs = static_cast<const float*>(cosv);
    const float* sn = static_cast<const float*>(sinv);
    const int* of = static_cast<const int*>(offs);
    const dim3 grid(n_heads, B);
    if (!kv_kernel) {
      attn_step_kernel<<<grid, kAttnThreads, smem, st>>>(
          qkv, cs, sn, rope_stride, of, off0, spec, KC + l * cache_layer,
          VC + l * cache_layer, KN + l * new_layer, VN + l * new_layer, att, S,
          window, ring_head, ring_size, n_heads, n_kv, hd, scale);
    } else if (kv8) {
      const size_t scale_layer = static_cast<size_t>(Bc) * n_kv * S;
      attn_kv_kernel<true><<<grid, kAttnThreads, smem, st>>>(
          qkv, cs, sn, rope_stride, of, off0, Bc, spec,
          static_cast<const int8_t*>(kc) + l * cache_layer,
          static_cast<const int8_t*>(vc) + l * cache_layer,
          static_cast<const float*>(k_scales) + l * scale_layer,
          static_cast<const float*>(v_scales) + l * scale_layer,
          KN + l * new_layer, VN + l * new_layer, att, S, window, ring_head,
          ring_size, chunk, n_heads, n_kv, hd, scale);
    } else {
      attn_kv_kernel<false><<<grid, kAttnThreads, smem, st>>>(
          qkv, cs, sn, rope_stride, of, off0, Bc, spec, KC + l * cache_layer,
          VC + l * cache_layer, nullptr, nullptr, KN + l * new_layer,
          VN + l * new_layer, att, S, window, ring_head, ring_size, chunk,
          n_heads, n_kv, hd, scale);
    }
    row_quant(att, nq, nq, nullptr, nullptr, eps, kQuantPlain, B, xq, sx, xb,
              st);
    if (bf16)
      gemv_bf(wo, nullptr, nullptr, D, 0, l, X, X, D, nq);
    else
      gemv(wlayer(wo, l, D, nq), layer_scales(so, l, D, nq), X, X, D, nq);
    row_quant(X, D, D, fn + static_cast<size_t>(l) * D,
              av + static_cast<size_t>(l) * D, eps, kQuantNorm, B, xq, sx, xb,
              st);
    if (bf16)
      gemv_bf(w13, w13_b, nullptr, fa, 2 * F - fa, l, nullptr, up, 2 * F, D);
    else
      gemv(wlayer(w13, l, 2 * F, D), layer_scales(s13, l, 2 * F, D), nullptr,
           up, 2 * F, D);
    row_quant(up, 2 * F, F, nullptr, nullptr, eps, kQuantSwiglu, B, xq, sx, xb,
              st);
    if (bf16)
      gemv_bf(w2, nullptr, nullptr, D, 0, l, X, X, D, F);
    else
      gemv(wlayer(w2, l, D, F), layer_scales(s2, l, D, F), X, X, D, F);
  }
  if (lm_codes != nullptr) {
    row_quant(X, D, D, static_cast<const float*>(final_norm), nullptr, eps,
              kQuantNorm, B, xq, sx, xb, st);
    if (lm_argmax)  // mode (i): the greedy token, no logits written
      launch_w8_argmax(xq, sx, static_cast<const int8_t*>(lm_codes),
                       static_cast<const float*>(lm_scale), B, V, D,
                       static_cast<float*>(tmax_buf),
                       static_cast<int*>(tidx_buf), nullptr,
                       static_cast<int*>(token), st);
    else if (bf16)
      gemv_bf(lm_codes, nullptr, nullptr, V, 0, 0, nullptr,
              static_cast<float*>(logits), V, D);
    else
      gemv(lm_codes, lm_scale, nullptr, static_cast<float*>(logits), V, D);
  }
  return static_cast<int>(cudaGetLastError());
}
