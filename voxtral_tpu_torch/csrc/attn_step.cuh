// The attention blocks of one decode step over a head-major cache,
// shared by K1 (decode_step.cu) and K4 (decode_tp.cu: the attention half
// of a tensor-parallel shard, which runs them over the shard's local
// heads with n_heads / n_kv of the shard): attn_step_kernel for a bf16
// cache read at once (modes (a)-(d)), attn_kv_kernel for an int8 cache
// and / or a chunked walk (modes (e), (f), each with (b)-(d) as JAX
// allows).  Internal linkage: each translation unit has its own copy.
// See decode_step.cu for the rounding points the blocks share with the
// plain versions.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "decode_common.cuh"

namespace vx {
namespace {


// Mode (d): is head+ring cache slot ``slot`` visible to draft row j of a
// stream at offset ``off``?  Written (a head slot below the offset, or
// ring slot r < off - head; slots past head + size never are), and its
// absolute position within the window of the query at off + j.
__device__ __forceinline__ bool ring_visible(int slot, int off, int j,
                                             int window, int head, int size) {
  bool written;
  int p_abs;
  if (slot < head) {
    written = slot < off;
    p_abs = slot;
  } else {
    const int r = slot - head, wr = off - head;
    written = r < size && r < wr;
    p_abs = head + r + size * (max(wr - 1 - r, 0) / size);
  }
  return written && (window < 0 || off + j - p_abs <= window);
}

// One block per (query head h, row r); kv head jh = h / G.  Row r is
// draft slot j = r % spec of stream b = r / spec (spec = 1: one row per
// stream, the sequential step).  qkv [B, nq + 2 nkv] f32 holds the
// un-roped projections of every row; the cache is head-major
// [Bc, n_kv, S, hd] bf16 for this layer, one row per stream.  The query
// of row r sits at position off + j, off = offs[b] (read on the device;
// offs == NULL: the scalar off0 for every stream).  It attends
//   * the cache slots [max(0, off + j - window), min(off, S));
//   * the fresh K/V of rows i < j of its stream (j - i <= window), k_i
//     RoPE'd with row i's vectors, in f32 (JAX: _make_stack_kernel's
//     spec branch);
//   * itself.
// cos / sin: row r's vectors at cosv + r * rope_stride (rope_stride 0:
// one [hd] pair for every row).  Scores: one thread per cache slot;
// fresh scores: one warp per fresh row; P.V: one warp per slot (strided
// over the warps), a lane per pair of head dims, one coalesced row load
// per slot.  Dynamic shared memory: the per-warp P.V partial sums
// (nw x hd doubles), q (scaled f32 and its bf16 rounding), k, v, the
// spec fresh scores / weights and up to ``span`` cache scores / softmax
// weights (span = the most slots a row can see, sized on the host from
// S and the window, so no host offset is needed; S in mode (d), whose
// walk covers every slot and skips the invisible ones).
__global__ void __launch_bounds__(kAttnThreads) attn_step_kernel(
    const float* __restrict__ qkv, const float* __restrict__ cosv,
    const float* __restrict__ sinv, int rope_stride,
    const int* __restrict__ offs, int off0, int spec,
    const __nv_bfloat16* __restrict__ kc, const __nv_bfloat16* __restrict__ vc,
    __nv_bfloat16* __restrict__ kn, __nv_bfloat16* __restrict__ vn,
    float* __restrict__ attn, int S, int window, int ring_head,
    int ring_size, int n_heads, int n_kv, int hd, float scale) {
  extern __shared__ double smem_d[];
  __shared__ float red[32];
  __shared__ double red_d[32];
  __shared__ float self_sh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = nt >> 5;
  double* part = smem_d;                                 // [nw * hd]
  float* qf = reinterpret_cast<float*>(smem_d + nw * hd);  // [hd] scaled q
  float* qb = qf + hd;                                   // [hd] bf16(q)
  float* kf = qb + hd;                                   // [hd] roped k
  float* vf = kf + hd;                                   // [hd] v
  float* fs = vf + hd;                                   // [spec] fresh
  float* sc = fs + spec;                                 // [span]
  const int h = blockIdx.x, r = blockIdx.y;
  const int b = r / spec, j = r - b * spec;
  const int G = n_heads / n_kv, jh = h / G;
  const int nq = n_heads * hd, nkv = n_kv * hd, ld = nq + 2 * nkv;
  const int off = offs != nullptr ? offs[b] : off0;
  const bool ring = ring_size > 0;
  const int lo = ring ? 0 : (window >= 0 ? max(0, off + j - window) : 0);
  const int n = ring ? S : max(min(off, S) - lo, 0);
  auto visible = [&](int t) {
    return !ring ||
           ring_visible(lo + t, off, j, window, ring_head, ring_size);
  };
  rope_row(qkv, cosv, sinv, rope_stride, r, h, jh, G, n_heads, n_kv, hd, scale,
           qf, qb, kf, vf, kn, vn);
  __syncthreads();

  const size_t head = (static_cast<size_t>(b) * n_kv + jh) * S;
  const __nv_bfloat16* kbase = kc + head * hd;
  const __nv_bfloat16* vbase = vc + head * hd;
  // Cache scores: bf16(q) . k over slots lo..lo+n-1, f64 sums; -inf for
  // a slot the ring mask hides (weight 0, never loaded).
  for (int t = tid; t < n; t += nt) {
    if (!visible(t)) {
      sc[t] = -INFINITY;
      continue;
    }
    const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(
        kbase + static_cast<size_t>(lo + t) * hd);
    double p = 0.0;
#pragma unroll 8
    for (int d2 = 0; d2 < hd / 2; ++d2) {
      const float2 kv = __bfloat1622float2(kr[d2]);
      p += static_cast<double>(qb[2 * d2]) * kv.x;
      p += static_cast<double>(qb[2 * d2 + 1]) * kv.y;
    }
    sc[t] = static_cast<float>(p);
  }
  // Fresh scores: the unrounded f32 q against k_i of rows i < j, RoPE'd
  // with row i's vectors; -inf past the window (never weighted).
  for (int i = warp; i < j; i += nw) {
    const int ri = r - j + i;
    const float* ki = qkv + static_cast<size_t>(ri) * ld + nq +
                      static_cast<size_t>(jh) * hd;
    const float* ci = cosv + static_cast<size_t>(ri) * rope_stride;
    const float* si = sinv + static_cast<size_t>(ri) * rope_stride;
    double p = 0.0;
    for (int d = lane; d < hd; d += 32) {
      const float k = ki[d] * ci[d] + ki[d ^ 1] * si[d];
      p += static_cast<double>(qf[d]) * k;
    }
    p = warp_sum_d(p);
    if (lane == 0)
      fs[i] = (window < 0 || j - i <= window) ? static_cast<float>(p)
                                              : -INFINITY;
  }
  // Self score: the unrounded f32 q and k.
  if (warp == 0) {
    double p = 0.0;
    for (int d = lane; d < hd; d += 32)
      p += static_cast<double>(qf[d]) * kf[d];
    p = warp_sum_d(p);
    if (lane == 0) self_sh = static_cast<float>(p);
  }
  __syncthreads();
  // Softmax: f32 max over cache, self and fresh scores; f64 sum of the
  // cache weights, then the fresh weights and the self weight added in
  // f32 in that order; bf16 cache weights for P.V.
  const float self_s = self_sh;
  float m = self_s;
  for (int t = tid; t < n; t += nt) m = fmaxf(m, sc[t]);
  for (int i = tid; i < j; i += nt) m = fmaxf(m, fs[i]);
  m = block_max(m, red);
  double s = 0.0;
  for (int t = tid; t < n; t += nt) {
    const float e = expf(sc[t] - m);
    s += e;
    sc[t] = round_bf16(e);
  }
  s = block_sum_d(s, red_d);  // its barriers order the fs reads above
  for (int i = tid; i < j; i += nt) fs[i] = expf(fs[i] - m);  // e_i
  __syncthreads();
  auto fresh = [&](int i) { return window < 0 || j - i <= window; };
  const float e_self = expf(self_s - m);
  float den = static_cast<float>(s);
  for (int i = 0; i < j; ++i)
    if (fresh(i)) den = den + fs[i];
  den = den + e_self;
  // P.V over the cache (bf16 weights x bf16 v, f64 sums), then the
  // fresh terms e_i * v_i and the self term, in f32.
  constexpr int kPairs = kMaxHeadDim / 64;  // bf16 pairs per lane
  double acc2[kPairs][2];
#pragma unroll
  for (int c = 0; c < kPairs; ++c) acc2[c][0] = acc2[c][1] = 0.0;
#pragma unroll 4
  for (int t = warp; t < n; t += nw) {
    if (!visible(t)) continue;  // weight 0: adds nothing
    const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(
        vbase + static_cast<size_t>(lo + t) * hd);
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
  for (int d = tid; d < hd; d += nt) {
    double acc = 0.0;
    for (int wi = 0; wi < nw; ++wi) acc += part[wi * hd + d];
    float ctx = static_cast<float>(acc);
    for (int i = 0; i < j; ++i) {
      if (!fresh(i)) continue;
      const float vi = qkv[static_cast<size_t>(r - j + i) * ld + nq + nkv +
                           static_cast<size_t>(jh) * hd + d];
      ctx = ctx + fs[i] * vi;
    }
    ctx = ctx + e_self * vf[d];
    attn[static_cast<size_t>(r) * nq + static_cast<size_t>(h) * hd + d] =
        ctx / den;
  }
}

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
