// The attention block of one decode step over a bf16 head-major cache,
// shared by K1 (decode_step.cu: modes (a)-(d), the bf16 cache) and K4
// (decode_tp.cu: the attention half of a tensor-parallel shard, which
// runs it over the shard's local heads with n_heads / n_kv of the
// shard).  Internal linkage: each translation unit has its own copy.
// See decode_step.cu for the rounding points the block shares with the
// plain versions.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

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

}  // namespace
}  // namespace vx
