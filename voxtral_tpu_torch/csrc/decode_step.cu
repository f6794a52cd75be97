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
// then row_quant(final norm) and the lm_head GEMV.  9 launches per layer
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

#include "w8_common.cuh"

namespace vx {
namespace {

enum QuantMode { kQuantPlain = 0, kQuantNorm = 1, kQuantSwiglu = 2 };

constexpr int kQuantThreads = 1024;
constexpr int kAttnThreads = 256;
constexpr int kMaxHeadDim = 256;  // P.V: up to 4 bf16 pairs per lane

__device__ __forceinline__ double warp_sum_d(double v) {
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

// One block per row b: h = f(x[b]) of width K, then xq[b] = int8 codes,
// sx[b] = max(absmax(h), 1e-8) / 127 with round-half-even of h / sx.
//   kQuantPlain:  h = x
//   kQuantNorm:   h = (x * (1 / sqrt(mean(x^2) + eps))) * w   (* ada),
//                 mean(x^2) summed in f64
//   kQuantSwiglu: h = (g * sigmoid(g)) * u, g = x[:K], u = x[K:2K]
// h is recomputed in each pass (the same operations, the same values).
__global__ void __launch_bounds__(kQuantThreads) row_quant_kernel(
    const float* __restrict__ x, int ldx, int K, const float* __restrict__ w,
    const float* __restrict__ ada, float eps, int mode,
    int8_t* __restrict__ xq, float* __restrict__ sx) {
  __shared__ float red[32];
  __shared__ double red_d[32];
  const int b = blockIdx.x;
  const float* xr = x + static_cast<size_t>(b) * ldx;
  float inv = 1.0f;
  if (mode == kQuantNorm) {
    double ss = 0.0;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const double v = xr[k];
      ss += v * v;
    }
    ss = block_sum_d(ss, red_d);
    const float var = static_cast<float>(ss / static_cast<double>(K));
    inv = 1.0f / sqrtf(var + eps);
  }
  auto value = [&](int k) -> float {
    if (mode == kQuantNorm) {
      float h = (xr[k] * inv) * w[k];
      if (ada != nullptr) h = h * ada[k];
      return h;
    }
    if (mode == kQuantSwiglu) {
      const float g = xr[k];
      const float sig = 1.0f / (1.0f + expf(-g));
      return (g * sig) * xr[K + k];
    }
    return xr[k];
  };
  float amax = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    amax = fmaxf(amax, fabsf(value(k)));
  amax = block_max(amax, red);
  const float s = fmaxf(amax, 1e-8f) / 127.0f;
  int8_t* q = xq + static_cast<size_t>(b) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float c = fminf(fmaxf(rintf(value(k) / s), -127.0f), 127.0f);
    q[k] = static_cast<int8_t>(c);
  }
  if (threadIdx.x == 0) sx[b] = s;
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
  const float* row = qkv + static_cast<size_t>(r) * ld;
  const float* qh = row + static_cast<size_t>(h) * hd;
  const float* kh = row + nq + static_cast<size_t>(jh) * hd;
  const float* vh = row + nq + nkv + static_cast<size_t>(jh) * hd;
  const float* cr = cosv + static_cast<size_t>(r) * rope_stride;
  const float* sr = sinv + static_cast<size_t>(r) * rope_stride;
  const size_t kvo = (static_cast<size_t>(r) * n_kv + jh) * hd;
  for (int d = tid; d < hd; d += nt) {
    const float q = (qh[d] * cr[d] + qh[d ^ 1] * sr[d]) * scale;
    qf[d] = q;
    qb[d] = round_bf16(q);
    const float k = kh[d] * cr[d] + kh[d ^ 1] * sr[d];
    kf[d] = k;
    vf[d] = vh[d];
    if (h % G == 0) {  // one writer per kv head
      kn[kvo + d] = __float2bfloat16(k);
      vn[kvo + d] = __float2bfloat16(vh[d]);
    }
  }
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

inline void row_quant(const float* x, int ldx, int K, const float* w,
                      const float* ada, float eps, int mode, int B,
                      int8_t* xq, float* sx, cudaStream_t st) {
  row_quant_kernel<<<B, kQuantThreads, 0, st>>>(x, ldx, K, w, ada, eps, mode,
                                                xq, sx);
}

}  // namespace
}  // namespace vx

// All pointers are device pointers; lm_codes == NULL skips the lm fold.
// B rows = Bc streams x spec draft rows, ordered (stream, slot).
// Layouts: x, xo [B, D] f32; norms / ada [L, D] f32; scales [L, N] f32
// (g32: [L, N, K/32] f16, lm_scale [V, D/32] f16);
// cos / sin [hd] (rope_stride 0) or [B, hd] (rope_stride hd) f32,
// pair-expanded; offs [Bc] int32 or NULL (then off0 for every stream);
// caches [L, Bc, n_kv, S, hd] bf16; wqkv [L, nq + 2 nkv, D], wo [L, D, nq],
// w13 [L, 2F, D], w2 [L, D, F] int8; lm_codes [V, D] int8, lm_scale [V]
// f32; kn / vn [L, B, n_kv, hd] bf16; logits [B, V] f32.  Scratch:
// xq [B, max(D, nq, F)] int8, sx [B], qkv [B, nq + 2 nkv], attn [B, nq],
// up [B, 2F] f32.  window < 0: no lower bound.  ring_size > 0: mode (d),
// the caches are head+ring buffers of ring_head + ring_size <= S slots
// and the offsets absolute positions.  The host reads no offset: a pass
// launches without a device-to-host copy.
extern "C" int vx_decode_stack_step(
    const void* x, void* xo, const void* attn_norms, const void* ffn_norms,
    const void* ada, const void* sqkv, const void* so, const void* s13,
    const void* s2, const void* cosv, const void* sinv, const void* kc,
    const void* vc, const void* wqkv, const void* wo, const void* w13,
    const void* w2, const void* final_norm, const void* lm_codes,
    const void* lm_scale, void* kn, void* vn, void* logits, void* xq_buf,
    void* sx_buf, void* qkv_buf, void* attn_buf, void* up_buf,
    const void* offs, int B, int D, int L, int S, int n_heads, int n_kv,
    int hd, int F, int V, int off0, int spec, int rope_stride, int window,
    int g32, int ring_head, int ring_size, float eps, float scale,
    void* stream) {
  using namespace vx;
  const bool ring = ring_size > 0;
  if (hd > kMaxHeadDim || hd % 2 || n_kv <= 0 || n_heads % n_kv ||
      spec < 1 || B % spec ||
      (offs == nullptr && (off0 < 0 || (!ring && off0 > S))) ||
      (ring && (ring_head < 0 || ring_head + ring_size > S)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g32 && (D % 32 || (n_heads * hd) % 32 || F % 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = n_heads * hd, nkv = n_kv * hd, nqkv = nq + 2 * nkv;
  const int Bc = B / spec;
  const int span = (!ring && window >= 0 && window < S) ? window : S;
  const size_t smem =
      sizeof(double) * (kAttnThreads / 32) * hd +
      sizeof(float) * (4 * static_cast<size_t>(hd) + spec + span);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  float* X = static_cast<float*>(xo);
  int8_t* xq = static_cast<int8_t*>(xq_buf);
  float* sx = static_cast<float*>(sx_buf);
  float* qkv = static_cast<float*>(qkv_buf);
  float* att = static_cast<float*>(attn_buf);
  float* up = static_cast<float*>(up_buf);
  const float* an = static_cast<const float*>(attn_norms);
  const float* fn = static_cast<const float*>(ffn_norms);
  const float* av = static_cast<const float*>(ada);
  const int8_t* Wqkv = static_cast<const int8_t*>(wqkv);
  const int8_t* Wo = static_cast<const int8_t*>(wo);
  const int8_t* W13 = static_cast<const int8_t*>(w13);
  const int8_t* W2 = static_cast<const int8_t*>(w2);
  // One linear of the step on the rows quantized in xq / sx: W8A8 (row
  // scales [N] f32) or g32 (group scales [N, K/32] f16, mode (h)).
  auto gemv = [&](const int8_t* W, const void* Sc, const float* resid,
                  float* out, int N, int K) {
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
              kQuantNorm, B, xq, sx, st);
    gemv(Wqkv + static_cast<size_t>(l) * nqkv * D,
         layer_scales(sqkv, l, nqkv, D), nullptr, qkv, nqkv, D);
    attn_step_kernel<<<dim3(n_heads, B), kAttnThreads, smem, st>>>(
        qkv, static_cast<const float*>(cosv), static_cast<const float*>(sinv),
        rope_stride, static_cast<const int*>(offs), off0, spec,
        KC + l * cache_layer, VC + l * cache_layer, KN + l * new_layer,
        VN + l * new_layer, att, S, window, ring_head, ring_size, n_heads,
        n_kv, hd, scale);
    row_quant(att, nq, nq, nullptr, nullptr, eps, kQuantPlain, B, xq, sx, st);
    gemv(Wo + static_cast<size_t>(l) * D * nq, layer_scales(so, l, D, nq), X,
         X, D, nq);
    row_quant(X, D, D, fn + static_cast<size_t>(l) * D,
              av + static_cast<size_t>(l) * D, eps, kQuantNorm, B, xq, sx, st);
    gemv(W13 + static_cast<size_t>(l) * 2 * F * D,
         layer_scales(s13, l, 2 * F, D), nullptr, up, 2 * F, D);
    row_quant(up, 2 * F, F, nullptr, nullptr, eps, kQuantSwiglu, B, xq, sx,
              st);
    gemv(W2 + static_cast<size_t>(l) * D * F, layer_scales(s2, l, D, F), X, X,
         D, F);
  }
  if (lm_codes != nullptr) {
    row_quant(X, D, D, static_cast<const float*>(final_norm), nullptr, eps,
              kQuantNorm, B, xq, sx, st);
    gemv(static_cast<const int8_t*>(lm_codes), lm_scale, nullptr,
         static_cast<float*>(logits), V, D);
  }
  return static_cast<int>(cudaGetLastError());
}
