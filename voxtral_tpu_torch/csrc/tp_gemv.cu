// The linears of K4 and K5 (decode_tp.cu): one GEMV of a tensor-parallel
// half over activation rows that still need their int8 quantization, as
// one or two links of the half's chain of programmatic dependent
// launches.
//
// A shard's linears are narrow (at tp = 2 and full width: wqkv_l 3072 x
// 3072, wo_l 3072 x 2048, w13_l 9216 x 3072, w2_l 3072 x 4608), a few
// microseconds of weights each, so each launch boundary costs about as
// much as the GEMV.  Each linear is, by plan (ops/decode_tp.py::
// tp_gemv_plan, from benches/torch_tp_times.py --plans on the H100):
//
//  * ``row``: row_quant (decode_common.cuh, one block a row) and a GEMV
//    over its codes: up to 8 rows the dp4a GEMVs of w8_common.cuh with
//    their first 16-byte weight pieces in registers before pdl_wait (one
//    weight row a warp, or two in w8 up to 2 rows), or in w8 the split-K
//    tensor-core GEMV (``mma``: four warps on 8 output rows, K split over
//    them); past 8 rows launch_w8_gemv / launch_g32_gemv's choice;
//  * ``gated`` (K5's w13, w8 up to 8 rows, g32 up to 4): the row route
//    whose GEMV puts the SwiGLU in its epilogue, a warp on a gate row
//    and its up row, so it writes h = quant_swiglu(g, u), half the
//    floats, and w2's row is quantized with no gate (row_quant's plain
//    mode, or fused);
//  * ``fused`` (w8, one row, no norm or gate: K4's wo, K5's w2 after a
//    gated w13): the GEMV forms the row's codes itself.  Its blocks load
//    their weights before pdl_wait, so they stream while the attention or
//    w13 runs; after the wait each block reads the f32 row (8-18 KB from
//    L2) into registers and forms row_quant's scale and codes
//    (quant_scale, quant_code; the max is order-free, so the codes equal
//    the row kernel's bit for bit) in shared memory.  Measured on the
//    H100 (PERF.md), this beats the row launch there and loses
//    everywhere else: where a norm comes first, at more rows, or on
//    w13's 9216 rows, every block repeating the row's work costs more
//    than the launch it saves.
//
// Plan bits (tp_linear's ``plan``): 1 fused, 2 two weight rows a warp
// (w8, up to 2 rows), 4 the mma route (w8), 8 the linear's first launch
// (the fused GEMV or the row kernel) goes ahead of its predecessor, 16 the
// GEMV after a row kernel goes ahead of it, 32 gated (read by
// tp_swiglu_fits).  A plan the shape cannot take falls back to the row
// route.  The int32 sums are exact and the g32 f64 sums keep
// g32_row_dots' order, so every plan gives the same bits.
#include <cuda_fp16.h>
#include <math.h>

#include "decode_common.cuh"
#include "w8_common.cuh"

namespace vx {
namespace {

constexpr int kTpThreads = 256;    // 8 warps a block
constexpr int kTpAhead = 8;        // pieces a lane loads early, R = 1
constexpr int kTpAheadPair = 4;    // the same, R = 2
constexpr int kTpFusedK = 4608;    // the widest row a fused block holds
constexpr int kTpRegs = kTpFusedK / kTpThreads;  // its values a thread
constexpr int kPlanFused = 1, kPlanPair = 2, kPlanMma = 4;
constexpr int kPlanAhead = 8, kPlanGemvAhead = 16, kPlanSwiglu = 32;
constexpr int kTpG32 = 1;  // wfmt of g32 weights (0: w8), as decode_tp.cu's

// W8A8 GEMV over one row x [K] f32 that it quantizes itself (plain
// mode: the row's absmax), warp (block, w) on output rows n0 .. n0 + R -
// 1, lane pieces i = lane + 32 j of K / 16 (16 weights each), the codes
// from shared memory.  out[n] = (float(z) * sx) * scale[n].  K <=
// kTpFusedK, K % 16 == 0, x and codes 16-byte aligned.
//
// ``x`` is written by the predecessor, so it is no __restrict__ pointer:
// a restricted read-only load may be treated as invariant and hoisted
// above pdl_wait (measured on the H100: reads of the attention's output
// before the attention ended).
template <int R>
__global__ void __launch_bounds__(kTpThreads) tp_w8_gemv1_kernel(
    const float* x, const int8_t* __restrict__ codes,
    const float* __restrict__ scale, float* __restrict__ out, int N,
    int K) {
  __shared__ int4 xq_s4[kTpFusedK / 16];
  __shared__ float red[kTpThreads / 32];
  constexpr int PRE = R == 1 ? kTpAhead : kTpAheadPair;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nv = K >> 4;
  const int n0 = (blockIdx.x * (kTpThreads / 32) + warp) * R;
  const int8_t* w[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    w[r] = codes + static_cast<size_t>(n0 + r < N ? n0 + r : 0) * K;
  auto piece = [&](int r, int i) {
    return __ldg(reinterpret_cast<const int4*>(w[r]) + i);
  };
  const int4 zero = make_int4(0, 0, 0, 0);
  int4 pre[PRE][R];
#pragma unroll
  for (int j = 0; j < PRE; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * j;
      pre[j][r] = (n0 + r < N && i < nv) ? piece(r, i) : zero;
    }
  pdl_trigger();
  pdl_wait();
  // The row's codes: its values in registers, the absmax over the block,
  // then quant_code of each.
  float h[kTpRegs];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kTpRegs; ++j) {
    const int k = t + j * kTpThreads;
    h[j] = k < K ? x[k] : 0.0f;
    amax = fmaxf(amax, fabsf(h[j]));
  }
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  const float s =
      quant_scale(warp_max(lane < kTpThreads / 32 ? red[lane] : -INFINITY));
  int8_t* xq_s = reinterpret_cast<int8_t*>(xq_s4);
#pragma unroll
  for (int j = 0; j < kTpRegs; ++j) {
    const int k = t + j * kTpThreads;
    if (k < K) xq_s[k] = quant_code(h[j], s);
  }
  __syncthreads();
  if (n0 >= N) return;  // whole warps leave together
  int acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;
  auto dot = [&](const int4 (&wv)[R], int i) {
    const int4 xv = xq_s4[i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int a = acc[r];
      a = __dp4a(wv[r].x, xv.x, a);
      a = __dp4a(wv[r].y, xv.y, a);
      a = __dp4a(wv[r].z, xv.z, a);
      a = __dp4a(wv[r].w, xv.w, a);
      acc[r] = a;
    }
  };
#pragma unroll
  for (int j = 0; j < PRE; ++j)
    if (lane + 32 * j < nv) dot(pre[j], lane + 32 * j);
  for (int i = lane + 32 * PRE; i < nv; i += 32) {
    int4 wv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) wv[r] = n0 + r < N ? piece(r, i) : zero;
    dot(wv, i);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = warp_sum_int(acc[r]);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (n0 + r < N) out[n0 + r] = w8_epilogue(acc[r], s, scale[n0 + r]);
  }
}

// K5's w13 with the SwiGLU in its epilogue, over the codes row_quant
// wrote: warp (block, w) on gate row n = blockIdx.x 8 + w and up row n +
// F of codes [2F, K] (w13_l: the w1 rows, then the w3 rows), so
// out[m, n] = quant_swiglu(g, u) of the two outputs the GEMV would write,
// the same floats and operations as row_quant's swiglu mode over them:
// h [M, F] leaves the kernel and w2's row needs no gate.  w8: the dp4a
// dot of w8_gemv_kernel, each (g, u) = (float(z) * sx[m]) * scale; g32:
// g32_row_dots of each row, float(sum) * sx[m].  Each lane loads its
// first kTpAheadPair pieces of both rows before pdl_wait; xq and sx are
// read after it (plain loads: the predecessor writes them).
template <int M>
__global__ void __launch_bounds__(32 * kGemvWarps) tp_w8_swiglu_kernel(
    const int8_t* xq, const float* sx, const int8_t* __restrict__ codes,
    const float* __restrict__ scale, float* __restrict__ out, int F,
    int K) {
  constexpr int PRE = kTpAheadPair;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  const int nn = n < F ? n : 0;
  const int8_t* w[2] = {codes + static_cast<size_t>(nn) * K,
                        codes + static_cast<size_t>(nn + F) * K};
  const int nv = K >> 4;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4 pre[PRE][2];
#pragma unroll
  for (int j = 0; j < PRE; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = lane + 32 * j;
      pre[j][r] = i < nv ? __ldg(reinterpret_cast<const int4*>(w[r]) + i)
                         : zero;
    }
  pdl_trigger();
  pdl_wait();
  if (n >= F) return;  // whole warps leave together
  int acc[M][2];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m][0] = acc[m][1] = 0;
  auto dot = [&](const int4 (&wv)[2], int i) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int4 xv =
          reinterpret_cast<const int4*>(xq + static_cast<size_t>(m) * K)[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int a = acc[m][r];
        a = __dp4a(wv[r].x, xv.x, a);
        a = __dp4a(wv[r].y, xv.y, a);
        a = __dp4a(wv[r].z, xv.z, a);
        a = __dp4a(wv[r].w, xv.w, a);
        acc[m][r] = a;
      }
    }
  };
#pragma unroll
  for (int j = 0; j < PRE; ++j)
    if (lane + 32 * j < nv) dot(pre[j], lane + 32 * j);
  for (int i = lane + 32 * PRE; i < nv; i += 32) {
    const int4 wv[2] = {__ldg(reinterpret_cast<const int4*>(w[0]) + i),
                        __ldg(reinterpret_cast<const int4*>(w[1]) + i)};
    dot(wv, i);
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) acc[m][r] = warp_sum_int(acc[m][r]);
  if (lane == 0) {
    const float sg = scale[n], su = scale[n + F];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float s = sx[m];
      out[static_cast<size_t>(m) * F + n] = quant_swiglu(
          w8_epilogue(acc[m][0], s, sg), w8_epilogue(acc[m][1], s, su));
    }
  }
}

template <int M>
__global__ void __launch_bounds__(32 * kGemvWarps) tp_g32_swiglu_kernel(
    const int8_t* xq, const float* sx, const int8_t* __restrict__ codes,
    const __half* __restrict__ gscale, float* __restrict__ out, int F,
    int K) {
  constexpr int PRE = kTpAheadPair;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  const int nn = n < F ? n : 0;
  int4 pg[PRE], pu[PRE];
  double sg[PRE], su[PRE];
  g32_preload<PRE>(codes, gscale, nn, K, lane, pg, sg);
  g32_preload<PRE>(codes, gscale, nn + F, K, lane, pu, su);
  pdl_trigger();
  pdl_wait();
  if (n >= F) return;  // whole warps leave together
  // g32_row_dots for the gate and the up row at once: each row's group
  // dots, scales and f64 sums in g32_row_dots' order.
  const int4* wg =
      reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K);
  const int4* wu =
      reinterpret_cast<const int4*>(codes + static_cast<size_t>(n + F) * K);
  const __half* rg = gscale + static_cast<size_t>(n) * (K / 32);
  const __half* ru = gscale + static_cast<size_t>(n + F) * (K / 32);
  const int4 zero = make_int4(0, 0, 0, 0);
  const int nv = K >> 4;
  double ag[M], au[M];
#pragma unroll
  for (int m = 0; m < M; ++m) ag[m] = au[m] = 0.0;
  auto group = [&](const int4 w, const int4 x) {
    int a = 0;
    a = __dp4a(w.x, x.x, a);
    a = __dp4a(w.y, x.y, a);
    a = __dp4a(w.z, x.z, a);
    a = __dp4a(w.w, x.w, a);
    return a + __shfl_xor_sync(0xffffffffu, a, 1);  // the group's dot
  };
  auto step = [&](int base, const int4 g4, const double gs, const int4 u4,
                  const double us) {
    const int i = base + lane;
    const bool in = i < nv;  // nv is even: both lanes of a group agree
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int4 xv =
          in ? reinterpret_cast<const int4*>(xq + static_cast<size_t>(m) * K)[i]
             : zero;
      const int a = group(g4, xv), b = group(u4, xv);
      if ((lane & 1) == 0) {
        ag[m] += static_cast<double>(a) * gs;
        au[m] += static_cast<double>(b) * us;
      }
    }
  };
#pragma unroll
  for (int j = 0; j < PRE; ++j)
    if (32 * j < nv) step(32 * j, pg[j], sg[j], pu[j], su[j]);
  for (int base = 32 * PRE; base < nv; base += 32) {
    const int i = base + lane;
    const bool in = i < nv;
    step(base, in ? __ldg(wg + i) : zero,
         in ? static_cast<double>(__half2float(rg[i >> 1])) : 0.0,
         in ? __ldg(wu + i) : zero,
         in ? static_cast<double>(__half2float(ru[i >> 1])) : 0.0);
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    ag[m] = warp_sum_f64(ag[m]);
    au[m] = warp_sum_f64(au[m]);
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float s = sx[m];
      out[static_cast<size_t>(m) * F + n] =
          quant_swiglu(static_cast<float>(ag[m]) * s,
                       static_cast<float>(au[m]) * s);
    }
  }
}

}  // namespace

// Whether tp_linear runs a linear as K5's w13 with the SwiGLU in its
// epilogue (plan bit kPlanSwiglu, w8 up to 8 rows, g32 up to 4; codes
// [2F, K]): its output is then h [M, F], not the [M, 2F] GEMV.
bool tp_swiglu_fits(int wfmt, int plan, int M, int K, const void* codes,
                    const void* xq) {
  return (plan & kPlanSwiglu) && M >= 1 && M <= kDp4aMaxM && K % 16 == 0 &&
         (wfmt != kTpG32 || (K % 32 == 0 && M <= 4)) && aligned16(codes) &&
         aligned16(xq);
}

namespace {

// The row route's GEMV over the codes row_quant wrote: up to 8 rows the
// dp4a GEMVs loading their first weights before pdl_wait (two weight
// rows a warp up to 2 rows when ``pair``, w8), or the mma route (w8);
// else launch_w8_gemv / launch_g32_gemv's choice.
cudaError_t row_gemv(int wfmt, int plan, bool gated, const int8_t* xq,
                     const float* sx, const int8_t* codes, const void* scale,
                     float* out, int M, int N, int K, cudaStream_t st,
                     bool pdl) {
  const bool vec = K % 16 == 0 && aligned16(xq) && aligned16(codes);
  const bool g32 = wfmt == kTpG32;
  const float* sc = static_cast<const float*>(scale);
  const __half* gs = static_cast<const __half*>(scale);
  const dim3 block(32 * kGemvWarps);
  const dim3 grid1((N + kGemvWarps - 1) / kGemvWarps);
  if (gated) {
    const int F = N / 2;
    const dim3 gridf((F + kGemvWarps - 1) / kGemvWarps);
    switch (M) {
#define VX_SWIGLU(MM)                                                     \
  case MM:                                                                \
    if (g32) {                                                            \
      if constexpr (MM <= 4)                                              \
        return launch_pdl(tp_g32_swiglu_kernel<MM>, gridf, block, 0, st,  \
                          pdl, xq, sx, codes, gs, out, F, K);             \
      else                                                                \
        return cudaErrorInvalidValue;                                     \
    }                                                                     \
    return launch_pdl(tp_w8_swiglu_kernel<MM>, gridf, block, 0, st, pdl,  \
                      xq, sx, codes, sc, out, F, K);
      VX_SWIGLU(1)
      VX_SWIGLU(2)
      VX_SWIGLU(3)
      VX_SWIGLU(4)
      VX_SWIGLU(5)
      VX_SWIGLU(6)
      VX_SWIGLU(7)
      VX_SWIGLU(8)
#undef VX_SWIGLU
      default:
        return cudaErrorInvalidValue;
    }
  }
  if ((plan & kPlanMma) && !g32 && vec && K % 64 == 0 && M <= 16)
    return launch_pdl(w8_gemv_mma_kernel<1>, dim3((N + 7) / 8),
                      dim3(32 * kMmaSplit), 0, st, pdl, xq, sx, codes, sc,
                      nullptr, out, M, N, K);
  if (M > kDp4aMaxM || !vec) {
    if (g32) return launch_g32_gemv(xq, sx, codes, gs, nullptr, out, M, N, K,
                                    st, pdl);
    return launch_w8_gemv(xq, sx, codes, sc, nullptr, out, M, N, K, st, pdl);
  }
  const dim3 grid2((N + 2 * kGemvWarps - 1) / (2 * kGemvWarps));
  const bool pair = (plan & kPlanPair) && !g32 && M <= 2;
  switch (M) {
#define VX_ROW_GEMV(MM)                                                      \
  case MM:                                                                   \
    if (g32)                                                                 \
      return launch_pdl(g32_gemv_kernel<MM, (MM <= 4 ? kTpAhead : 0)>,       \
                        grid1, block, 0, st, pdl, xq, sx, codes, gs,         \
                        nullptr, out, N, K);                                 \
    if constexpr (MM <= 2) {                                                 \
      if (pair)                                                              \
        return launch_pdl(w8_gemv_kernel<MM, kTpAheadPair, 2>, grid2, block, \
                          0, st, pdl, xq, sx, codes, sc, nullptr, out, N, K, \
                          true);                                             \
    }                                                                        \
    return launch_pdl(w8_gemv_kernel<MM, kTpAhead, 1>, grid1, block, 0, st,  \
                      pdl, xq, sx, codes, sc, nullptr, out, N, K, true);
    VX_ROW_GEMV(1)
    VX_ROW_GEMV(2)
    VX_ROW_GEMV(3)
    VX_ROW_GEMV(4)
    VX_ROW_GEMV(5)
    VX_ROW_GEMV(6)
    VX_ROW_GEMV(7)
    VX_ROW_GEMV(8)
#undef VX_ROW_GEMV
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One linear of K4 / K5: the rows x [M, ldx] f32 quantized in mode qm
// over K columns (norm weights w, ADA vector ada or null, eps), times
// codes [N, K] int8 with f32 row scales [N] (wfmt 0, w8) or f16 group
// scales [N, K/32] (1, g32), into out [M, N] f32, or with ``gated`` (K5's
// w13, where tp_swiglu_fits) the SwiGLU of its two halves into out
// [M, N / 2].  xq [M, K] / sx [M]: scratch for the row route.  ``plan``:
// the bits above; ``pdl`` false: every launch in plain stream order,
// whatever the plan.
cudaError_t tp_linear(int wfmt, int plan, int qm, const float* x, int ldx,
                      int K, const float* w, const float* ada, float eps,
                      int8_t* xq, float* sx, const int8_t* codes,
                      const void* scale, float* out, int M, int N,
                      bool gated, cudaStream_t st, bool pdl) {
  const bool ahead = pdl && (plan & kPlanAhead);
  if (!gated && (plan & kPlanFused) && wfmt != kTpG32 &&
      qm == kQuantPlain && M == 1 &&
      K % 16 == 0 && K <= kTpFusedK && aligned16(x) && aligned16(codes)) {
    const float* sc = static_cast<const float*>(scale);
    const dim3 block(kTpThreads);
    if (plan & kPlanPair)
      return launch_pdl(tp_w8_gemv1_kernel<2>,
                        dim3((N + 2 * (kTpThreads / 32) - 1) /
                             (2 * (kTpThreads / 32))),
                        block, 0, st, ahead, x, codes, sc, out, N, K);
    return launch_pdl(tp_w8_gemv1_kernel<1>,
                      dim3((N + kTpThreads / 32 - 1) / (kTpThreads / 32)),
                      block, 0, st, ahead, x, codes, sc, out, N, K);
  }
  const cudaError_t e =
      row_quant(x, ldx, K, w, ada, eps, qm, M, xq, sx, nullptr, st, ahead);
  if (e != cudaSuccess) return e;
  return row_gemv(wfmt, plan, gated, xq, sx, codes, scale, out, M, N, K, st,
                  pdl && (plan & kPlanGemvAhead));
}

}  // namespace vx
