// W8A8 product device code shared by K2 (w8_matmul.cu), K1
// (decode_step.cu), K4 / K5 (decode_tp.cu) and K7 (decode_layer.cu):
//
//   out[m, n] = (float(sum_k xq[m, k] * codes[n, k]) * sx[m]) * scale[n]
//               (+ resid[m, n])
//
// xq [M, K] int8, sx [M] f32, codes [N, K] int8 (row n = output n),
// scale [N] f32, out / resid [M, N] f32 row-major (resid may alias out).
// The integer sum is exact in int32 (|sum| <= K * 127^2 < 2^31 for
// K < 133000).  The epilogue multiplies in the order of the JAX
// reference (ops/w8.py, w8_pallas.py::_w8_kernel), so kernel and plain
// versions agree to the last bit.
//
// The GEMVs (K2 takes them up to 16 rows and where its tensor-core GEMM
// cannot take the shape, w8_matmul.cu; the decode steps for every row
// count they run):
//  * GEMV, M <= 8 (decode): one warp per output row n (or R rows),
//    16-byte loads of the weight row, __dp4a (four int8 products per
//    instruction); bound by the bytes of weights streamed from HBM.
//  * GEMV, 8 < M <= 64 (speculative decode: streams x K draft rows;
//    prefill): a block of four warps per 8 output rows, K split over the
//    warps, int8 tensor-core
//    mma.m16n8k32 over up to four 16-row tiles of activations, so ONE
//    pass over the weights serves all M rows.  At M = 64 a dp4a GEMV
//    would do 64 integer products per weight byte on the CUDA cores
//    (~3.7 ms of dp4a instructions per 3.4 GB decode step); the tensor cores
//    keep it a weight stream.
//  * Above 64 rows (or unaligned rows): the dp4a GEMV in groups of 8
//    rows, one weight pass per group.
//
// K1 mode (h) (q4g weights) runs the same GEMVs on group-32 codes: codes
// [N, K] int8 (the Q4_0 nibble - 8), f16 group scales [N, K/32], and
//
//   out[m, n] = (float(sum_g z_g[m, n] * s[n, g]) * sx[m]) (+ resid)
//
// with z_g the exact int32 dot over group g (32 k) and the sum over the
// groups in f64 (each z_g * s exact), rounded once: the order of the JAX
// kernel's _g32_matmul_tile (the group sum, then * sx).  Needs K % 32 == 0
// and 16-byte aligned rows.
// Everything here has internal linkage, so every translation unit may
// include it.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vx {
namespace {

constexpr int kGemvWarps = 8;   // output rows per 256-thread GEMV block
constexpr int kDp4aMaxM = 8;    // activation rows of the dp4a GEMV
constexpr int kGemvMaxM = 64;   // activation rows served by one weight pass
constexpr int kMmaWarps = 4;    // n8 tiles per 128-thread g32 mma GEMV block
constexpr int kMmaSplit = 4;    // K parts (warps) of the w8 mma GEMV block

// Programmatic dependent launch (sm_90).  A kernel launched with
// launch_pdl may start while its predecessor in the stream still runs:
// pdl_wait() returns once the predecessor has completed and its writes
// are visible (at once in a grid launched without the attribute), so
// everything a kernel reads or writes that a predecessor touches comes
// after it; pdl_trigger() lets the successor launch.  K1, K4 / K5 and
// K7 launch their chains this way (decode_step.cu, decode_tp.cu with
// tp_gemv.cu, decode_layer.cu); K2 launches plainly.  What a predecessor
// writes (activation rows, their scales, residuals) is read with plain
// loads through pointers that are not __restrict__, never with __ldg:
// the compiler may treat a read-only load as invariant over the kernel
// and hoist it above the wait (seen on the H100: a GEMV read the
// attention's output before the attention ended).  A loop that wants
// __ldg's read-only path takes its pointer from after_wait instead (the
// GEMVs here, the folds and K1's stream do).
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ``p`` as the output of an empty asm that stays after pdl_wait (both
// volatile, with memory clobbers): every load through the result, __ldg
// included, depends on it, so none is scheduled above the wait.  Call
// it after pdl_wait.
template <class T>
__device__ __forceinline__ const T* after_wait(const T* p) {
  unsigned long long v = reinterpret_cast<unsigned long long>(p);
  asm volatile("" : "+l"(v)::"memory");
  return reinterpret_cast<const T*>(v);
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launches kernel<<<grid, block, smem, st>>>(args...), with the
// programmatic-serialization attribute when ``pdl``.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t st, bool pdl,
                       Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float w8_epilogue(int acc, float sx, float sc) {
  return (static_cast<float>(acc) * sx) * sc;
}

// PRE > 0 (K1 and K7, launched ahead of their predecessor): the first
// PRE of the lane's 16-byte weight pieces come into registers before
// pdl_wait, so they stream while the previous launch ends.  R > 1 (K7 at
// 1 to 4 rows): each warp on R output rows, so every 16-byte piece of an
// activation row, loaded once, meets R weight rows and 1 / R of the
// blocks go out.  The int32 sums are exact, so neither the order of the
// pieces nor R moves a bit.
template <int M, int PRE = 0, int R = 1>
__global__ void __launch_bounds__(256) w8_gemv_kernel(
    const int8_t* xq, const float* sx,
    const int8_t* __restrict__ codes, const float* __restrict__ scale,
    const float* resid, float* out, int N, int K, bool vec) {
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kGemvWarps + (threadIdx.x >> 5)) * R;
  const int8_t* w[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    w[r] = codes + static_cast<size_t>(n0 + r < N ? n0 + r : 0) * K;
  auto piece = [&](int r, int i) {
    return __ldg(reinterpret_cast<const int4*>(w[r]) + i);
  };
  const int4 zero = make_int4(0, 0, 0, 0);
  const int nv = K >> 4;
  int4 pre[PRE > 0 ? PRE : 1][R];
  if constexpr (PRE > 0) {
#pragma unroll
    for (int j = 0; j < PRE; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + 32 * j;
        pre[j][r] = (vec && n0 + r < N && i < nv) ? piece(r, i) : zero;
      }
  }
  pdl_trigger();
  pdl_wait();
  xq = after_wait(xq);  // the __ldg loads of the rows stay after the wait
  if (n0 >= N) return;  // whole warps leave together
  int acc[M][R];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[m][r] = 0;
  // The dot of one 16-byte piece i (16 weights) of each weight row with
  // each activation row.
  auto dot = [&](const int4 (&wv)[R], int i) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int4 xv = __ldg(
          reinterpret_cast<const int4*>(xq + static_cast<size_t>(m) * K) + i);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int a = acc[m][r];
        a = __dp4a(wv[r].x, xv.x, a);
        a = __dp4a(wv[r].y, xv.y, a);
        a = __dp4a(wv[r].z, xv.z, a);
        a = __dp4a(wv[r].w, xv.w, a);
        acc[m][r] = a;
      }
    }
  };
  if (vec) {
    // K % 16 == 0 and 16-byte aligned rows: one int4 (16 weights) per
    // lane per iteration, neighbouring lanes on neighbouring addresses.
#pragma unroll
    for (int j = 0; j < PRE; ++j)
      if (lane + 32 * j < nv) dot(pre[j], lane + 32 * j);
    for (int i = lane + 32 * PRE; i < nv; i += 32) {
      int4 wv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) wv[r] = n0 + r < N ? piece(r, i) : zero;
      dot(wv, i);
    }
  } else {
    for (int k = lane; k < K; k += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int wv = n0 + r < N ? w[r][k] : 0;
#pragma unroll
        for (int m = 0; m < M; ++m)
          acc[m][r] += wv * static_cast<int>(xq[static_cast<size_t>(m) * K + k]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[m][r] = warp_sum_int(acc[m][r]);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r;
      if (n >= N) continue;
      const float sc = scale[n];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float y = w8_epilogue(acc[m][r], sx[m], sc);
        const size_t o = static_cast<size_t>(m) * N + n;
        if (resid != nullptr) y = resid[o] + y;
        out[o] = y;
      }
    }
  }
}

// D += A . B for one m16n8k32 int8 tile (exact int32 accumulation).
// a0..a3: the A fragment (rows g, g + 8; two groups of 4 K bytes),
// b0, b1: the B fragment (column g), as PTX lays them out for
// mma.m16n8k32 .s8 (g = lane / 4).
__device__ __forceinline__ void mma_s8(int (&d)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// GEMV over M <= 16 * MT activation rows: a block of kMmaSplit warps
// per 8 output rows n0..n0+7, each warp on its own 1 / kMmaSplit of K,
// so a 9-64 row step keeps four times the loads in flight and streams
// its weights about as fast as the dp4a GEMV streams one row's.  The K
// axis is walked in 64-byte steps; lane (g, t) (g = lane / 4, t = lane %
// 4) loads 16 bytes at k = 64 s + 16 t of weight row n0 + g and of
// activation rows 16 i + g and 16 i + g + 8, and feeds them to two
// m16n8k32 products.  Which real k a fragment slot holds only has to
// agree between A and B (a dot product is order-free), so each lane's 16
// contiguous bytes fill its two 4-byte slots of two products, and every
// weight byte is read once with a 16-byte load.  The warps' int32
// partials are added in shared memory; the sums are exact, so the result
// equals the dp4a paths' bit for bit.  Needs K % 64 == 0 and 16-byte
// aligned rows; rows past M read zeros and are not written.
template <int MT>
__global__ void __launch_bounds__(32 * kMmaSplit) w8_gemv_mma_kernel(
    const int8_t* xq, const float* sx,
    const int8_t* __restrict__ codes, const float* __restrict__ scale,
    const float* resid, float* out, int M, int N, int K) {
  __shared__ int part[kMmaSplit][MT * 4][32];
  pdl_trigger();
  pdl_wait();
  xq = after_wait(xq);
  const int lane = threadIdx.x & 31, kp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 8;
  const int n = n0 + g;
  const int4 zero = make_int4(0, 0, 0, 0);
  const int4* w4 = reinterpret_cast<const int4*>(
      codes + static_cast<size_t>(n < N ? n : N - 1) * K);
  const int4* x4[MT][2];
  bool xin[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * i + 8 * h + g;
      xin[i][h] = m < M;
      x4[i][h] = reinterpret_cast<const int4*>(
          xq + static_cast<size_t>(m < M ? m : 0) * K);
    }
  int acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0;
  const int steps = K >> 6;  // 64-byte steps of a row
  const int s0 = kp * steps / kMmaSplit, s1 = (kp + 1) * steps / kMmaSplit;
#pragma unroll 4
  for (int st = s0; st < s1; ++st) {  // the same trip count on every lane
    const int c = 4 * st + t;
    const int4 w = n < N ? __ldg(w4 + c) : zero;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int4 lo = xin[i][0] ? __ldg(x4[i][0] + c) : zero;
      const int4 hi = xin[i][1] ? __ldg(x4[i][1] + c) : zero;
      mma_s8(acc[i], lo.x, hi.x, lo.y, hi.y, w.x, w.y);
      mma_s8(acc[i], lo.z, hi.z, lo.w, hi.w, w.z, w.w);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[kp][4 * i + e][lane] = acc[i][e];
  __syncthreads();
  if (kp != 0) return;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      for (int q = 1; q < kMmaSplit; ++q) acc[i][e] += part[q][4 * i + e][lane];
  // Accumulator layout: acc[i][2 h + e] = row 16 i + 8 h + g,
  // column n0 + 2 t + e.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * i + 8 * h + g;
      if (m >= M) continue;
      const float s = sx[m];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nn = n0 + 2 * t + e;
        if (nn >= N) continue;
        float y = w8_epilogue(acc[i][2 * h + e], s, scale[nn]);
        const size_t o = static_cast<size_t>(m) * N + nn;
        if (resid != nullptr) y = resid[o] + y;
        out[o] = y;
      }
    }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

// GEMV: up to kGemvMaxM activation rows per pass over the weights
// (dp4a up to 8 rows, int8 mma above).  Shapes the mma path does not
// take (K % 64 != 0, unaligned rows) and M > kGemvMaxM run the dp4a
// GEMV in groups of 8 rows, one weight pass per group.  ``pdl``: each
// launch a programmatic dependent one (K7's chain).
inline cudaError_t launch_w8_gemv(const int8_t* xq, const float* sx,
                                  const int8_t* codes, const float* scale,
                                  const float* resid, float* out, int M,
                                  int N, int K, cudaStream_t st,
                                  bool pdl = false) {
  const bool vec = (K % 16 == 0) && aligned16(xq) && aligned16(codes);
  if (M > kDp4aMaxM && M <= kGemvMaxM && vec && K % 64 == 0) {
    const dim3 grid((N + 7) / 8), block(32 * kMmaSplit);
    switch ((M + 15) / 16) {
#define VX_MMA_CASE(MT)                                                 \
  case MT:                                                              \
    return launch_pdl(w8_gemv_mma_kernel<MT>, grid, block, 0, st, pdl,  \
                      xq, sx, codes, scale, resid, out, M, N, K);
      VX_MMA_CASE(1)
      VX_MMA_CASE(2)
      VX_MMA_CASE(3)
      VX_MMA_CASE(4)
#undef VX_MMA_CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const dim3 block(32 * kGemvWarps);
  for (int m0 = 0; m0 < M; m0 += kDp4aMaxM) {
    const int mr = (M - m0 < kDp4aMaxM) ? (M - m0) : kDp4aMaxM;
    const int8_t* x = xq + static_cast<size_t>(m0) * K;
    const float* s = sx + m0;
    const float* r = resid ? resid + static_cast<size_t>(m0) * N : nullptr;
    float* o = out + static_cast<size_t>(m0) * N;
    cudaError_t e = cudaErrorInvalidValue;
    switch (mr) {
#define VX_GEMV_CASE(MM)                                                \
  case MM:                                                              \
    e = launch_pdl(w8_gemv_kernel<MM>, grid, block, 0, st, pdl, x, s,   \
                   codes, scale, r, o, N, K, vec);                      \
    break;
      VX_GEMV_CASE(1)
      VX_GEMV_CASE(2)
      VX_GEMV_CASE(3)
      VX_GEMV_CASE(4)
      VX_GEMV_CASE(5)
      VX_GEMV_CASE(6)
      VX_GEMV_CASE(7)
      VX_GEMV_CASE(8)
#undef VX_GEMV_CASE
      default:
        break;
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The g32 dots of activation rows xq [M, K] with weight row n of codes
// [N, K] int8 and f16 group scales [N, K/32], one warp:
// acc[m] = sum_g z_g * s[n, g], the exact int32 group dots z_g times
// their scales (exact in f64) summed in f64, on every lane.  16-byte
// loads as in w8_gemv_kernel; a lane's 16 bytes are half a group, so
// the two lanes of a group add their int32 partials (a shuffle) before
// the scale.  The loop runs the same trip count on every lane (the
// shuffles need the whole warp).  Shared by the g32 GEMV and the g32 lm
// fold (lm_argmax.cuh), so the fold's logits are the GEMV's bit for bit.
// PRE > 0: the first PRE rounds' pieces and scales come preloaded in pw
// / ps (g32_preload, before pdl_wait); the sums run in the same order.
template <int PRE>
__device__ __forceinline__ void g32_preload(const int8_t* __restrict__ codes,
                                            const __half* __restrict__ gscale,
                                            int n, int K, int lane,
                                            int4 (&pw)[PRE > 0 ? PRE : 1],
                                            double (&ps)[PRE > 0 ? PRE : 1]) {
  const int4* w4 =
      reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K);
  const __half* sr = gscale + static_cast<size_t>(n) * (K / 32);
  const int nv = K >> 4;
#pragma unroll
  for (int j = 0; j < PRE; ++j) {
    const int i = 32 * j + lane;
    const bool in = i < nv;
    pw[j] = in ? __ldg(w4 + i) : make_int4(0, 0, 0, 0);
    ps[j] = in ? static_cast<double>(__half2float(sr[i >> 1])) : 0.0;
  }
}

// xq is read with __ldg: a caller after pdl_wait passes it through
// after_wait.
template <int M, int PRE = 0>
__device__ __forceinline__ void g32_row_dots(
    const int8_t* xq, const int8_t* __restrict__ codes,
    const __half* __restrict__ gscale, int n, int K, int lane,
    double (&acc)[M], const int4 (&pw)[PRE > 0 ? PRE : 1],
    const double (&ps)[PRE > 0 ? PRE : 1]) {
  const int4* w4 =
      reinterpret_cast<const int4*>(codes + static_cast<size_t>(n) * K);
  const __half* sr = gscale + static_cast<size_t>(n) * (K / 32);
  const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0;
  const int nv = K >> 4;  // 16-byte chunks, two per group
  // Round ``base``: lane's piece i = base + lane with its group scale s.
  auto step = [&](int base, const int4 wv, const double s) {
    const int i = base + lane;
    const bool in = i < nv;  // nv is even: both lanes of a group agree
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int4 xv =
          in ? __ldg(reinterpret_cast<const int4*>(
                         xq + static_cast<size_t>(m) * K) + i)
             : zero;
      int a = 0;
      a = __dp4a(wv.x, xv.x, a);
      a = __dp4a(wv.y, xv.y, a);
      a = __dp4a(wv.z, xv.z, a);
      a = __dp4a(wv.w, xv.w, a);
      a += __shfl_xor_sync(0xffffffffu, a, 1);  // the group's exact dot
      if ((lane & 1) == 0) acc[m] += static_cast<double>(a) * s;
    }
  };
#pragma unroll
  for (int j = 0; j < PRE; ++j)
    if (32 * j < nv) step(32 * j, pw[j], ps[j]);
  for (int base = 32 * PRE; base < nv; base += 32) {
    const int i = base + lane;
    const bool in = i < nv;
    step(base, in ? __ldg(w4 + i) : zero,
          in ? static_cast<double>(__half2float(sr[i >> 1])) : 0.0);
  }
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = warp_sum_f64(acc[m]);
}

template <int M>
__device__ __forceinline__ void g32_row_dots(
    const int8_t* xq, const int8_t* __restrict__ codes,
    const __half* __restrict__ gscale, int n, int K, int lane,
    double (&acc)[M]) {
  const int4 pw[1] = {make_int4(0, 0, 0, 0)};
  const double ps[1] = {0.0};
  g32_row_dots<M, 0>(xq, codes, gscale, n, K, lane, acc, pw, ps);
}

// g32 GEMV, M <= 8: one warp per output row n (g32_row_dots), the
// epilogue float(sum) * sx[m] (+ resid).
template <int M, int PRE = 0>
__global__ void __launch_bounds__(256) g32_gemv_kernel(
    const int8_t* xq, const float* sx,
    const int8_t* __restrict__ codes, const __half* __restrict__ gscale,
    const float* resid, float* out, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  int4 pw[PRE > 0 ? PRE : 1];  // as w8_gemv_kernel's PRE
  double ps[PRE > 0 ? PRE : 1];
  if constexpr (PRE > 0) g32_preload<PRE>(codes, gscale, n < N ? n : 0, K,
                                          lane, pw, ps);
  pdl_trigger();
  pdl_wait();
  xq = after_wait(xq);  // g32_row_dots reads it with __ldg
  if (n >= N) return;  // whole warps leave together
  double acc[M];
  g32_row_dots<M, PRE>(xq, codes, gscale, n, K, lane, acc, pw, ps);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float y = static_cast<float>(acc[m]) * sx[m];
      const size_t o = static_cast<size_t>(m) * N + n;
      if (resid != nullptr) y = resid[o] + y;
      out[o] = y;
    }
  }
}

// g32 GEMV over M <= 16 * MT rows with int8 tensor-core mma, one warp per
// 8 output rows (all of K) with w8_gemv_mma_kernel's fragments, but each
// m16n8k32 product is
// exactly one group: lane (g, t) loads the 8 bytes at 32 grp + 8 t of
// weight row n0 + g and of activation rows 16 i + g, 16 i + g + 8, so a
// product's 32 k slots are the group's 32 bytes.  Its int32 fragment
// (fresh each group) takes the group's scale before the f64 sum.
template <int MT>
__global__ void __launch_bounds__(32 * kMmaWarps) g32_gemv_mma_kernel(
    const int8_t* xq, const float* sx,
    const int8_t* __restrict__ codes, const __half* __restrict__ gscale,
    const float* resid, float* out, int M, int N, int K) {
  pdl_trigger();
  pdl_wait();
  xq = after_wait(xq);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x * kMmaWarps + (threadIdx.x >> 5)) * 8;
  if (n0 >= N) return;  // whole warps leave together
  const int n = n0 + g;
  const int G = K / 32;
  const int2 zero = make_int2(0, 0);
  const int2* w2 = reinterpret_cast<const int2*>(
      codes + static_cast<size_t>(n < N ? n : N - 1) * K);
  // The two output columns of this lane's fragment, n0 + 2t + e.
  const __half* s0 = gscale + static_cast<size_t>(min(n0 + 2 * t, N - 1)) * G;
  const __half* s1 =
      gscale + static_cast<size_t>(min(n0 + 2 * t + 1, N - 1)) * G;
  const int2* x2[MT][2];
  bool xin[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * i + 8 * h + g;
      xin[i][h] = m < M;
      x2[i][h] = reinterpret_cast<const int2*>(
          xq + static_cast<size_t>(m < M ? m : 0) * K);
    }
  double acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0;
  for (int grp = 0; grp < G; ++grp) {
    const int c = 4 * grp + t;  // int2 index of bytes 32 grp + 8 t
    const int2 w = n < N ? __ldg(w2 + c) : zero;
    const double sc0 = __half2float(s0[grp]);
    const double sc1 = __half2float(s1[grp]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int2 lo = xin[i][0] ? __ldg(x2[i][0] + c) : zero;
      const int2 hi = xin[i][1] ? __ldg(x2[i][1] + c) : zero;
      int d[4] = {0, 0, 0, 0};
      mma_s8(d, lo.x, hi.x, lo.y, hi.y, w.x, w.y);
      acc[i][0] += static_cast<double>(d[0]) * sc0;
      acc[i][1] += static_cast<double>(d[1]) * sc1;
      acc[i][2] += static_cast<double>(d[2]) * sc0;
      acc[i][3] += static_cast<double>(d[3]) * sc1;
    }
  }
  // Fragment layout: acc[i][2 h + e] = row 16 i + 8 h + g, column
  // n0 + 2 t + e.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * i + 8 * h + g;
      if (m >= M) continue;
      const float s = sx[m];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nn = n0 + 2 * t + e;
        if (nn >= N) continue;
        float y = static_cast<float>(acc[i][2 * h + e]) * s;
        const size_t o = static_cast<size_t>(m) * N + nn;
        if (resid != nullptr) y = resid[o] + y;
        out[o] = y;
      }
    }
}

// g32 GEMV: the row counts of launch_w8_gemv (mma for 8 < M <= 64, dp4a
// in groups of 8 rows otherwise).  Needs K % 32 == 0, aligned rows.
// ``pdl``: each launch a programmatic dependent one (K4 / K5's chains).
inline cudaError_t launch_g32_gemv(const int8_t* xq, const float* sx,
                                   const int8_t* codes, const __half* gscale,
                                   const float* resid, float* out, int M,
                                   int N, int K, cudaStream_t st,
                                   bool pdl = false) {
  if (M > kDp4aMaxM && M <= kGemvMaxM) {
    const dim3 grid((N + 8 * kMmaWarps - 1) / (8 * kMmaWarps));
    const dim3 block(32 * kMmaWarps);
    switch ((M + 15) / 16) {
#define VX_G32_MMA_CASE(MT)                                                \
  case MT:                                                                 \
    return launch_pdl(g32_gemv_mma_kernel<MT>, grid, block, 0, st, pdl, xq, \
                      sx, codes, gscale, resid, out, M, N, K);
      VX_G32_MMA_CASE(1)
      VX_G32_MMA_CASE(2)
      VX_G32_MMA_CASE(3)
      VX_G32_MMA_CASE(4)
#undef VX_G32_MMA_CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const dim3 block(32 * kGemvWarps);
  for (int m0 = 0; m0 < M; m0 += kDp4aMaxM) {
    const int mr = (M - m0 < kDp4aMaxM) ? (M - m0) : kDp4aMaxM;
    const int8_t* x = xq + static_cast<size_t>(m0) * K;
    const float* s = sx + m0;
    const float* r = resid ? resid + static_cast<size_t>(m0) * N : nullptr;
    float* o = out + static_cast<size_t>(m0) * N;
    cudaError_t e = cudaErrorInvalidValue;
    switch (mr) {
#define VX_G32_CASE(MM)                                                   \
  case MM:                                                                \
    e = launch_pdl(g32_gemv_kernel<MM>, grid, block, 0, st, pdl, x, s,    \
                   codes, gscale, r, o, N, K);                            \
    break;
      VX_G32_CASE(1)
      VX_G32_CASE(2)
      VX_G32_CASE(3)
      VX_G32_CASE(4)
      VX_G32_CASE(5)
      VX_G32_CASE(6)
      VX_G32_CASE(7)
      VX_G32_CASE(8)
#undef VX_G32_CASE
      default:
        break;
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace vx
