// The greedy lm fold shared by K1 mode (i) (decode_step.cu, lm_argmax)
// and K6 (decode_tp.cu, vx_lm_half_argmax): the lm_head over a vocab
// range with the argmax folded in, so the [B, V] logits are never
// written.  Three weight formats: W8A8 (int8 codes, f32 row scales), g32
// (q4g: int8 codes = Q4_0 nibble - 8, f16 group scales [V, D/32]) and
// bf16 (K1 mode (g)'s dense table, no scales; K1 only).
//
// Port of the running (max, first index) fold of
// voxtral_tpu/ops/decode_step_pallas.py (lm_argmax, :1285-1300) and of
// decode_tp_pallas.py::_make_lm_half (:1228-1279).  The TPU kernels walk
// the vocab tiles in order in one grid and carry the fold in VMEM; CUDA
// blocks run in no order, so the fold takes two passes:
//
//   pass 1  one block per tile of kLmTile vocab rows (kLmRowsPerWarp
//           consecutive rows per warp), up to 8 activation rows: the
//           logits y = (float(z) * sx[m]) * scale[n], the w8 GEMV's
//           epilogue in the order of decode_tp_pallas.py:1265, or in
//           g32 y = float(sum_g z_g * s[n, g]) * sx[m], the group sum in
//           f64 rounded once (g32_row_dots, the g32 GEMV's own dot, so
//           the logits are K1 mode (h)'s bit for bit; the order of
//           _g32_matmul_tile, decode_step_pallas.py:84-123), or in bf16
//           y = float(sum_k x[m, k] * w[n, k]) over the bf16 rows that
//           row_quant writes, the exact products summed in f64 and
//           rounded once (bf16_row_dots, mode (g)'s GEMV's own dot, so
//           the logits and the token are mode (g)'s and torch.argmax's
//           of them bit for bit; wq8=False, decode_step_pallas.py:
//           1271-1300), reduced to the tile's (max, first index) per
//           activation row;
//   pass 2  one block per activation row merges the tiles: a larger
//           value wins, and of equal values the lower index -- the same
//           result as merging the tiles in tile order with a strictly
//           larger value replacing the running one, i.e. torch.argmax's
//           first index of the maximum.
//
// What bounds it on the H100: the table's bytes, read once (V x D int8
// and V f32 scales: 403 MB for the whole 131072-row table, 201.6 MB for
// a tp = 2 vocab shard; in g32 V x D/32 f16 scales instead: 427.8 MB,
// 213.9 MB; in bf16 V x D x 2 bytes: 805.3 MB for the whole table, the
// same bytes as mode (g)'s GEMV less its [B, V] f32 logits write); the
// partials are 8 bytes per tile and row.
// More than 8 activation rows take one weight pass per group of 8 (the
// dp4a GEMV's limit); the tensor-core GEMV of w8_common.cuh is later work.
// Internal linkage: each translation unit has its own copy.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_gemv.cuh"
#include "w8_common.cuh"

namespace vx {
namespace {

// The weight format of a step or a fold (the host entries' ``wfmt``).
enum WeightFormat { kW8 = 0, kG32 = 1, kBf16 = 2 };

constexpr int kLmRowsPerWarp = 4;
constexpr int kLmTile = kGemvWarps * kLmRowsPerWarp;  // vocab rows per block

// Is the candidate (v, i) better than the running (bv, bi)?  i < 0: no
// candidate.  A larger value wins; of equal values the lower index.
__device__ __forceinline__ bool argmax_better(float v, int i, float bv,
                                              int bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  return v > bv || (v == bv && i < bi);
}

// Pass 1.  Block ``tile`` covers vocab rows [tile * kLmTile, ...); warp
// w rows tile * kLmTile + w * kLmRowsPerWarp + r, r ascending, so a
// strictly larger value keeps the first index within the warp and the
// warps merge in order.  tmax / tidx [M, n_tiles]: the tile's maximum and
// its first (global) row index per activation row.  Fmt kW8: ``x`` the
// int8 rows with their scales ``sx``, ``table`` int8 codes, ``scale`` the
// f32 row scales [N]; kG32: ``scale`` the f16 group scales [N, K/32]
// (K % 32 == 0, 16-byte aligned rows); kBf16: ``x`` the bf16 rows,
// ``table`` bf16 [N, K], no scales (sx, scale unused).
template <int M, int Fmt>
__global__ void __launch_bounds__(32 * kGemvWarps) argmax_tile_kernel(
    const void* x, const float* sx,
    const void* __restrict__ table, const void* __restrict__ scale, int N,
    int K, bool vec, int n_tiles, float* __restrict__ tmax,
    int* __restrict__ tidx) {
  __shared__ float sv[kGemvWarps][M];
  __shared__ int si[kGemvWarps][M];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  pdl_trigger();
  pdl_wait();
  x = after_wait(x);  // the rows' __ldg loads stay after the wait
  float best_v[M];
  int best_i[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    best_v[m] = -INFINITY;
    best_i[m] = -1;
  }
  for (int r = 0; r < kLmRowsPerWarp; ++r) {
    const int n = tile * kLmTile + warp * kLmRowsPerWarp + r;
    if (n >= N) break;  // the same n on every lane
    float y[M];
    if constexpr (Fmt == kBf16) {
      double acc[M];  // every lane holds the sums
      bf16_row_dots<M>(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(table) +
                           static_cast<size_t>(n) * K,
                       M, K, vec, lane, acc);
#pragma unroll
      for (int m = 0; m < M; ++m) y[m] = static_cast<float>(acc[m]);
    } else if constexpr (Fmt == kG32) {
      double acc[M];  // every lane holds the sums
      g32_row_dots<M>(static_cast<const int8_t*>(x),
                      static_cast<const int8_t*>(table),
                      static_cast<const __half*>(scale), n, K,
                      lane, acc);
#pragma unroll
      for (int m = 0; m < M; ++m) y[m] = static_cast<float>(acc[m]) * sx[m];
    } else {
      const int8_t* xq = static_cast<const int8_t*>(x);
      const int8_t* w = static_cast<const int8_t*>(table) +
                        static_cast<size_t>(n) * K;
      int acc[M];
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = 0;
      if (vec) {
        const int4* w4 = reinterpret_cast<const int4*>(w);
        const int nv = K >> 4;
        for (int i = lane; i < nv; i += 32) {
          const int4 wv = __ldg(w4 + i);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int4 xv = __ldg(
                reinterpret_cast<const int4*>(xq + static_cast<size_t>(m) * K) +
                i);
            int a = acc[m];
            a = __dp4a(wv.x, xv.x, a);
            a = __dp4a(wv.y, xv.y, a);
            a = __dp4a(wv.z, xv.z, a);
            a = __dp4a(wv.w, xv.w, a);
            acc[m] = a;
          }
        }
      } else {
        for (int k = lane; k < K; k += 32) {
          const int wv = w[k];
#pragma unroll
          for (int m = 0; m < M; ++m)
            acc[m] += wv * static_cast<int>(xq[static_cast<size_t>(m) * K + k]);
        }
      }
      const float sc = static_cast<const float*>(scale)[n];
#pragma unroll
      for (int m = 0; m < M; ++m)  // every lane holds the sum
        y[m] = w8_epilogue(warp_sum_int(acc[m]), sx[m], sc);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (best_i[m] < 0 || y[m] > best_v[m]) {
        best_v[m] = y[m];
        best_i[m] = n;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      sv[warp][m] = best_v[m];
      si[warp][m] = best_i[m];
    }
  }
  __syncthreads();
  if (threadIdx.x < M) {
    const int m = threadIdx.x;
    float v = -INFINITY;
    int i = -1;
    for (int wi = 0; wi < kGemvWarps; ++wi) {  // warps in row order
      const int ci = si[wi][m];
      if (ci >= 0 && (i < 0 || sv[wi][m] > v)) {
        v = sv[wi][m];
        i = ci;
      }
    }
    tmax[static_cast<size_t>(m) * n_tiles + tile] = v;
    tidx[static_cast<size_t>(m) * n_tiles + tile] = i;
  }
}

// Pass 2: one block per activation row m over its n_tiles partials.
// vmax (may be NULL) and vidx [M]: the row's maximum and its first index.
__global__ void __launch_bounds__(256) argmax_merge_kernel(
    const float* tmax, const int* tidx, int n_tiles,
    float* __restrict__ vmax, int* __restrict__ vidx) {
  __shared__ float wv[32];
  __shared__ int wi[32];
  pdl_trigger();
  pdl_wait();
  const int m = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const float* tm = tmax + static_cast<size_t>(m) * n_tiles;
  const int* ti = tidx + static_cast<size_t>(m) * n_tiles;
  float v = -INFINITY;
  int i = -1;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
    if (argmax_better(tm[t], ti[t], v, i)) {
      v = tm[t];
      i = ti[t];
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (argmax_better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = -INFINITY;
    int bi = -1;
    for (int w = 0; w < nw; ++w)
      if (argmax_better(wv[w], wi[w], bv, bi)) {
        bv = wv[w];
        bi = wi[w];
      }
    if (vmax != nullptr) vmax[m] = bv;
    vidx[m] = bi;
  }
}

// Tiles of the fold over N vocab rows (the partials hold M x this).
inline int argmax_tiles(int N) { return (N + kLmTile - 1) / kLmTile; }

// The fold of the product x [M, K] . table [N, K]^T (``fmt``): W8A8, int8
// rows xq with scales sx and codes with row scales [N] f32 (kW8); g32,
// codes with group scales [N, K/32] f16 (kG32: K % 32 == 0 and 16-byte
// aligned rows); bf16 rows and a bf16 table, no scales (kBf16):
// vidx[m] = the first index of the largest logit of row m, vmax[m] (NULL:
// not written) its value.  Scratch tmax / tidx [M, argmax_tiles(N)].
inline void launch_argmax(int fmt, const void* xq, const float* sx,
                          const void* table, const void* scale, int M, int N,
                          int K, float* tmax, int* tidx, float* vmax,
                          int* vidx, cudaStream_t st, bool pdl = false) {
  const bool bf16 = fmt == kBf16;
  const size_t row_bytes = static_cast<size_t>(K) * (bf16 ? 2 : 1);
  const bool vec = (K % (bf16 ? 8 : 16) == 0) && aligned16(xq) &&
                   aligned16(table);
  const int n_tiles = argmax_tiles(N);
  for (int m0 = 0; m0 < M; m0 += kDp4aMaxM) {
    const int mr = (M - m0 < kDp4aMaxM) ? (M - m0) : kDp4aMaxM;
    const void* x = static_cast<const char*>(xq) + m0 * row_bytes;
    const float* s = sx == nullptr ? nullptr : sx + m0;
    float* tm = tmax + static_cast<size_t>(m0) * n_tiles;
    int* ti = tidx + static_cast<size_t>(m0) * n_tiles;
    switch (mr) {
#define VX_ARGMAX_CASE(MM)                                                 \
  case MM:                                                                 \
    launch_pdl(fmt == kG32 ? argmax_tile_kernel<MM, kG32>                  \
               : bf16      ? argmax_tile_kernel<MM, kBf16>                 \
                           : argmax_tile_kernel<MM, kW8>,                  \
               dim3(n_tiles), dim3(32 * kGemvWarps), 0, st, pdl, x, s,     \
               table, scale, N, K, vec, n_tiles, tm, ti);                  \
    break;
      VX_ARGMAX_CASE(1)
      VX_ARGMAX_CASE(2)
      VX_ARGMAX_CASE(3)
      VX_ARGMAX_CASE(4)
      VX_ARGMAX_CASE(5)
      VX_ARGMAX_CASE(6)
      VX_ARGMAX_CASE(7)
      VX_ARGMAX_CASE(8)
#undef VX_ARGMAX_CASE
      default:
        break;
    }
  }
  launch_pdl(argmax_merge_kernel, dim3(M), dim3(256), 0, st, pdl,
             static_cast<const float*>(tmax), static_cast<const int*>(tidx),
             n_tiles, vmax, vidx);
}

}  // namespace
}  // namespace vx
