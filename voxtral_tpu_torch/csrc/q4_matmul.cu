// K3: fused Q4_0 dequant + matmul on nibble-packed weights.
//
// Port of voxtral_tpu/ops/q4_pallas.py::q4_matmul_pallas (kernel body
// _q4_matmul_kernel).  Layouts (the JAX package's packed q4 format):
//   x        [M, K] f32 (M <= 8: decode rows)
//   packed   [K/8, N] int32: word (i, n) holds the unsigned nibble
//            code[n, 8i + j] + 8 in bits 4j .. 4j + 3
//   scales_t [K/32, N] bf16: the group scales, transposed
//   out      [M, N] f32
//
//   out[m, n] = f32( sum_g ( G[m, g, n] - xb8[m, g] * s[g, n] ) ),
//   G[m, g, n] = ((R_0 + R_1) + R_2) + R_3 in f32, R_r the f32 sum, in k
//                order, of the 8 exact products bf16(x[m, k]) *
//                bf16(nib[k, n] * s[g, n]) of packed row 4 g + r,
//   xb8[m, g]  = 8 * the f32 sum of x[m, 32 g .. 32 g + 31]
//
// These are the TPU kernel's rounding points (x rounded to bf16, each
// weight the bf16 product of the nibble and the bf16 scale, the exact
// -8 offset correction through per-32 sums of the f32 x) with its f32
// sums taken group by group: each packed row's 8 products are summed in
// f32 in k order (an FFMA on an exact product rounds as FMUL + FADD), a
// group's four row sums in f32 in row order, and the groups and their
// corrections in f64, rounded once.  The
// f64 adds of the group terms (each a 24-bit group sum or a 32-bit exact
// correction) are exact while the terms stay within about 2^21 of one
// another, and beyond that err by 2^-53 of the sum, so their order does
// not move the f32 result; the plain version
// (ops/q4_kernel.py::q4_matmul_plain) states the same rule and the two
// agree bit for bit.
//
// What bounds it on the H100: the packed weights streamed from HBM
// (0.5 byte per weight + 2 bytes of scale per 32), 0.5625 bytes a weight;
// at 8 rows the f32 FFMAs (8 a weight).  Design:
//  * A warp owns 128 output columns, a lane four adjacent ones, so each
//    lane loads 16 bytes of a packed row (one uint4: 32 weights) and a
//    warp 512 contiguous bytes; a group of 32 k is four such rows and
//    8 bytes of scales, loaded PF groups ahead of its use.
//  * The nibbles become bf16(nib * s) two at a time: the pair
//    (128 + nib_j, 128 + nib_j+4) is one LOP3 on the word, and one
//    fma.rn.bf16x2 with (s, s) and (-128 s, -128 s) gives both products
//    rounded once to bf16, the same value as bf16(nib) * bf16(s).
//  * A block is tw x kw warps: tw column tiles, each walked by kw warps
//    over disjoint group ranges; a cluster of S blocks (gridDim.y) splits
//    K further.  The plan (q4_plan, read from Python through vx_q4_plan)
//    picks them so that every shape runs in one wave with enough warps an
//    SM.
//  * Each block stages its K slice of x in shared memory once, rounded
//    to bf16 (read as float4 broadcasts), with its per-group sums xb8.
//  * The partial sums merge in a fixed order: the kw warps of a tile in
//    shared memory, then the S blocks of the cluster through distributed
//    shared memory in rank order (each block writes 1/S of the tile).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"  // round_bf16, warp_sum_d

namespace cg = cooperative_groups;

namespace vx {
namespace {

constexpr int kMaxRows = 8;
constexpr int kTileCols = 128;  // output columns of a warp, four a lane
constexpr int kMaxWarps = 8;
constexpr int kMaxSplits = 8;   // blocks of a cluster along K (portable)
constexpr int kSmemLimit = 227 * 1024;

// One group of 32 k for a lane's four columns: packed rows 4g .. 4g + 3
// (a uint4 each: columns c0 .. c0 + 3) and the four bf16 scales.
struct Group {
  uint4 w[4];
  uint2 s;
};

__device__ __forceinline__ void load_group(Group& b,
                                           const int32_t* __restrict__ packed,
                                           const __nv_bfloat16* __restrict__ sc,
                                           int g, int N, int c0) {
  const uint4* p = reinterpret_cast<const uint4*>(
      packed + static_cast<size_t>(4 * g) * N + c0);
  const size_t row = static_cast<size_t>(N) / 4;  // uint4s a packed row
#pragma unroll
  for (int r = 0; r < 4; ++r) b.w[r] = __ldg(p + r * row);
  b.s = __ldg(reinterpret_cast<const uint2*>(sc + static_cast<size_t>(g) * N +
                                             c0));
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The eight weights of one packed word as f32: w[j] = bf16(nib_j * s),
// from s2 = (s, s) and n2 = (-128 s, -128 s) as bf16x2.  (128 + nib) * s
// - 128 s is nib * s exactly before the one rounding.
__device__ __forceinline__ void dequant8(uint32_t word, uint32_t s2,
                                         uint32_t n2, float (&w)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t v = ((word >> (4 * j)) & 0x000F000Fu) | 0x43004300u;
    const uint32_t d = fma_bf16x2(v, s2, n2);
    w[j] = __uint_as_float(d << 16);
    w[j + 4] = __uint_as_float(d & 0xFFFF0000u);
  }
}

// acc[m][c] += G[m, g, c] - xb8[m, g] * s[g, c] for one group: xg the
// group's 32 staged bf16(x) of row 0 (rows xld apart), x8 its xb8 of row
// 0 (rows x8ld apart).
template <int M>
__device__ __forceinline__ void group_dots(const Group& b,
                                           const float* __restrict__ xg,
                                           int xld,
                                           const double* __restrict__ x8,
                                           int x8ld, double (&acc)[M][4]) {
  uint32_t s2[4], n2[4];
  double sd[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t word = c < 2 ? b.s.x : b.s.y;
    const uint32_t h = (c & 1) ? (word >> 16) : (word & 0xFFFFu);
    const float sf = __uint_as_float(h << 16);
    const uint32_t nh = __float_as_uint(-128.0f * sf) >> 16;  // exact
    s2[c] = h | (h << 16);
    n2[c] = nh | (nh << 16);
    sd[c] = static_cast<double>(sf);
  }
  // gs = ((s_0 + s_1) + s_2) + s_3, s_r the f32 sum of packed row r's
  // eight products in k order (an FFMA chain from 0).
  float gs[M][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t words[4] = {b.w[r].x, b.w[r].y, b.w[r].z, b.w[r].w};
    if constexpr (M <= 4) {
      // Few rows: the rows' x in registers, one column's weights at a
      // time.
      float xv[M][8];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 xa =
            *reinterpret_cast<const float4*>(xg + m * xld + 8 * r);
        const float4 xb =
            *reinterpret_cast<const float4*>(xg + m * xld + 8 * r + 4);
        xv[m][0] = xa.x, xv[m][1] = xa.y, xv[m][2] = xa.z, xv[m][3] = xa.w;
        xv[m][4] = xb.x, xv[m][5] = xb.y, xv[m][6] = xb.z, xv[m][7] = xb.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float wv[8];
        dequant8(words[c], s2[c], n2[c], wv);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          float p = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) p = __fmaf_rn(xv[m][j], wv[j], p);
          gs[m][c] = r == 0 ? p : gs[m][c] + p;
        }
      }
    } else {
      // More rows: the four columns' weights in registers, one row's x
      // at a time.
      float wv[4][8];
#pragma unroll
      for (int c = 0; c < 4; ++c) dequant8(words[c], s2[c], n2[c], wv[c]);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 xa =
            *reinterpret_cast<const float4*>(xg + m * xld + 8 * r);
        const float4 xb =
            *reinterpret_cast<const float4*>(xg + m * xld + 8 * r + 4);
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) p[c] = __fmaf_rn(xv[j], wv[c][j], p[c]);
#pragma unroll
        for (int c = 0; c < 4; ++c) gs[m][c] = r == 0 ? p[c] : gs[m][c] + p[c];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const double c8 = x8[m * x8ld];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[m][c] += static_cast<double>(gs[m][c]);
      acc[m][c] -= c8 * sd[c];
    }
  }
}

// Shared memory of a block: the staged x slice (nb groups: bf16(x) as
// f32 and xb8 as f64), later the warps' partials and, in a cluster, the
// tile's merged sums.
__host__ __device__ constexpr size_t q4_smem_bytes(int M, int nb, int warps,
                                                   int tw, int S) {
  const size_t stage = static_cast<size_t>(M) * nb * (32 * 4 + 8);
  const size_t merge =
      static_cast<size_t>(warps) * M * kTileCols * 8 +
      (S > 1 ? static_cast<size_t>(M) * tw * kTileCols * 8 : 0);
  return stage > merge ? stage : merge;
}

// The plan (tw, kw, S) of a launch at M rows, N columns, K deep on a
// card of ``sms`` SMs: K cut into P = kw x S parts, the power of two near
// W x sms / (N / 128), at most 64 and at most K / 32, a cluster of up to
// 8 taking them first.  At 1 and 2 rows W = 8 warps an SM in blocks of 4
// (a cluster) or 8 (two parts or fewer, as the lm_head's 1024 tiles
// want); above, W = 5 in blocks of 8 (each thread's f64 sums take
// registers, and fewer, fuller blocks measured faster).  The parts need
// not divide K / 32: the groups split as evenly as they go.  Where a
// block's slice of x does not fit its shared memory, more of the cluster
// splits K.  Tuned on the H100 at the decoder's shapes
// (benches/torch_k3_k7_times.py).  False: no plan fits.
struct Q4Plan {
  int tw, kw, S;
  size_t smem;
};

inline bool q4_plan(int M, int N, int K, int sms, Q4Plan& p) {
  if (M < 1 || M > kMaxRows || N <= 0 || K <= 0 || N % kTileCols ||
      K % 32 || sms < 1)
    return false;
  const int tiles = N / kTileCols, groups = K / 32;
  const bool few = M <= 2;
  double want = (few ? 8.0 : 5.0) * sms / tiles;
  if (few && want < 2.0) want = 2.0;
  int parts = 1;
  while (parts < 64 && parts * 2 <= groups && parts * 1.5 < want) parts *= 2;
  // A cluster of up to 8 first; two parts stay in one block.
  p.S = parts <= 2 ? 1 : (parts < kMaxSplits ? parts : kMaxSplits);
  p.kw = parts / p.S;
  const int block = few && p.S > 1 ? 4 : kMaxWarps;
  p.tw = 1;
  while (p.tw * p.kw * 2 <= block && tiles % (2 * p.tw) == 0) p.tw *= 2;
  for (;;) {
    p.smem = q4_smem_bytes(M, (groups + p.S - 1) / p.S, p.tw * p.kw, p.tw,
                           p.S);
    if (p.smem <= static_cast<size_t>(kSmemLimit)) return true;
    if (p.S == kMaxSplits) return false;
    p.S *= 2;
  }
}

// grid (N / (128 tw), S), block 32 tw kw, cluster (1, S, 1) when S > 1.
template <int M>
__global__ void __launch_bounds__(32 * kMaxWarps, M <= 2 ? 2 : 1)
    q4_gemv_kernel(const float* __restrict__ x,
                   const int32_t* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ scales,
                   float* __restrict__ out, int N, int K, int tw, int kw) {
  constexpr int PF = M == 1 ? 2 : 1;  // groups loaded ahead of their use
  constexpr int NB = PF + 1;
  extern __shared__ double smem_d[];
  const int S = gridDim.y, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t = warp % tw, kv = warp / tw;
  const int col0 = blockIdx.x * tw * kTileCols;
  const int c0 = col0 + t * kTileCols + 4 * lane;
  const int G = K / 32;
  const int gs0 = s * G / S, gs1 = (s + 1) * G / S, nb = gs1 - gs0;
  const int g0 = gs0 + kv * nb / kw, g1 = gs0 + (kv + 1) * nb / kw;
  float* xs = reinterpret_cast<float*>(smem_d);           // [M][nb * 32]
  double* xb8 = reinterpret_cast<double*>(xs + M * nb * 32);  // [M][nb]

  Group buf[NB];
#pragma unroll
  for (int i = 0; i < PF; ++i)
    if (g0 + i < g1) load_group(buf[i], packed, scales, g0 + i, N, c0);

  // Stage the block's slice of x: one warp per (row, group), a lane per
  // k, each warp's loads for four (row, group)s issued together.
  constexpr int kAheadRows = 4;
  for (int i0 = warp; i0 < M * nb; i0 += kAheadRows * nwarps) {
    float v[kAheadRows];
#pragma unroll
    for (int u = 0; u < kAheadRows; ++u) {
      const int i = i0 + u * nwarps;
      const int m = i / nb, gl = i - m * nb;
      v[u] = i < M * nb
                 ? x[static_cast<size_t>(m) * K + 32 * (gs0 + gl) + lane]
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAheadRows; ++u) {
      const int i = i0 + u * nwarps;
      if (i < M * nb) {  // the same on every lane of the warp
        const int m = i / nb, gl = i - m * nb;
        xs[(m * nb + gl) * 32 + lane] = round_bf16(v[u]);
        const double sum = warp_sum_d(static_cast<double>(v[u]));
        if (lane == 0)
          xb8[m * nb + gl] =
              static_cast<double>(static_cast<float>(sum) * 8.0f);
      }
    }
  }
  __syncthreads();

  double acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0;
  for (int g = g0; g < g1; g += NB) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int gg = g + u;
      if (gg < g1) {
        if (gg + PF < g1)
          load_group(buf[(u + PF) % NB], packed, scales, gg + PF, N, c0);
        group_dots<M>(buf[u], xs + (gg - gs0) * 32, nb * 32,
                      xb8 + (gg - gs0), nb, acc);
      }
    }
  }

  // The kw warps of each tile, in warp order, through shared memory.
  __syncthreads();  // the staged x is no longer read
  double* part = smem_d;  // [warp][M][128]
#pragma unroll
  for (int m = 0; m < M; ++m) {
    double2* p = reinterpret_cast<double2*>(
        part + (warp * M + m) * kTileCols + 4 * lane);
    p[0] = make_double2(acc[m][0], acc[m][1]);
    p[1] = make_double2(acc[m][2], acc[m][3]);
  }
  __syncthreads();
  const int width = tw * kTileCols;  // this block's columns
  const int outs = M * width;
  double* mrg = part + nwarps * M * kTileCols;  // [M][width], S > 1
  for (int i = threadIdx.x; i < outs; i += blockDim.x) {
    const int m = i / width, col = i - m * width;
    const int tt = col / kTileCols, cc = col - tt * kTileCols;
    double v = 0.0;
    for (int q = 0; q < kw; ++q)
      v += part[((q * tw + tt) * M + m) * kTileCols + cc];
    if (S == 1)
      out[static_cast<size_t>(m) * N + col0 + col] = static_cast<float>(v);
    else
      mrg[i] = v;
  }
  if (S == 1) return;
  // The S blocks of the cluster, in rank order (rank = blockIdx.y), each
  // block adding and writing its 1/S of the tile.
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int per = (outs + S - 1) / S;
  const int hi = min(outs, (s + 1) * per);
  for (int i = s * per + threadIdx.x; i < hi; i += blockDim.x) {
    double v = 0.0;
    for (int r = 0; r < S; ++r) v += cl.map_shared_rank(mrg, r)[i];
    const int m = i / width, col = i - m * width;
    out[static_cast<size_t>(m) * N + col0 + col] = static_cast<float>(v);
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

template <int M>
cudaError_t launch_q4(const float* x, const int32_t* packed,
                      const __nv_bfloat16* scales, float* out, int N, int K,
                      int tw, int kw, int S, cudaStream_t st) {
  static unsigned attr_set = 0;  // per instantiation, a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && !(attr_set >> dev & 1u)) {
    e = cudaFuncSetAttribute(q4_gemv_kernel<M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
    if (e != cudaSuccess) return e;
    attr_set |= 1u << dev;
  } else if (dev >= 32) {
    e = cudaFuncSetAttribute(q4_gemv_kernel<M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
    if (e != cudaSuccess) return e;
  }
  const int G = K / 32;
  const int nb = (G + S - 1) / S;
  const size_t smem = q4_smem_bytes(M, nb, tw * kw, tw, S);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / (kTileCols * tw), S, 1);
  cfg.blockDim = dim3(32 * tw * kw, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, q4_gemv_kernel<M>, x, packed, scales, out,
                            N, K, tw, kw);
}

}  // namespace
}  // namespace vx

// The plan of q4_plan at M rows, N columns, K deep on ``sms`` SMs:
// plan = {tw, kw, S, shared memory bytes of a block}; an error where none
// fits.
extern "C" int vx_q4_plan(int M, int N, int K, int sms, int* plan) {
  vx::Q4Plan p;
  if (!vx::q4_plan(M, N, K, sms, p))
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.tw;
  plan[1] = p.kw;
  plan[2] = p.S;
  plan[3] = static_cast<int>(p.smem);
  return 0;
}

// All pointers are device pointers (layouts above); packed and scales
// 16- and 8-byte aligned.  The plan (tw, kw, S): tw column tiles of 128
// per block, kw warps per tile (tw * kw <= 8), S blocks of a cluster
// along K (1 .. 8); N % (128 tw) == 0, K % 32 == 0, 1 <= M <= 8.
extern "C" int vx_q4_matmul(const void* x, const void* packed,
                            const void* scales, void* out, int M, int N,
                            int K, int tw, int kw, int S, void* stream) {
  using namespace vx;
  if (M < 1 || M > kMaxRows || N <= 0 || K <= 0 || K % 32 || tw < 1 ||
      kw < 1 || tw * kw > kMaxWarps || S < 1 || S > kMaxSplits ||
      N % (kTileCols * tw) ||
      (reinterpret_cast<uintptr_t>(packed) & 15u) ||
      (reinterpret_cast<uintptr_t>(scales) & 7u))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int32_t* pp = static_cast<const int32_t*>(packed);
  const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(scales);
  float* op = static_cast<float*>(out);
  cudaError_t e = cudaErrorInvalidValue;
  switch (M) {
#define VX_Q4_CASE(MM)                                                   \
  case MM:                                                               \
    e = launch_q4<MM>(xp, pp, sp, op, N, K, tw, kw, S, st);              \
    break;
    VX_Q4_CASE(1)
    VX_Q4_CASE(2)
    VX_Q4_CASE(3)
    VX_Q4_CASE(4)
    VX_Q4_CASE(5)
    VX_Q4_CASE(6)
    VX_Q4_CASE(7)
    VX_Q4_CASE(8)
#undef VX_Q4_CASE
    default:
      break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
