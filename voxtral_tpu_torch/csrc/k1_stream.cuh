// K1's weight stream: the GEMVs and the lm fold of one decode step
// (decode_step.cu) over dense bf16 weights from 2 rows, g32 (q4g) weights
// from 5 and w8 weights above 32, in one pass over the weights up to 64
// rows (more rows: one pass per 64); K6 (decode_tp.cu) folds a g32 vocab
// shard on it from 5 rows.  Fewer rows keep the GEMVs and folds of
// w8_common.cuh / bf16_gemv.cuh / lm_argmax.cuh, which measured faster
// there (ops/decode_step.py::stream_plan routes; launch_gemv_ahead
// below).
//
// Port of the weight stream of voxtral_tpu/ops/decode_step_pallas.py::
// decode_stack_step: the w8 tiles (:742-752), the dense bf16 stream
// (wq8=False, :558) and the lm fold (:1271-1300).  The TPU kernel streams
// the weights of its sequential grid through VMEM behind the previous
// step's compute; here the step is a chain of launches, so each GEMV is a
// persistent grid, launched ahead of its predecessor (programmatic
// dependent launch), whose warps fetch their first weight tiles before
// pdl_wait:
//
//   out[m, n] = epilogue(sum_k x[m, k] * w[n, k])  (+ resid[m, n])
//
// with the epilogues of w8_common.cuh / bf16_gemv.cuh: w8
// (float(z) * sx[m]) * scale[n], z the exact int32 dot; g32
// float(sum_g z_g * s[n, g]) * sx[m], z_g the exact int32 dot of group g
// (32 k) and each z_g * s exact in f64, summed in f64; bf16
// float(sum_k x * w), each bf16 x bf16 product exact in f64 and the sum
// in f64.  Or, with ``tmax`` (mode (i)), the fold: per group of output
// rows and per activation row the largest value and its first index,
// merged by argmax_merge_kernel (lm_argmax.cuh) -- the logits the GEMV
// writes, so the token is torch.argmax of them.
//
// Layout of the work.  Output rows come in groups of R (w8 8, bf16 and
// g32 16);
// a block of kStreamParts warps takes groups blockIdx.x, + gridDim.x,
// ... and splits K into kStreamParts parts, one per warp.  Each warp
// streams its part of each of its groups in chunks of kc elements (R
// rows x kc) through its own ring of ``stages`` shared-memory slots,
// filled by 16-byte cp.async spread over its lanes, one copy group per
// chunk; before pdl_wait it issues its first ``stages`` - 1 chunks.  Up
// to 8 bf16 or g32 rows, the chunk's activation rows ride in the same
// slot (copied after the wait): read from L2 for every group they cost
// as much as the products.  A g32 slot also holds the group's f16 scales
// of the chunk (R rows x kc / 32), its rows lie kc + 32 bytes apart (the
// 8-byte fragment loads of rows g, a half-warp's, fall in distinct
// banks), and its copies take every lane, two rows a warp instruction:
// the copies' instructions, not their bytes, set a warp's pace (measured,
// PERF.md).  At a group's end the warps' partial sums meet
// in shared memory and are added in part order (0, 1, 2, 3), then the
// epilogue writes the group.
//
// The products, each fragment in two accumulator chains (acc: the first
// half of a step's products, acc2: the second) added at the group's end,
// so the mma latencies overlap:
//  * w8: int8 mma.m16n8k32, A = 16 activation rows, B = the group's 8
//    weight rows; lane (g, t) brings 16 bytes at k = 64 s + 16 t (the
//    permutation of w8_gemv_mma_kernel), exact int32.
//  * g32: int8 mma.m16n8k32 with each product exactly one group (the
//    k-slot permutation of w8_common.cuh::g32_gemv_mma_kernel), A = the
//    group's 16 weight rows, B = 8 activation rows: lane (g, t) brings
//    the 8 bytes at k = 32 s + 8 t of weight rows g and 8 + g and of
//    activation row 8 i + g, so a fragment slot holds the same k for
//    every row.  The int32 fragment (fresh each group) turns into
//    doubles exactly (the 2^52 + 2^51 bias and one f64 add: the f64 pipe
//    runs twice the conversion unit's rate), and each element takes its
//    weight row's scale in one f64 fma (the product exact, so fma == mul
//    + add); at one row tile the even and odd groups go to the two
//    chains.  A = the weights serves 16 output rows per activation
//    fragment: half the activation loads of A = 16 activation rows, and
//    no idle tensor-core rows below 9 rows.
//  * bf16: the f64 tensor cores, mma.m16n8k8.f64 (sm_90): A = the
//    group's 16 weight rows, B = 8 activation rows.  Lane (g, t) brings 8
//    bf16 of rows g and 8 + g at k = 32 s + 8 t; product h (0..3) takes
//    its elements 2 h (k slot t) and 2 h + 1 (slot t + 4), so a slot holds
//    the same k for every row.  Each weight is widened to f64 once per
//    pass (bf16 -> f32 by a shift, f32 -> f64 exact), not once per
//    (weight, row) as bf16_row_dots does.
//
// Summation order (g32: each z_g * s has at most 26 significant bits,
// so a row's f64 sum over its K / 32 groups is exact, in any order,
// while the row's scales span fewer than about 18 binades: the kernel's
// order -- even and odd groups, chunks, parts -- and g32_matmul_plain's
// give the same sum, rounded once to f32; past that span they may round
// differently.  bf16, where f64 round-off could show after the rounding
// to f32): within a part, chunk by chunk in k order, each mma
// adding its 8 exact products to its chain; acc + acc2; then the parts
// in order.  It depends on K and the chunk kc only (stream_chunk in
// ops/decode_step.py takes kc from the format and K), never on the row
// count, and an mma computes each output from its own row and column, so
// a row's value does not depend on how many rows share the call
// (ops/decode_step.py::bf16_dots_split_plain states the order by chunk
// and part).  The one-row path (bf16_row_dots) and the plain version
// (bf16_matmul_plain) sum the same exact products in other orders; where
// the products' exponents span fewer than 53 - 16 - log2(K) bits, as in
// every checked shape, every order gives the exact sum and the same f32.
//
// What bounds it on the H100: the weight bytes (3.43 GB w8, 3.64 GB g32
// with its scales, 6.86 GB bf16 a step) at 3.35 TB/s; in g32 also the f64
// pipe, two f64 operations per (activation row, weight row, group), 13.7
// G at 64 rows (0.8 ms); in bf16 the f64 pipe: the tensor cores, 2 x
// M x 3.43 G flops a step at 67 TFLOP/s (0.82 ms at 8 rows, 6.55 ms at
// 64), and the f32 -> f64 conversions (16 per clock and SM: once per
// weight, plus once per activation element per group).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lm_argmax.cuh"
#include "w8_common.cuh"

namespace vx {
namespace {

constexpr int kStreamParts = 4;                  // K parts: warps a block
constexpr int kStreamThreads = 32 * kStreamParts;
constexpr int kStreamMaxM = 64;                  // rows of one pass
constexpr int kStreamMaxStages = 4;
constexpr int kStreamRingRows = 8;  // bf16 / g32 rows staged in a slot
constexpr size_t kStreamSmemMax = 232448;        // a block's most (227 KB)

// The geometry of a weight format: element bytes, output rows a group,
// activation rows an mma tile, k elements a step (kc's multiple), the
// partial sums' bytes.
struct StreamFmt {
  int esize, rows, mrows, align, vsize;
};

__host__ __device__ constexpr StreamFmt stream_fmt(int fmt) {
  return fmt == kBf16   ? StreamFmt{2, 16, 8, 32, 8}
         : fmt == kG32  ? StreamFmt{1, 16, 8, 256, 8}
                        : StreamFmt{1, 8, 16, 64, 4};
}

// Activation rows a slot holds: bf16 and g32 passes of up to
// kStreamRingRows rows stage theirs (mt tiles of 8), larger ones read
// them from L2.
__host__ __device__ constexpr int stream_ring_rows(int fmt, int mt) {
  return fmt != kW8 && mt * 8 <= kStreamRingRows ? mt * 8 : 0;
}

// Bytes between two rows of a slot (g32: padded against bank conflicts)
// and the f16 scales a slot holds after its rows (g32: kc / 32 a weight
// row).
constexpr int kStreamG32Pad = 32;

__host__ __device__ constexpr int stream_wstride(int fmt, int kc) {
  return kc * stream_fmt(fmt).esize + (fmt == kG32 ? kStreamG32Pad : 0);
}

__host__ __device__ constexpr int stream_scale_bytes(int fmt, int kc) {
  return fmt == kG32 ? stream_fmt(fmt).rows * (kc / 16) : 0;
}

// The block's shared memory: the warps' rings (weights, then the staged
// activation rows, then g32's scales), two buffers of the warps' partial
// sums, the fold's values.  The same formula as
// ops/decode_step.py::stream_smem.
struct StreamLayout {
  size_t stage, o_merge, o_ys, smem;
  __host__ __device__ StreamLayout(int fmt, int mt, int kc, int stages) {
    const StreamFmt f = stream_fmt(fmt);
    const size_t mp = static_cast<size_t>(mt) * f.mrows;
    stage = static_cast<size_t>(f.rows + stream_ring_rows(fmt, mt)) *
                stream_wstride(fmt, kc) +
            stream_scale_bytes(fmt, kc);
    stage = (stage + 127) / 128 * 128;
    o_merge = kStreamParts * stages * stage;
    o_ys = o_merge + 2 * kStreamParts * f.rows * mp * f.vsize;
    smem = o_ys + f.rows * mp * sizeof(float);
  }
};

// Up to three segments of output rows (bf16 wq / wk / wv, w1 / w3; w8
// one), rows [0, n0) in w[0], [n0, n0 + n1) in w[1], the rest in w[2],
// each [rows, K] of ``esize``-byte elements.
struct StreamSegs {
  const char* w[3];
  int n0, n1;
};

struct StreamArgs {
  const void* x;        // [M, K] int8 (w8, g32) or bf16
  const float* sx;      // [M] row scales (w8, g32)
  StreamSegs segs;      // the weights
  const void* scale;    // w8: [N] f32; g32: [N, K/32] f16; bf16: unused
  const float* resid;   // [M, N] or NULL (may alias out)
  float* out;           // [M, N] (NULL in the fold)
  float* tmax;          // the fold: [M, groups] maxima, or NULL
  int* tidx;            //           [M, groups] first indices
  int M, N, K, kc, stages;
};

__device__ __forceinline__ const char* stream_row(const StreamSegs& s, int n,
                                                  size_t row_bytes) {
  if (n < s.n0) return s.w[0] + n * row_bytes;
  n -= s.n0;
  if (n < s.n1) return s.w[1] + n * row_bytes;
  return s.w[2] + (n - s.n1) * row_bytes;
}

// 16 bytes global -> shared, asynchronously (cp.async, L2 only).
__device__ __forceinline__ void stream_cp16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void stream_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n (0..3) of this thread's copy groups are in
// flight.
__device__ __forceinline__ void stream_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// D (16 x 8, f64) += A (16 x 8) . B (8 x 8) on the f64 tensor cores
// (sm_90): lane (g, t) holds A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4] in a0..a3, B[t][g], B[t + 4][g] in b0, b1 and
// D[g][2 t], D[g][2 t + 1], D[g + 8][2 t], D[g + 8][2 t + 1] in c.
__device__ __forceinline__ void stream_dmma16(double (&c)[4], double a0,
                                              double a1, double a2, double a3,
                                              double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// An int32 as an exact double without the conversion unit: the bits of
// 2^52 + 2^51 + 2^31 + z less that bias (one f64 add).
__device__ __forceinline__ double int_f64(int z) {
  return __hiloint2double(0x43380000, z ^ static_cast<int>(0x80000000u)) -
         6755401588539392.0;
}

// An f16 as an exact double: normal values by their bits, the rest
// (zero, subnormal, infinity, NaN) through f32.
__device__ __forceinline__ double f16_f64(__half h) {
  const unsigned u = __half_as_ushort(h);
  const unsigned e = u & 0x7c00u;
  if (e == 0 || e == 0x7c00u)
    return static_cast<double>(__half2float(h));
  return __hiloint2double(
      static_cast<int>(((u & 0x8000u) << 16) |
                       (((u & 0x7fffu) << 10) + 0x3F000000u)),
      0);
}

// The e-th bf16 of a 16-byte fragment as an exact double.
__device__ __forceinline__ double bf16_f64(const int4& v, int e) {
  const uint32_t w = reinterpret_cast<const uint32_t*>(&v)[e >> 1];
  const uint32_t b = (e & 1) ? (w & 0xFFFF0000u) : (w << 16);
  return static_cast<double>(__uint_as_float(b));
}

// Blocks an SM holds of a kernel: the register budget the plan assumes
// (ops/decode_step.py::stream_plan).
template <int MT>
constexpr int stream_min_blocks() {
  return MT <= 4 ? 4 : 2;
}

template <int Fmt, int MT>
__global__ void __launch_bounds__(kStreamThreads, stream_min_blocks<MT>())
    k1_stream_kernel(const StreamArgs a) {
  constexpr StreamFmt F = stream_fmt(Fmt);
  constexpr int R = F.rows, MP = MT * F.mrows;
  constexpr int AR = stream_ring_rows(Fmt, MT);  // staged activation rows
  // Fragment accumulators [MT][4] in two chains, acc and acc2 (the
  // first and second half of each step's products, g32 the even and odd
  // groups, so the latencies overlap), added at the group's end: w8
  // int32, rows 16 i + 8 h + g and columns 2 t + e of the group's 8;
  // bf16 and g32 f64, weight rows g + 8 h, activation rows 8 i + 2 t + e.
  using acc_t = typename std::conditional<Fmt == kW8, int, double>::type;
  constexpr int NA = 4;
  pdl_trigger();  // what the next launch touches, it waits for
  extern __shared__ __align__(16) unsigned char smem[];
  const StreamLayout ly(Fmt, MT, a.kc, a.stages);
  const int lane = threadIdx.x & 31, part = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.stages, K = a.K, kc = a.kc, M = a.M;
  const int part_k = K / kStreamParts, nc = part_k / kc;
  const int groups = (a.N + R - 1) / R;
  const int mine = static_cast<int>(blockIdx.x) < groups
                       ? (groups - 1 - static_cast<int>(blockIdx.x)) /
                                 static_cast<int>(gridDim.x) + 1
                       : 0;
  const int total = mine * nc;  // chunks this warp streams
  unsigned char* ring = smem + static_cast<size_t>(part) * S * ly.stage;
  const size_t row_bytes = static_cast<size_t>(K) * F.esize;
  const int chunk_bytes = kc * F.esize;
  const int row16 = chunk_bytes / 16;  // 16-byte pieces of a chunk row
  const int wst = stream_wstride(Fmt, kc);  // a row's bytes in a slot
  const char* gsc = static_cast<const char*>(a.scale);  // g32: [N, K/32]
  const char* xrow = static_cast<const char*>(a.x);
  // Chunk q of this warp: group blockIdx.x + (q / nc) * gridDim.x, k
  // elements part * part_k + (q % nc) * kc, into slot q % S; each row's
  // pieces spread over the lanes.  ``acts``: also the activation rows
  // the slot stages (only after pdl_wait).  One copy group a chunk.
  auto issue = [&](int q, bool acts) {
    if (Fmt == kG32 && q < total) {
      // 16-byte piece j of the chunk (kc = 256, prepare_stream: 16 a
      // row, two rows a warp instruction): the weight rows, the
      // activation rows (after the wait), then one piece of scales a
      // weight row.
      const int grp = blockIdx.x + (q / nc) * gridDim.x;
      const size_t k0 = static_cast<size_t>(part * part_k + (q % nc) * kc);
      const int nv = min(R, a.N - grp * R);
      const int na = acts ? min(M, AR) : 0;
      unsigned char* slot = ring + (q % S) * ly.stage;
      const char* w0 = stream_row(a.segs, grp * R, row_bytes) + k0;
      for (int j = lane; j < 16 * (nv + na) + nv; j += 32) {
        const int r = j >> 4, p = j & 15;
        if (r < nv)
          stream_cp16(slot + r * wst + 16 * p, w0 + r * row_bytes + 16 * p);
        else if (r < nv + na)
          stream_cp16(slot + (R + r - nv) * wst + 16 * p,
                      xrow + (r - nv) * row_bytes + k0 + 16 * p);
        else
          stream_cp16(slot + (R + AR) * wst + (j - 16 * (nv + na)) * 16,
                      gsc + static_cast<size_t>(grp * R + j -
                                                16 * (nv + na)) *
                                (K / 16) + k0 / 16);
      }
    } else if (q < total) {
      const int grp = blockIdx.x + (q / nc) * gridDim.x;
      const size_t k0b = static_cast<size_t>(part * part_k + (q % nc) * kc) *
                         F.esize;
      const int nv = min(R, a.N - grp * R);
      unsigned char* slot = ring + (q % S) * ly.stage;
      // The group's rows are consecutive rows of one segment unless it
      // straddles a segment's end (never at the model's widths).
      const char* first = stream_row(a.segs, grp * R, row_bytes) + k0b;
      const bool flat = stream_row(a.segs, grp * R + nv - 1, row_bytes) + k0b ==
                        first + (nv - 1) * row_bytes;
#pragma unroll 4
      for (int r = 0; r < nv; ++r) {
        const char* src =
            flat ? first + r * row_bytes
                 : stream_row(a.segs, grp * R + r, row_bytes) + k0b;
        for (int o = lane; o < row16; o += 32)
          stream_cp16(slot + r * wst + 16 * o, src + 16 * o);
      }
      if (acts)
        for (int m = 0; m < min(M, AR); ++m)
          for (int o = lane; o < row16; o += 32)
            stream_cp16(slot + (R + m) * wst + 16 * o,
                        xrow + m * row_bytes + k0b + 16 * o);
    }
    stream_commit();  // an empty group keeps the wait count uniform
  };
  for (int q = 0; q < S - 1; ++q) issue(q, false);
  pdl_wait();  // x, sx, resid and out belong to the previous launches
  xrow = after_wait(xrow);  // the rows' loads below stay after the wait
  if (AR > 0) {  // the activation rows of the chunks issued ahead
    for (int q = 0; q < min(S - 1, total); ++q) {
      const size_t k0b = static_cast<size_t>(part * part_k + (q % nc) * kc) *
                         F.esize;
      unsigned char* slot = ring + (q % S) * ly.stage;
      for (int m = 0; m < min(M, AR); ++m)
        for (int o = lane; o < row16; o += 32)
          *reinterpret_cast<int4*>(slot + (R + m) * wst + 16 * o) =
              __ldg(reinterpret_cast<const int4*>(xrow + m * row_bytes + k0b +
                                                  16 * o));
    }
  }

  acc_t* merge = reinterpret_cast<acc_t*>(smem + ly.o_merge);
  float* ys = reinterpret_cast<float*>(smem + ly.o_ys);
  const int mv = min(M, MP);
  acc_t acc[MT][NA], acc2[MT][NA];
  // The epilogue's operands of this thread's outputs (idx = threadIdx.x
  // + kStreamThreads u: row n = idx / mv, activation row m = idx % mv),
  // fetched when a group starts so their latency hides behind its
  // chunks: the w8 row scale, the residual.
  constexpr int kEpi = (R * MP + kStreamThreads - 1) / kStreamThreads;
  float pre_s[kEpi], pre_r[kEpi];
  for (int q = 0; q < total; ++q) {
    const int c = q % nc, j = q / nc;
    const int grp = blockIdx.x + j * gridDim.x;
    const int k0 = part * part_k + c * kc;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < NA; ++e) acc[i][e] = acc2[i][e] = 0;
#pragma unroll
      for (int u = 0; u < kEpi; ++u) {
        const int idx = threadIdx.x + kStreamThreads * u;
        const int n = idx / mv, m = idx % mv, nn = grp * R + n;
        const bool in = idx < R * mv && nn < a.N;
        pre_s[u] = (Fmt == kW8 && in)
                       ? static_cast<const float*>(a.scale)[nn] : 0.0f;
        pre_r[u] = (a.resid != nullptr && in)
                       ? a.resid[static_cast<size_t>(m) * a.N + nn] : 0.0f;
      }
    }
    issue(q + S - 1, AR > 0);  // into the slot the previous chunk left
    stream_wait(S - 1);
    __syncwarp();  // every lane's pieces of chunk q have landed
    const unsigned char* st = ring + (q % S) * ly.stage;
    if constexpr (Fmt == kW8) {
      const int8_t* xq = reinterpret_cast<const int8_t*>(xrow);
      const int steps = kc / 64;
      // This lane's activation fragments at step s (rows 16 i + g and
      // 16 i + 8 + g, 16 bytes at k0 + 64 s + 16 t), one step ahead.
      int4 lo[MT], hi[MT];
      auto load = [&](int s, int4 (&l)[MT], int4 (&h)[MT]) {
        const int kk = k0 + 64 * s + 16 * t;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int m0 = 16 * i + g, m1 = m0 + 8;
          l[i] = m0 < M ? __ldg(reinterpret_cast<const int4*>(
                              xq + static_cast<size_t>(m0) * K + kk))
                        : make_int4(0, 0, 0, 0);
          h[i] = m1 < M ? __ldg(reinterpret_cast<const int4*>(
                              xq + static_cast<size_t>(m1) * K + kk))
                        : make_int4(0, 0, 0, 0);
        }
      };
      load(0, lo, hi);
      for (int s = 0; s < steps; ++s) {
        const int4 w = *reinterpret_cast<const int4*>(st + g * kc + 64 * s +
                                                      16 * t);
        int4 nlo[MT], nhi[MT];
        if (s + 1 < steps) load(s + 1, nlo, nhi);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_s8(acc[i], lo[i].x, hi[i].x, lo[i].y, hi[i].y, w.x, w.y);
          mma_s8(acc2[i], lo[i].z, hi[i].z, lo[i].w, hi[i].w, w.z, w.w);
        }
        if (s + 1 < steps) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            lo[i] = nlo[i];
            hi[i] = nhi[i];
          }
        }
      }
    } else if constexpr (Fmt == kG32) {
      const int8_t* xq = reinterpret_cast<const int8_t*>(xrow);
      const __half* scs =
          reinterpret_cast<const __half*>(st + (R + AR) * wst);
      const int gpr = kc / 32;  // groups of the chunk (an even count)
      // Activation fragments of group s (8 bytes at k0 + 32 s + 8 t of
      // row 8 i + g): from the slot, or from L2 one group ahead.
      int2 xa[MT], xb[MT];
      auto load = [&](int s, int2 (&v)[MT]) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int m = 8 * i + g;
          if (m >= M)
            v[i] = make_int2(0, 0);
          else if (AR > 0)
            v[i] = *reinterpret_cast<const int2*>(st + (R + m) * wst +
                                                  32 * s + 8 * t);
          else
            v[i] = __ldg(reinterpret_cast<const int2*>(
                xq + static_cast<size_t>(m) * K + k0 + 32 * s + 8 * t));
        }
      };
      // Group s into the chain ``c``: weight rows g, 8 + g of the slot,
      // their scales, one mma a row tile, four f64 fmas.
      auto group = [&](int s, acc_t (&c)[MT][NA], const int2 (&cur)[MT],
                       int2 (&nxt)[MT]) {
        const int2 w0 = *reinterpret_cast<const int2*>(st + g * wst +
                                                       32 * s + 8 * t);
        const int2 w1 = *reinterpret_cast<const int2*>(st + (8 + g) * wst +
                                                       32 * s + 8 * t);
        const double s0 = f16_f64(scs[g * gpr + s]);
        const double s1 = f16_f64(scs[(8 + g) * gpr + s]);
        if (s + 1 < gpr) load(s + 1, nxt);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          int d[4] = {0, 0, 0, 0};
          mma_s8(d, w0.x, w1.x, w0.y, w1.y, cur[i].x, cur[i].y);
          c[i][0] = fma(int_f64(d[0]), s0, c[i][0]);
          c[i][1] = fma(int_f64(d[1]), s0, c[i][1]);
          c[i][2] = fma(int_f64(d[2]), s1, c[i][2]);
          c[i][3] = fma(int_f64(d[3]), s1, c[i][3]);
        }
      };
      // One row tile: even and odd groups in two chains, so the fmas'
      // latencies overlap; more tiles give that overlap in one chain
      // (fewer registers).
      acc_t (&odd)[MT][NA] = MT == 1 ? acc2 : acc;
      load(0, xa);
      for (int s = 0; s < gpr; s += 2) {
        group(s, acc, xa, xb);
        group(s + 1, odd, xb, xa);
      }
    } else {
      const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(xrow);
      const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(st);
      const int steps = kc / 32;
      // Activation fragments of step s (8 bf16 at k0 + 32 s + 8 t of row
      // 8 i + g): from the slot, or from L2 one step ahead.
      int4 av[MT];
      auto load = [&](int s, int4 (&v)[MT]) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int m = 8 * i + g;
          if (m >= M)
            v[i] = make_int4(0, 0, 0, 0);
          else if (AR > 0)
            v[i] = *reinterpret_cast<const int4*>(ws + (R + m) * kc + 32 * s +
                                                  8 * t);
          else
            v[i] = __ldg(reinterpret_cast<const int4*>(
                xb + static_cast<size_t>(m) * K + k0 + 32 * s + 8 * t));
        }
      };
      load(0, av);
#pragma unroll 2
      for (int s = 0; s < steps; ++s) {
        // Weight rows g and 8 + g of the group, 8 bf16 each, as doubles.
        const int4 w0 = *reinterpret_cast<const int4*>(ws + g * kc + 32 * s +
                                                       8 * t);
        const int4 w1 = *reinterpret_cast<const int4*>(
            ws + (8 + g) * kc + 32 * s + 8 * t);
        int4 nav[MT];
        constexpr bool kAhead = MT <= 4;  // registers allow the prefetch
        if (kAhead && s + 1 < steps) load(s + 1, nav);
        double wd0[8], wd1[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          wd0[e] = bf16_f64(w0, e);
          wd1[e] = bf16_f64(w1, e);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          double ad[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) ad[e] = bf16_f64(av[i], e);
#pragma unroll
          for (int h = 0; h < 4; h += 2) {
            stream_dmma16(acc[i], wd0[2 * h], wd1[2 * h], wd0[2 * h + 1],
                          wd1[2 * h + 1], ad[2 * h], ad[2 * h + 1]);
            stream_dmma16(acc2[i], wd0[2 * h + 2], wd1[2 * h + 2],
                          wd0[2 * h + 3], wd1[2 * h + 3], ad[2 * h + 2],
                          ad[2 * h + 3]);
          }
        }
        if (s + 1 < steps) {
          if (kAhead) {
#pragma unroll
            for (int i = 0; i < MT; ++i) av[i] = nav[i];
          } else {
            load(s + 1, av);
          }
        }
      }
    }
    __syncwarp();  // every lane has read the slot before it is refilled
    if (c != nc - 1) continue;

    // The group's end: the warps' partials [part][R][MP] meet in buffer
    // j % 2, are added in part order, and the epilogue writes them.
    acc_t* mb = merge + static_cast<size_t>(j & 1) * kStreamParts * R * MP;
    acc_t* mine_p = mb + static_cast<size_t>(part) * R * MP;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < NA; ++e) {
        if constexpr (Fmt != kW8)
          mine_p[(8 * (e >> 1) + g) * MP + 8 * i + 2 * t + (e & 1)] =
              acc[i][e] + acc2[i][e];
        else
          mine_p[(2 * t + (e & 1)) * MP + 16 * i + 8 * (e >> 1) + g] =
              acc[i][e] + acc2[i][e];
      }
    __syncthreads();
    const int nv = min(R, a.N - grp * R);
#pragma unroll
    for (int u = 0; u < kEpi; ++u) {
      const int idx = threadIdx.x + kStreamThreads * u;
      if (idx >= R * mv) break;
      const int n = idx / mv, m = idx % mv;
      acc_t v = mb[n * MP + m];
#pragma unroll
      for (int p = 1; p < kStreamParts; ++p) v += mb[(p * R + n) * MP + m];
      float y;
      if constexpr (Fmt == kW8)
        y = w8_epilogue(v, a.sx[m], pre_s[u]);
      else if constexpr (Fmt == kG32)
        y = static_cast<float>(v) * a.sx[m];
      else
        y = static_cast<float>(v);
      if (a.tmax != nullptr) {
        ys[n * MP + m] = y;
      } else if (n < nv) {
        if (a.resid != nullptr) y = pre_r[u] + y;
        a.out[static_cast<size_t>(m) * a.N + grp * R + n] = y;
      }
    }
    if (a.tmax != nullptr) {  // the fold: the group's (max, first index)
      __syncthreads();
      if (threadIdx.x < mv) {
        const int m = threadIdx.x;
        float bv = ys[m];
        int bi = grp * R;
        for (int n = 1; n < nv; ++n)
          if (ys[n * MP + m] > bv) {
            bv = ys[n * MP + m];
            bi = grp * R + n;
          }
        a.tmax[static_cast<size_t>(m) * groups + grp] = bv;
        a.tidx[static_cast<size_t>(m) * groups + grp] = bi;
      }
    }
  }
}

// The kernel of a (format, row tiles) pair: w8 up to 4 tiles of 16 rows,
// bf16 and g32 up to 8 of 8.
template <int Fmt>
auto stream_kernel(int mt) -> decltype(&k1_stream_kernel<Fmt, 1>) {
  switch (mt) {
    case 1: return k1_stream_kernel<Fmt, 1>;
    case 2: return k1_stream_kernel<Fmt, 2>;
    case 3: return k1_stream_kernel<Fmt, 3>;
    case 4: return k1_stream_kernel<Fmt, 4>;
    default: break;
  }
  if constexpr (Fmt != kW8) {
    switch (mt) {
      case 5: return k1_stream_kernel<Fmt, 5>;
      case 6: return k1_stream_kernel<Fmt, 6>;
      case 7: return k1_stream_kernel<Fmt, 7>;
      case 8: return k1_stream_kernel<Fmt, 8>;
      default: break;
    }
  }
  return nullptr;
}

inline auto stream_kernel_of(int fmt, int mt) -> void (*)(const StreamArgs) {
  if (fmt == kBf16) return stream_kernel<kBf16>(mt);
  if (fmt == kG32) return stream_kernel<kG32>(mt);
  if (fmt == kW8) return stream_kernel<kW8>(mt);
  return nullptr;
}

// One linear's plan, from the wrapper (ops/decode_step.py::stream_plan):
// kc == 0 sends the linear to the earlier GEMVs.
struct StreamPlan {
  int kc, stages, grid;
};

// Row tiles of a pass over m rows.
inline int stream_mt(int fmt, int m) {
  const StreamFmt f = stream_fmt(fmt);
  return ((m < kStreamMaxM ? m : kStreamMaxM) + f.mrows - 1) / f.mrows;
}

// Checks a plan against the shape and lets the kernel of each pass's row
// tiles take up to kStreamSmemMax of shared memory (once a step; the
// step's linears share a kernel and differ in their rings).
inline cudaError_t prepare_stream(int fmt, int M, int K, const StreamPlan& p) {
  if (p.kc == 0) return cudaSuccess;
  const StreamFmt f = stream_fmt(fmt);
  if ((fmt != kW8 && fmt != kG32 && fmt != kBf16) || K % kStreamParts ||
      (K / kStreamParts) % p.kc || p.kc % f.align || p.stages < 1 ||
      (fmt == kG32 && p.kc != f.align) ||
      p.stages > kStreamMaxStages || p.grid < 1)
    return cudaErrorInvalidValue;
  for (int m0 = 0; m0 < M; m0 += kStreamMaxM) {
    const int mt = stream_mt(fmt, M - m0);
    const StreamLayout ly(fmt, mt, p.kc, p.stages);
    auto kern = stream_kernel_of(fmt, mt);
    if (kern == nullptr || ly.smem > kStreamSmemMax)
      return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kStreamSmemMax));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Whether the stream takes these pointers: 16-byte aligned rows (the
// 16-byte copies and fragments) and g32 scales.
inline bool stream_aligned(const void* x, const StreamSegs& s,
                           const void* scale = nullptr) {
  bool ok = aligned16(x) && (scale == nullptr || aligned16(scale));
  for (int i = 0; i < 3; ++i)
    if (s.w[i] != nullptr) ok = ok && aligned16(s.w[i]);
  return ok;
}

// The GEMV or the fold (tmax != NULL) over M rows: passes of up to 64
// rows, each a programmatic dependent launch when ``pdl``.
inline cudaError_t launch_stream(int fmt, const StreamPlan& p,
                                 StreamArgs a, cudaStream_t st, bool pdl) {
  const StreamFmt f = stream_fmt(fmt);
  const int M = a.M, groups = (a.N + f.rows - 1) / f.rows;
  const void* x0 = a.x;
  for (int m0 = 0; m0 < M; m0 += kStreamMaxM) {
    StreamArgs s = a;
    s.M = M - m0 < kStreamMaxM ? M - m0 : kStreamMaxM;
    s.x = static_cast<const char*>(x0) +
          static_cast<size_t>(m0) * a.K * f.esize;
    s.sx = a.sx ? a.sx + m0 : nullptr;
    const size_t o = static_cast<size_t>(m0) * a.N;
    s.resid = a.resid ? a.resid + o : nullptr;
    s.out = a.out ? a.out + o : nullptr;
    s.tmax = a.tmax ? a.tmax + static_cast<size_t>(m0) * groups : nullptr;
    s.tidx = a.tidx ? a.tidx + static_cast<size_t>(m0) * groups : nullptr;
    s.kc = p.kc;
    s.stages = p.stages;
    const int mt = stream_mt(fmt, s.M);
    const StreamLayout ly(fmt, mt, p.kc, p.stages);
    const cudaError_t e =
        launch_pdl(stream_kernel_of(fmt, mt), dim3(p.grid),
                   dim3(kStreamThreads), ly.smem, st, pdl, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The weight pieces a lane of the one-row GEMVs loads before pdl_wait
// (their PRE): 8 x 16 bytes, 4 KB a warp.
constexpr int kAheadPieces = 8;

// One linear on the earlier GEMVs, as K1's chain launches it: one row
// (w8 and g32 dp4a, bf16_row_dots) as a programmatic dependent launch
// when ``pdl``, the w8 and g32 warps loading their first weight pieces
// before they wait; every other row count and shape on the earlier
// launchers in plain stream order (ops/decode_step.py launches such a
// step in plain order altogether: past one row the early launches
// measured slower there).  x: int8 rows (w8, g32) or bf16; scale: w8 f32
// [N], g32 f16 [N, K/32], bf16 unused.
inline cudaError_t launch_gemv_ahead(int fmt, const void* x, const float* sx,
                                     const StreamSegs& sg, const void* scale,
                                     const float* resid, float* out, int M,
                                     int N, int K, cudaStream_t st, bool pdl) {
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const dim3 block(32 * kGemvWarps);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* codes = reinterpret_cast<const int8_t*>(sg.w[0]);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  BfSegs bs;
  bs.n0 = sg.n0;
  bs.n1 = sg.n1;
  for (int i = 0; i < 3; ++i)
    bs.w[i] = reinterpret_cast<const __nv_bfloat16*>(sg.w[i]);
  if (pdl && M == 1) {
    if (fmt == kW8)
      return launch_pdl(w8_gemv_kernel<1, kAheadPieces>, grid, block, 0, st,
                        true, xq, sx, codes, static_cast<const float*>(scale),
                        resid, out, N, K,
                        K % 16 == 0 && aligned16(x) && aligned16(codes));
    if (fmt == kG32)
      return launch_pdl(g32_gemv_kernel<1, kAheadPieces>, grid, block, 0, st,
                        true, xq, sx, codes, static_cast<const __half*>(scale),
                        resid, out, N, K);
    bool vec = K % 8 == 0 && aligned16(x);
    for (int i = 0; i < 3; ++i)
      if (bs.w[i] != nullptr) vec = vec && aligned16(bs.w[i]);
    return launch_pdl(bf16_gemv_kernel<1>, grid, block, 0, st, true, xb, bs,
                      resid, out, 1, N, K, vec);
  }
  if (fmt == kBf16)
    launch_bf16_gemv(xb, bs, resid, out, M, N, K, st);
  else if (fmt == kG32)
    launch_g32_gemv(xq, sx, codes, static_cast<const __half*>(scale), resid,
                    out, M, N, K, st);
  else
    launch_w8_gemv(xq, sx, codes, static_cast<const float*>(scale), resid,
                   out, M, N, K, st);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vx
