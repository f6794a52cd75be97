// K7: one decoder layer of a single-token w8 decode step over the
// position-major prefill cache.
//
// Port of voxtral_tpu/ops/decode_step_pallas.py::decode_layer_step
// (kernel body _make_kernel).  Its only caller is the one-shot path's
// per-layer route (models/voxtral.py, route "layer"), which decodes in
// the prefill cache [L, B, S, n_kv, hd] itself, so no head-major copy of
// the cache exists beside it.  Per call, nine launches:
//
//   row(norm)            rmsnorm x attn_norm, per-row int8 quant (reads x)
//   gemv qkv             W8A8 GEMV on layer ``layer`` of the wqkv stack
//   attn_group           pair RoPE, GQA attention over the cache slots
//                        [max(0, off - window), off) and the row itself:
//                        a block (or a cluster of blocks splitting the
//                        slots) per (row, kv head) serving its G query
//                        heads; k_new / v_new
//   row(plain)           int8 quant of the attention output
//   gemv wo (+ x)        residual fused into the epilogue, written to xo
//   row(norm, ada)       rmsnorm x ffn_norm x ADA vector, int8 quant
//   gemv w13
//   row(swiglu)          silu(gate) * up, int8 quant
//   gemv w2 (+ xo)
//
// The row kernel is K1's row_quant (decode_common.cuh); the GEMVs are
// w8_common.cuh's: dp4a GEMVs up to 8 rows (two weight rows a warp up to
// 4 rows, one above) and from 9 rows the int8 tensor-core GEMV with K
// split over the warps of a block, all indexed by ``layer`` into the
// stacks.
// With ``pdl`` every launch is a programmatic dependent launch: it may
// start while its predecessor runs and waits (pdl_wait) before it
// touches what the predecessor writes; the dp4a GEMV loads its first
// weight pieces, the row kernel its norm weights, the attention its
// first cache slots, before that wait.
//
// What differs from K1's attention is the rounding of the JAX kernel:
// the scaled q stays f32 against the bf16 cache (K1 rounds it to bf16),
// and the softmax weights stay f32 for P.V (K1 rounds them to bf16).
// f32 x bf16 products are exact in f64, so scores and P.V sum in f64;
// the softmax takes expf(s - m) against the max over every visible slot
// and the self score, whatever block holds the slot.
//
// What bounds it on the H100: the layer's int8 weights, 116.39 MB at
// full width (0.0347 ms at 3.35 TB/s), plus the visible cache slots,
// 512 bytes a slot and kv head.  The attention reads each slot once for
// the G query heads of its kv head: the cache rows stream through a ring
// of shared-memory stages by cp.async (keys, then values, seven stages
// of 32 slots in flight, so a short span is requested at once); a span
// is cut over a thread-block cluster (ops/decode_step.py::layer_attn_plan)
// whose blocks exchange their maxima and merge denominators and P.V
// partials through distributed shared memory in rank order
// (ops/decode_step.py::layer_attention_split_plain states the
// arithmetic).
//
// Bit-for-bit with the plain version (ops/decode_step.py::
// decode_layer_step_plain): every float reduction accumulates in f64 and
// rounds once to f32, and the build passes -fmad=false.
#include <cuda_bf16.h>
#include <math.h>

#include "decode_common.cuh"
#include "w8_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace vx {
namespace {

constexpr int kChunk = 32;       // cache slots a ring stage holds
constexpr int kStages = 8;       // ring stages, kStages - 1 in flight
constexpr int kMaxPieces = 8;    // blocks of a cluster (portable size)
constexpr int kMaxGroup = 8;     // query heads a kv head serves
// Dynamic shared memory a block may take: the 227 KB of an H100 block
// less room for the kernel's static arrays.
constexpr int kLayerSmem = 225 * 1024;

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes of a block's scores (f32) and softmax weights (f64), G x piece
// each, 16-byte aligned.
__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t scores_bytes(int G, int piece) {
  return align16(sizeof(float) * G * piece) +
         align16(sizeof(double) * G * piece);
}

// Dynamic shared memory of a block, in this order: the stage ring (later
// the slot groups' P.V partials), q as f64 [G][hd], the block's P.V sums
// f64 [G][hd], k and v f32 [hd], then the scores and weights unless they
// live in the scratch buffer (``global``: when they would not fit).
struct GroupGeo {
  int row;      // bytes between two staged cache rows (hd * 2 + 16)
  int ring;     // bytes of the stage ring
  bool global;
  size_t smem;
};

inline GroupGeo attn_geometry(int G, int hd, int piece) {
  GroupGeo g;
  g.row = hd * 2 + 16;
  const size_t ring = static_cast<size_t>(kStages) * kChunk * g.row;
  const size_t parts = static_cast<size_t>(kAttnThreads / (hd / 2)) * G *
                       hd * sizeof(double);
  g.ring = static_cast<int>(align16(ring > parts ? ring : parts));
  const size_t fixed = g.ring + 2 * align16(sizeof(double) * G * hd) +
                       2 * align16(sizeof(float) * hd);
  g.global = fixed + scores_bytes(G, piece) > static_cast<size_t>(kLayerSmem);
  g.smem = fixed + (g.global ? 0 : scores_bytes(G, piece));
  return g;
}

// Grid (pieces, n_kv, B); cluster (pieces, 1, 1) when pieces > 1.  Block
// (rank r, kv head jh, row b) takes the visible slots [lo + r * piece,
// min(lo + (r + 1) * piece, hi)) of its kv head for the G query heads
// h = jh G .. jh G + G - 1.  ``scratch`` holds the scores and weights
// when they do not fit shared memory (geometry.global).
template <int G>
__global__ void __launch_bounds__(kAttnThreads) attn_group_kernel(
    const float* qkv, const float* __restrict__ cosv,
    const float* __restrict__ sinv, int off,
    const __nv_bfloat16* __restrict__ kc, const __nv_bfloat16* __restrict__ vc,
    __nv_bfloat16* __restrict__ kn, __nv_bfloat16* __restrict__ vn,
    float* __restrict__ attn, char* __restrict__ scratch, int S, int window,
    int n_heads, int n_kv, int hd, float scale, int piece, int row_bytes,
    int ring_bytes, int global) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[kAttnThreads / 32][G];
  __shared__ double red_d[kAttnThreads / 32][G];
  __shared__ float pmax[G];    // this block's max, read by the cluster
  __shared__ double pden[G];   // this block's denominator partial
  __shared__ float m_sh[G], self_sh[G];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = gridDim.x, rank = blockIdx.x, jh = blockIdx.y, b = blockIdx.z;
  const int lo = window >= 0 ? max(0, off - window) : 0;
  const int hi = min(off, S);
  const int t0 = lo + rank * piece;
  const int np = max(min(piece, hi - t0), 0);  // this block's slots
  const int nchunks = (np + kChunk - 1) / kChunk;
  // The cluster's blocks in rank order (a lone block: itself).
  auto sync_all = [&]() {
    if (P > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  auto at = [&](auto* p, int r) {
    return P > 1 ? cg::this_cluster().map_shared_rank(p, r) : p;
  };

  char* ring = smem;
  double* qd = reinterpret_cast<double*>(smem + ring_bytes);       // [G][hd]
  double* pctx = qd + G * hd;                                     // [G][hd]
  float* kf = reinterpret_cast<float*>(pctx + G * hd);            // [hd]
  float* vf = kf + ((hd + 3) & ~3);                               // [hd]
  float* sc;
  double* ed;
  if (global) {  // a region of scores_bytes(G, piece) per block
    const size_t blk = (static_cast<size_t>(b) * n_kv + jh) * P + rank;
    char* base = scratch + blk * scores_bytes(G, piece);
    sc = reinterpret_cast<float*>(base);
    ed = reinterpret_cast<double*>(base + align16(sizeof(float) * G * piece));
  } else {
    sc = vf + ((hd + 3) & ~3);
    ed = reinterpret_cast<double*>(
        reinterpret_cast<char*>(sc) + align16(sizeof(float) * G * piece));
  }

  // The cache rows stream through the ring: chunk i < nchunks holds keys
  // of slots t0 + 32 i .., chunk nchunks + i the values.  Rows past the
  // block's slots are not loaded (and not read).
  const size_t stride = static_cast<size_t>(n_kv) * hd;  // between slots
  const size_t head = (static_cast<size_t>(b) * S * n_kv + jh) * hd;
  const int pieces16 = hd / 8;  // 16-byte pieces of a row
  auto issue = [&](int i) {
    if (i < 2 * nchunks) {
      const bool val = i >= nchunks;
      const int c = val ? i - nchunks : i;
      const __nv_bfloat16* base = (val ? vc : kc) + head;
      char* dst = ring + static_cast<size_t>(i % kStages) * kChunk * row_bytes;
      const int rows = min(kChunk, np - c * kChunk);
      for (int e = tid; e < rows * pieces16; e += kAttnThreads) {
        const int r = e / pieces16, p = e - r * pieces16;
        cp16(dst + r * row_bytes + 16 * p,
             base + static_cast<size_t>(t0 + c * kChunk + r) * stride + 8 * p);
      }
    }
    cp_commit();
  };
  // The cache belongs to the caller: its first stages stream while the
  // predecessor ends.
#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  pdl_trigger();
  pdl_wait();

  // Prologue: pair RoPE of the G query heads (scaled, as f64) and of k;
  // v; k_new / v_new (block rank 0 writes them).
  const int nq = n_heads * hd, nkv = n_kv * hd, ld = nq + 2 * nkv;
  const float* qrow = qkv + static_cast<size_t>(b) * ld;
  const float* kh = qrow + nq + static_cast<size_t>(jh) * hd;
  const float* vh = kh + nkv;
  for (int i = tid; i < G * hd; i += kAttnThreads) {
    const int g = i / hd, d = i - g * hd;
    const float* qh = qrow + static_cast<size_t>(jh * G + g) * hd;
    const float q = (qh[d] * cosv[d] + qh[d ^ 1] * sinv[d]) * scale;
    qd[i] = static_cast<double>(q);
  }
  const size_t kvo = (static_cast<size_t>(b) * n_kv + jh) * hd;
  for (int d = tid; d < hd; d += kAttnThreads) {
    const float k = kh[d] * cosv[d] + kh[d ^ 1] * sinv[d];
    kf[d] = k;
    vf[d] = vh[d];
    if (rank == 0) {
      kn[kvo + d] = __float2bfloat16(k);
      vn[kvo + d] = __float2bfloat16(vh[d]);
    }
  }
  __syncthreads();
  // Self scores: the f32 q and k, f64 sums (every block, the same value).
  for (int g = warp; g < G; g += kAttnThreads / 32) {
    double p = 0.0;
    for (int d = lane; d < hd; d += 32) p += qd[g * hd + d] * kf[d];
    p = warp_sum_d(p);
    if (lane == 0) self_sh[g] = static_cast<float>(p);
  }

  // Pass 1, keys: 8 threads a slot, hd / 8 dims each, the G heads at
  // once; the f64 partials added over the 8 lanes.  The scores of the
  // block's slots stay (shared memory or scratch) for the softmax.
  const int slot_l = tid >> 3, part = tid & 7;
  const int dpt = hd / 8;  // dims a thread
  // Pass 2, values: thread (dim pair dp, slot group sg).
  const int pairs = hd / 2, ngroups = kAttnThreads / pairs;
  const int dp = tid % pairs, sg = tid / pairs;
  double acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.0;

  // Between the passes: the block's max per head, the cluster's with the
  // self score, the weights expf(s - m) and the block's denominator
  // partials (f64).
  auto softmax = [&]() {
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = -INFINITY;
    for (int t = tid; t < np; t += kAttnThreads)
#pragma unroll
      for (int g = 0; g < G; ++g) mx[g] = fmaxf(mx[g], sc[g * piece + t]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mx[g] = warp_max(mx[g]);
      if (lane == 0) red[warp][g] = mx[g];
    }
    __syncthreads();
    if (tid < G) {
      float v = -INFINITY;
      for (int w = 0; w < kAttnThreads / 32; ++w) v = fmaxf(v, red[w][tid]);
      pmax[tid] = v;
    }
    sync_all();
    if (tid < G) {
      float v = self_sh[tid];
      for (int r = 0; r < P; ++r) v = fmaxf(v, at(pmax, r)[tid]);
      m_sh[tid] = v;
    }
    __syncthreads();
    double sum[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sum[g] = 0.0;
    for (int t = tid; t < np; t += kAttnThreads)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float e = expf(sc[g * piece + t] - m_sh[g]);
        ed[g * piece + t] = e;
        sum[g] += e;
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sum[g] = warp_sum_d(sum[g]);
      if (lane == 0) red_d[warp][g] = sum[g];
    }
    __syncthreads();
    if (tid < G) {
      double v = 0.0;
      for (int w = 0; w < kAttnThreads / 32; ++w) v += red_d[w][tid];
      pden[tid] = v;
    }
    __syncthreads();  // the weights are written
  };

  for (int i = 0; i < 2 * nchunks; ++i) {
    issue(i + kStages - 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    const char* stage = ring + static_cast<size_t>(i % kStages) * kChunk * row_bytes;
    if (i < nchunks) {
      const int t = i * kChunk + slot_l;  // slot within the piece
      double p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) p[g] = 0.0;
      if (t < np) {
        // Lane part takes the dim pairs part, part + 8, ...: neighbouring
        // lanes on neighbouring bytes of the row and of q.
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(
            stage + slot_l * row_bytes);
        for (int e = 0; e < dpt / 2; ++e) {
          const int pi = part + 8 * e;
          const float2 kv = __bfloat1622float2(kr[pi]);
          const double k0 = kv.x, k1 = kv.y;
          const int d = 2 * pi;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            p[g] += qd[g * hd + d] * k0;
            p[g] += qd[g * hd + d + 1] * k1;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          p[g] += __shfl_xor_sync(0xffffffffu, p[g], o);
      }
      if (part == 0 && t < np) {
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g * piece + t] = static_cast<float>(p[g]);
      }
    } else {
      const int c = i - nchunks;
      const int rows = min(kChunk, np - c * kChunk);
      for (int r = sg; r < rows; r += ngroups) {
        const float2 v2 = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(stage + r * row_bytes)[dp]);
        const double v0 = v2.x, v1 = v2.y;
        const int t = c * kChunk + r;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const double w = ed[g * piece + t];
          acc[g][0] += w * v0;
          acc[g][1] += w * v1;
        }
      }
    }
    __syncthreads();
    if (i == nchunks - 1) softmax();
  }
  if (nchunks == 0) softmax();  // no visible slot here: max -inf, sum 0
  cp_wait<0>();
  __syncthreads();
  // The slot groups' P.V partials, added in group order.
  double* parts = reinterpret_cast<double*>(ring);  // [ngroups][G][hd]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    parts[(sg * G + g) * hd + 2 * dp] = acc[g][0];
    parts[(sg * G + g) * hd + 2 * dp + 1] = acc[g][1];
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kAttnThreads) {
    double v = 0.0;
    for (int q = 0; q < ngroups; ++q) v += parts[q * G * hd + i];
    pctx[i] = v;
  }
  sync_all();
  // The pieces' partials, in rank order; block r writes its 1/P of the
  // G x hd outputs.
  const int outs = G * hd, per = (outs + P - 1) / P;
  for (int i = rank * per + tid; i < min(outs, (rank + 1) * per);
       i += kAttnThreads) {
    const int g = i / hd, d = i - g * hd;
    double cx = 0.0, dn = 0.0;
    for (int r = 0; r < P; ++r) {
      cx += at(pctx, r)[i];
      dn += at(pden, r)[g];
    }
    const float e_self = expf(self_sh[g] - m_sh[g]);
    const float ctx = static_cast<float>(cx) + e_self * vf[d];
    const float den = static_cast<float>(dn) + e_self;
    attn[static_cast<size_t>(b) * nq + static_cast<size_t>(jh * G + g) * hd +
         d] = ctx / den;
  }
  if (P > 1) cg::this_cluster().sync();  // no block leaves while read
}

// The attention over a cluster of ``pieces`` blocks (1 .. 8) of
// ``piece`` visible slots each, G = n_heads / n_kv in {1, 2, 4, 8}.
template <int G>
cudaError_t launch_group_attention(const float* qkv, const float* cosv,
                                   const float* sinv, int off,
                                   const __nv_bfloat16* kc,
                                   const __nv_bfloat16* vc, __nv_bfloat16* kn,
                                   __nv_bfloat16* vn, float* att,
                                   char* scratch, int B, int S, int window,
                                   int n_heads, int n_kv, int hd, float scale,
                                   int pieces, int piece, cudaStream_t st,
                                   bool pdl) {
  const GroupGeo geo = attn_geometry(G, hd, piece);
  if (geo.smem > static_cast<size_t>(kLayerSmem) ||
      (geo.global && scratch == nullptr))
    return cudaErrorInvalidValue;
  static unsigned attr_set = 0;  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(attr_set >> dev & 1u)) {
    e = cudaFuncSetAttribute(attn_group_kernel<G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kLayerSmem);
    if (e != cudaSuccess) return e;
    if (dev < 32) attr_set |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pieces, n_kv, B);
  cfg.blockDim = dim3(kAttnThreads, 1, 1);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int na = 0;
  if (pieces > 1) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = pieces;
    attr[na].val.clusterDim.y = 1;
    attr[na].val.clusterDim.z = 1;
    ++na;
  }
  if (pdl) {
    attr[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[na].val.programmaticStreamSerializationAllowed = 1;
    ++na;
  }
  cfg.attrs = attr;
  cfg.numAttrs = na;
  return cudaLaunchKernelEx(&cfg, attn_group_kernel<G>, qkv, cosv, sinv, off,
                            kc, vc, kn, vn, att, scratch, S, window, n_heads,
                            n_kv, hd, scale, piece, geo.row, geo.ring,
                            static_cast<int>(geo.global));
}

// One linear over the rows row_quant wrote.  Up to 8 rows the dp4a GEMV
// of w8_common.cuh (w8_gemv_kernel), loading its first weight pieces
// before it waits: two weight rows a warp up to 4 rows (3-5 us a layer
// faster on the H100 there), one above; from 9 rows, and
// for shapes the 16-byte loads cannot take, launch_w8_gemv's choice (the
// int8 tensor-core GEMV up to 64 rows, one weight pass for all rows).
// ``pdl`` only sets the launch attribute.  The int32 sums are exact:
// every route gives the same bits.
constexpr int kAhead = 8;     // 16-byte weight pieces a lane loads early
constexpr int kAheadPair = 4;  // the same, two weight rows a warp

inline cudaError_t layer_gemv(const int8_t* xq, const float* sx,
                              const int8_t* codes, const float* scale,
                              const float* resid, float* out, int M, int N,
                              int K, cudaStream_t st, bool pdl) {
  const bool vec = K % 16 == 0 && aligned16(xq) && aligned16(codes);
  if (M > kDp4aMaxM || !vec)
    return launch_w8_gemv(xq, sx, codes, scale, resid, out, M, N, K, st,
                          pdl);
  const dim3 block(32 * kGemvWarps);
  const dim3 grid1((N + kGemvWarps - 1) / kGemvWarps);
  const dim3 grid2((N + 2 * kGemvWarps - 1) / (2 * kGemvWarps));
  switch (M) {
#define VX_LAYER_GEMV(MM, PRE, R, GRID)                                   \
  case MM:                                                                \
    return launch_pdl(w8_gemv_kernel<MM, PRE, R>, GRID, block, 0, st, pdl, \
                      xq, sx, codes, scale, resid, out, N, K, true);
    VX_LAYER_GEMV(1, kAheadPair, 2, grid2)
    VX_LAYER_GEMV(2, kAheadPair, 2, grid2)
    VX_LAYER_GEMV(3, kAheadPair, 2, grid2)
    VX_LAYER_GEMV(4, kAheadPair, 2, grid2)
    VX_LAYER_GEMV(5, kAhead, 1, grid1)
    VX_LAYER_GEMV(6, kAhead, 1, grid1)
    VX_LAYER_GEMV(7, kAhead, 1, grid1)
    VX_LAYER_GEMV(8, kAhead, 1, grid1)
#undef VX_LAYER_GEMV
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vx

// The scratch bytes a block of K7's attention needs for its scores and
// softmax weights (G = n_heads / n_kv query heads, ``piece`` slots a
// block) where they do not fit its shared memory, else 0
// (attn_geometry): the caller gives vx_decode_layer_step B x n_kv x
// pieces of them.  -1: no layout fits.
extern "C" int vx_layer_attn_scratch(int G, int hd, int piece,
                                     long long* bytes) {
  using namespace vx;
  if (G < 1 || G > kMaxGroup || hd < 16 || hd > kMaxHeadDim || piece < 0) {
    *bytes = -1;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GroupGeo g = attn_geometry(G, hd, piece);
  *bytes = g.smem > static_cast<size_t>(kLayerSmem)
               ? -1
               : (g.global ? static_cast<long long>(scores_bytes(G, piece))
                           : 0);
  return 0;
}

// All pointers are device pointers.  x, xo [B, D] f32; attn_norm,
// ffn_norm, ada [D] f32 (layer ``layer``'s); sqkv [nq + 2 nkv], so [D],
// s13 [2F], s2 [D] f32 row scales of layer ``layer``; cos / sin [hd] f32,
// pair-expanded, at position ``off``; kc / vc [B, S, n_kv, hd] bf16, the
// layer's position-major cache (read at slots < off only); the stacked
// int8 weights wqkv [L, nq + 2 nkv, D], wo [L, D, nq], w13 [L, 2F, D],
// w2 [L, D, F], of which layer ``layer`` is read; kn / vn [B, n_kv, hd]
// bf16.  Scratch: xq [B, max(D, nq, F)] int8, sx [B], qkv [B, nq + 2 nkv],
// attn [B, nq], up [B, 2F] f32; ``scores`` the attention's score buffer
// when a block's scores do not fit its shared memory (else unused, may
// be NULL; vx_layer_attn_scratch says which and how much).  window < 0:
// no lower bound.  ``pieces`` / ``piece``: the attention's cluster size
// and visible slots a block (ops/decode_step.py::layer_attn_plan);
// pdl != 0: programmatic dependent launches.
extern "C" int vx_decode_layer_step(
    const void* x, void* xo, int layer, int off, const void* attn_norm,
    const void* ffn_norm, const void* ada, const void* sqkv, const void* so,
    const void* s13, const void* s2, const void* cosv, const void* sinv,
    const void* kc, const void* vc, const void* wqkv, const void* wo,
    const void* w13, const void* w2, void* kn, void* vn, void* xq_buf,
    void* sx_buf, void* qkv_buf, void* attn_buf, void* up_buf,
    void* scores_buf, int B, int D, int S, int n_heads, int n_kv, int hd,
    int F, int window, float eps, float scale, int pieces, int piece,
    int pdl_flag, void* stream) {
  using namespace vx;
  const int G = n_kv > 0 ? n_heads / n_kv : 0;
  const int lo = window >= 0 ? (off - window > 0 ? off - window : 0) : 0;
  const int n = (off < S ? off : S) - lo;
  if (hd > kMaxHeadDim || hd % 16 || kAttnThreads % (hd / 2) || n_kv <= 0 ||
      n_heads % n_kv || G > kMaxGroup || B < 1 || layer < 0 || off < 0 ||
      off > S || pieces < 1 || pieces > kMaxPieces || piece < 0 ||
      static_cast<long long>(pieces) * piece < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pdl = pdl_flag != 0;
  const int nq = n_heads * hd, nkv = n_kv * hd, nqkv = nq + 2 * nkv;
  float* X = static_cast<float*>(xo);
  const float* Xin = static_cast<const float*>(x);
  int8_t* xq = static_cast<int8_t*>(xq_buf);
  float* sx = static_cast<float*>(sx_buf);
  float* qkv = static_cast<float*>(qkv_buf);
  float* att = static_cast<float*>(attn_buf);
  float* up = static_cast<float*>(up_buf);
  // Layer ``layer`` of an [L, N, K] int8 stack.
  auto wlayer = [&](const void* base, int N, int K) {
    return static_cast<const int8_t*>(base) +
           static_cast<size_t>(layer) * N * K;
  };
  auto gemv = [&](const void* W, int N, int K, const void* scale_row,
                  const float* resid, float* out) {
    return layer_gemv(xq, sx, wlayer(W, N, K),
                      static_cast<const float*>(scale_row), resid, out, B, N,
                      K, st, pdl);
  };
  auto attention = [&]() -> cudaError_t {
    const float* cv = static_cast<const float*>(cosv);
    const float* sv = static_cast<const float*>(sinv);
    const auto* kcp = static_cast<const __nv_bfloat16*>(kc);
    const auto* vcp = static_cast<const __nv_bfloat16*>(vc);
    auto* knp = static_cast<__nv_bfloat16*>(kn);
    auto* vnp = static_cast<__nv_bfloat16*>(vn);
    char* sb = static_cast<char*>(scores_buf);
    switch (G) {
#define VX_GROUP_CASE(GG)                                                     \
  case GG:                                                                    \
    return launch_group_attention<GG>(qkv, cv, sv, off, kcp, vcp, knp, vnp,   \
                                      att, sb, B, S, window, n_heads, n_kv,   \
                                      hd, scale, pieces, piece, st, pdl);
      VX_GROUP_CASE(1)
      VX_GROUP_CASE(2)
      VX_GROUP_CASE(4)
      VX_GROUP_CASE(8)
#undef VX_GROUP_CASE
      default:
        return cudaErrorInvalidValue;
    }
  };
#define VX_TRY(call)                                      \
  do {                                                    \
    const cudaError_t e_ = (call);                        \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)
  // The first row kernel reads x itself and the wo GEMV adds x into xo,
  // so no copy of x sits in the chain.
  VX_TRY(row_quant(Xin, D, D, static_cast<const float*>(attn_norm), nullptr,
                   eps, kQuantNorm, B, xq, sx, nullptr, st, pdl));
  VX_TRY(gemv(wqkv, nqkv, D, sqkv, nullptr, qkv));
  VX_TRY(attention());
  VX_TRY(row_quant(att, nq, nq, nullptr, nullptr, eps, kQuantPlain, B, xq, sx,
                   nullptr, st, pdl));
  VX_TRY(gemv(wo, D, nq, so, Xin, X));
  VX_TRY(row_quant(X, D, D, static_cast<const float*>(ffn_norm),
                   static_cast<const float*>(ada), eps, kQuantNorm, B, xq, sx,
                   nullptr, st, pdl));
  VX_TRY(gemv(w13, 2 * F, D, s13, nullptr, up));
  VX_TRY(row_quant(up, 2 * F, F, nullptr, nullptr, eps, kQuantSwiglu, B, xq,
                   sx, nullptr, st, pdl));
  VX_TRY(gemv(w2, D, F, s2, X, X));
#undef VX_TRY
  return static_cast<int>(cudaGetLastError());
}
