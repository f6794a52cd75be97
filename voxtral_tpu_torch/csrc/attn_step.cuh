// The attention blocks of one decode step over a head-major cache,
// shared by K1 (decode_step.cu) and K4 (decode_tp.cu: the attention half
// of a tensor-parallel shard, which runs them over the shard's local
// heads with n_heads / n_kv of the shard), both through
// prepare_attention() once a step and launch_attention() a layer:
//   * attn_cluster_kernel: modes (a)-(e) and their (b) / (c) / (g)
//     combinations, over a bf16 or an int8 cache;
//   * attn_chunk_kernel: mode (f), the chunked online softmax (bf16 or
//     int8), on the same cluster walk: the chunks' running max is a
//     prefix max the blocks form from each other's piece maxima before
//     any expf, and the blocks fold the chunks' f64 sums in chunk order.
// Both launch as one cluster per (stream, kv head, group of query
// vectors), as the library's plan (attn_plan / chunk_plan) sizes them.
// Internal linkage: each translation unit has its own copy.  See
// decode_step.cu for the rounding points the blocks share with the
// plain versions (ops/decode_step.py::_attention_plain).
//
// attn_cluster_kernel replaces the attention of the Pallas kernels
// decode_step_pallas.py::_make_stack_kernel (:783-1180, build_valid /
// scores_of / ctx_of) and decode_tp_pallas.py::_make_attn_half.  What
// bounds it on the H100: the bytes of the visible cache slots (K and V,
// 2 x 256 bytes a slot and kv head in bf16, half in int8; 0.87 GB a step
// for one unbounded stream at full window, 0.26 ms of HBM) and, for many
// query rows, the f64 multiply-adds of the exact sums.  In practice a
// block's chain of dependent steps (tile waits, barriers, the products
// and the cluster merges, with 8 warps an SM) keeps it several times
// above both.  An earlier design
// ran one block per (row, query head) walking all S slots alone: 32
// blocks for one stream on 132 SMs, every K/V row read G = 4 times, one
// thread per slot reading rows 256 bytes apart, and every ring slot
// walked, written or not.  This one:
//   * one thread-block cluster per (stream, kv head, group of query
//     vectors), C blocks (up to 16) splitting the stream's visible slot
//     range into C contiguous pieces;
//   * each block serves every query vector of its group (the G query
//     heads of the kv head times its draft rows), so a K/V row is read
//     from HBM once per stream when the group holds them all;
//   * K then V tiles of kTileSlots rows staged in shared memory by
//     16-byte cp.async in a ring of kAttnStages tiles, rows padded so a
//     warp's fragment loads fall on distinct banks;
//   * the dot products on the f64 tensor cores (mma.m8n8k4): the scores
//     as (8 query vectors x 4 dims) . (4 dims x 8 slots), P.V as (8
//     vectors x 4 slots) . (4 slots x 8 dims), every cache value turned
//     to f64 once a block;
//   * only the slots that can be visible are walked: bounded
//     [max(0, off + j_lo - window), min(off, S)); head+ring the written
//     slots [0, min(off, head)) and [head, head + min(size, off - head)),
//     with the per-slot window test of ring_visible;
//   * the softmax's cross-block terms go through distributed shared
//     memory (cluster.sync(), map_shared_rank): the f32 max (over the
//     cache, fresh and self scores), in mode (e) the absmax of weights x
//     v scales that sets the row's requant group, and the partial sums,
//     which block 0 adds in block order (f64 denominators and P.V; in
//     int8 the P.V sums are exact integers) before it adds the fresh and self
//     terms in f32 in the order of the per-row walk, rounds once, and
//     writes the output and k_new / v_new.
// Why the split keeps bit-equality: every product the walk sums is
// exact (bf16(q) x bf16 k and a bf16 weight x bf16 v in f64, or int8 x
// int8); the sums are f64 (exact integers in int8), each rounded to f32
// once, so the order of the slices, the tensor cores and the lanes only
// moves f64 round-off far below the f32 rounding (the plain version
// already sums in torch's f64 bmm order); max and absmax do not depend
// on order.  The rounding points
// stay where the per-row walk had them: expf(s - m) with the global m,
// round_bf16 of the weight, and the requant's rintf with the row's se.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "decode_common.cuh"

namespace vx {
namespace {

namespace cg = cooperative_groups;

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

constexpr int kMaxVec = 32;      // query vectors a cluster serves
constexpr int kMaxCluster = 16;  // blocks a cluster (non-portable above 8)
constexpr int kTileSlots = 64;   // cache rows per staged tile
constexpr int kAttnStages = 3;   // staged tiles in the ring
constexpr int kClusterBlocks = 128;  // blocks a launch aims at (132 SMs)
// Spec rows over spans of at most this many tiles: clusters of one tile
// a block (benches/torch_chunk_times.py measured K4 and K1 at 8 rows over
// 158 slots faster that way than with fewer, longer pieces, and slower with one
// block a vector group).
constexpr int kShortTiles = 3;
constexpr size_t kSmemTarget = 113 * 1024;  // two blocks an SM
constexpr size_t kSmemMax = 227 * 1024;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Shared memory of one cluster block, and how its warps split the
// work; the host sizes the launch with it, the device finds its arrays.
// rv: query vectors a cluster serves; piece: score slots a block holds.
// The dot products run on the f64 tensor cores (mma.m8n8k4, 8-row tiles
// of query vectors, n8 rows): the scores over 16-dim blocks (nblk), one
// warp per 8 slots of a tile, P.V over 32-dim groups (n_dg) with the
// tile's slots split over ksp warps.
struct AttnLayout {
  int row_bytes, chunk, stride;  // a cache row, its cp.async pieces, padded
  int n8, nblk, qs, n_dg, ksp;
  size_t o_qp, o_qq, o_sq, o_sc, o_ksv, o_small, o_fs, o_fk, total;
  __host__ __device__ AttnLayout(int hd, int rv, int piece, int spec,
                                 bool int8) {
    const int esize = int8 ? 1 : 2;
    row_bytes = hd * esize;
    chunk = row_bytes % 16 == 0 ? 16 : 4;
    // The inner loops read up to ceil(hd / 32) * 32 values a row; rows of
    // 8 mod 32 words put the 8-byte (bf16) and 4-byte (int8) fragment
    // loads of a warp on distinct banks.
    int words = ceil_div(ceil_div(hd, 32) * 32 * esize, 4);
    words += ((8 - words % 32) + 32) % 32;
    stride = 4 * words;
    n8 = ceil_div(rv, 8) * 8;
    nblk = ceil_div(hd, 16);
    qs = 16 * nblk + 4;
    n_dg = ceil_div(hd, 32);
    ksp = n_dg >= 8 ? 1 : 8 / n_dg;
    // The tile ring, which block 0 also uses to stage the group's q and
    // the stream's fresh rows (k, then v and the int8 codes).
    size_t o = static_cast<size_t>(kAttnStages) * kTileSlots * stride;
    const size_t stage_q = sizeof(float) * static_cast<size_t>(rv + spec) * hd;
    const size_t stage_v =
        sizeof(float) * (static_cast<size_t>(2 * spec) * hd + rv * spec);
    if (o < stage_q) o = stage_q;
    if (o < stage_v) o = stage_v;
    o = align16(o);
    o_qp = o;  // q as doubles [n8][qs] (permuted), later the P.V partial
    const size_t qp = sizeof(double) * static_cast<size_t>(n8) * qs;
    const size_t pv = sizeof(double) * static_cast<size_t>(n8) * hd;
    o += align16(qp > pv ? qp : pv);
    o_qq = o;  // int8: q's codes [rv][hd]
    o += int8 ? align16(static_cast<size_t>(rv) * hd) : 0;
    o_sq = o;  // int8: q's scale per vector
    o += align16(sizeof(float) * rv);
    o_sc = o;  // scores, then weights (bf16) or requant codes (int8)
    o += align16(sizeof(float) * static_cast<size_t>(rv) * piece);
    o_ksv = o;  // int8: the piece's k and v scales [2][piece]
    o += int8 ? align16(2 * sizeof(float) * static_cast<size_t>(piece)) : 0;
    o_small = o;  // per vector: den (f64), then 7 f32 arrays
    o += align16(sizeof(double) * kMaxVec + 7 * sizeof(float) * kMaxVec);
    o_fs = o;  // block 0: fresh scores, then weights [rv][spec]
    o += align16(sizeof(float) * static_cast<size_t>(rv) * spec);
    o_fk = o;  // block 0, int8: fresh rows' k / v scales and k codes
    o += int8 ? align16(2 * sizeof(float) * spec +
                        static_cast<size_t>(spec) * hd)
              : 0;
    total = o;
  }
};

// The launch shape of attn_cluster_kernel: ``cluster`` blocks per
// cluster, ``rv`` query vectors per cluster, ``n_vg`` clusters per
// (stream, kv head), ``piece`` score slots per block.
struct AttnPlan {
  int cluster, rv, n_vg, piece;
  size_t smem;
};

// Chosen from the shape alone (the offsets stay on the device): the
// largest vector group (all of a stream's G x spec query vectors, at
// most kMaxVec) that still makes about kClusterBlocks blocks with
// clusters no wider than the span's tiles, and the cluster size that
// brings the launch to that many, whose block fits kSmemTarget; failing
// that the kSmemMax a block may hold; spec rows over a span of at most
// kShortTiles tiles take a block a tile.  cluster == 0: nothing fits.
inline AttnPlan attn_plan(int streams, int n_heads, int n_kv, int spec,
                          int hd, int span, bool int8) {
  const int R = spec * (n_heads / n_kv);
  for (size_t limit : {kSmemTarget, kSmemMax}) {
    for (int rv = R < kMaxVec ? R : kMaxVec;; rv = ceil_div(rv, 2)) {
      const int n_vg = ceil_div(R, rv);
      const int units = streams * n_kv * n_vg;
      const int tiles = ceil_div(span > 0 ? span : 1, kTileSlots);
      const int c_max = tiles < kMaxCluster ? tiles : kMaxCluster;
      // Too few blocks (a short span caps the cluster): smaller groups.
      if (rv > 1 && units * c_max < kClusterBlocks) continue;
      int c0 = ceil_div(kClusterBlocks, units);
      c0 = c0 < 1 ? 1 : (c0 > c_max ? c_max : c0);
      if (spec > 1 && tiles <= kShortTiles) c0 = c_max;
      for (int c = c0; c <= kMaxCluster; ++c) {
        const int piece = ceil_div(span > 0 ? span : 1, c);
        const size_t smem = AttnLayout(hd, rv, piece, spec, int8).total;
        if (smem <= limit) return AttnPlan{c, rv, n_vg, piece, smem};
      }
      if (rv == 1) break;
    }
  }
  return AttnPlan{0, 0, 0, 0, 0};
}

// The arguments of attn_cluster_kernel.  qkv [B, nq + 2 nkv] f32, the
// un-roped projections of every row (B = streams x spec rows, ordered
// (stream b, draft slot j)); cos / sin [hd] (rope_stride 0) or [B, hd];
// offs [streams] int32 or NULL (then off0); caches [streams, n_kv, S,
// hd] bf16, or int8 with ks / vs [streams, n_kv, S] f32; kn / vn [B, n_kv,
// hd] bf16; attn [B, nq] f32.
struct AttnArgs {
  const float* qkv;
  const float* cosv;
  const float* sinv;
  int rope_stride;
  const int* offs;
  int off0, spec;
  const void* kc;
  const void* vc;
  const float* ks;
  const float* vs;
  __nv_bfloat16* kn;
  __nv_bfloat16* vn;
  float* attn;
  int S, window, ring_head, ring_size, n_heads, n_kv, hd;
  float scale;
  int rv, n_vg, piece;
  int chunk, kround, nrec;  // mode (f) (attn_chunk_kernel) only
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_code(float v) {
  return fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

// D (8 x 8, f64) += A (8 x 4) . B (4 x 8) on the f64 tensor cores: lane
// (g, t) = (lane / 4, lane % 4) holds a = A[g][t], b = B[t][g] and
// c = D[g][2 t], D[g][2 t + 1].
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// Four consecutive cache values at p (bf16 or int8) as doubles, exact;
// the values at index d0 + j >= hd read as 0.
template <bool kInt8>
__device__ __forceinline__ void load4(const unsigned char* p, int d0, int hd,
                                      double (&x)[4]) {
  if (d0 >= hd) {
    x[0] = x[1] = x[2] = x[3] = 0.0;
    return;
  }
  if constexpr (kInt8) {
    const int w = *reinterpret_cast<const int*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = static_cast<double>(static_cast<int8_t>(w >> (8 * j)));
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(w.x << 16);
    x[1] = __uint_as_float(w.x & 0xffff0000u);
    x[2] = __uint_as_float(w.y << 16);
    x[3] = __uint_as_float(w.y & 0xffff0000u);
  }
#pragma unroll
  for (int j = 1; j < 4; ++j)
    if (d0 + j >= hd) x[j] = 0.0;
}

// The sum (in rank order) and the max of one value over the cluster's
// blocks, through distributed shared memory, every load issued first.
__device__ __forceinline__ double ranks_sum(const cg::cluster_group& cl,
                                            double* p, int C) {
  double v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    v[q] = q < C ? *cl.map_shared_rank(p, q) : 0.0;
  double s = 0.0;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < C) s += v[q];
  return s;
}

__device__ __forceinline__ float ranks_max(const cg::cluster_group& cl,
                                           float* p, int C) {
  float m = -INFINITY;
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    v[q] = q < C ? *cl.map_shared_rank(p, q) : -INFINITY;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) m = fmaxf(m, v[q]);
  return m;
}

// Pair RoPE of element d of a projection row (the prologue's arithmetic).
__device__ __forceinline__ float rope_at(const float* x, const float* cr,
                                         const float* sr, int d) {
  return x[d] * cr[d] + x[d ^ 1] * sr[d];
}

// One cluster per (stream b, kv head jh, vector group vg): grid (C,
// streams x n_kv x n_vg), cluster (C, 1, 1), kAttnThreads threads.
// Query vector v of the group is global vector v0 + v = j * G + g: draft
// row j, query head jh * G + g.
template <bool kInt8, int kMt>
__global__ void __launch_bounds__(kAttnThreads) attn_cluster_kernel(
    const AttnArgs a) {
  constexpr int kStages = kAttnStages;
  using cache_t = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  pdl_trigger();
  pdl_wait();
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, spec = a.spec;
  const AttnLayout L(hd, a.rv, a.piece, spec, kInt8);
  unsigned char* tiles = smem;
  double* qp = reinterpret_cast<double*>(smem + L.o_qp);
  double* pvp = qp;  // after the scores: the block's P.V partial [n8][hd]
  int8_t* qq = reinterpret_cast<int8_t*>(smem + L.o_qq);
  float* sq = reinterpret_cast<float*>(smem + L.o_sq);
  float* sc = reinterpret_cast<float*>(smem + L.o_sc);
  int* sci = reinterpret_cast<int*>(sc);  // int8: the requant codes
  float* kss = reinterpret_cast<float*>(smem + L.o_ksv);  // int8 [piece]
  float* vss = kss + a.piece;
  double* den_loc = reinterpret_cast<double*>(smem + L.o_small);
  float* m_loc = reinterpret_cast<float*>(den_loc + kMaxVec);
  float* m_g = m_loc + kMaxVec;
  float* ea_loc = m_g + kMaxVec;
  float* se = ea_loc + kMaxVec;
  float* self_s = se + kMaxVec;
  float* e_self = self_s + kMaxVec;
  float* den_f = e_self + kMaxVec;
  float* fs = reinterpret_cast<float*>(smem + L.o_fs);
  float* fks = reinterpret_cast<float*>(smem + L.o_fk);
  float* fvs = fks + spec;
  int8_t* fkq = reinterpret_cast<int8_t*>(fvs + spec);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kAttnThreads / 32;
  const int G = a.n_heads / a.n_kv;
  const int nq = a.n_heads * hd, nkv = a.n_kv * hd, ld = nq + 2 * nkv;
  const int vg = blockIdx.y % a.n_vg, bjh = blockIdx.y / a.n_vg;
  const int jh = bjh % a.n_kv, b = bjh / a.n_kv;
  const int v0 = vg * a.rv, nv = min(a.rv, spec * G - v0);
  const int j_lo = v0 / G, j_hi = (v0 + nv - 1) / G;
  const int off = a.offs != nullptr ? a.offs[b] : a.off0;
  const bool ring = a.ring_size > 0;
  const int window = a.window;

  // The stream's walk: the slots some vector of the group can see.
  int lo, hi;
  if (ring) {
    lo = 0;
    hi = off < a.ring_head ? off
                           : a.ring_head + min(a.ring_size, off - a.ring_head);
  } else {
    lo = window >= 0 ? max(0, off + j_lo - window) : 0;
    hi = min(off, a.S);
  }
  const int n = max(hi - lo, 0);
  const int len = ceil_div(n, C);
  const int p0 = lo + min(rank * len, n);
  const int pn = min(len, lo + n - p0);

  auto vec_j = [&](int v) { return (v0 + v) / G; };
  auto vec_h = [&](int v) { return jh * G + (v0 + v) % G; };
  auto row_of = [&](int j) { return b * spec + j; };
  auto fresh = [&](int j, int i) { return window < 0 || j - i <= window; };
  auto visible = [&](int slot, int j) {
    if (ring)
      return ring_visible(slot, off, j, window, a.ring_head, a.ring_size);
    return slot < off && slot < a.S && (window < 0 || off + j - slot <= window);
  };
  auto cs = [&](int r) { return a.cosv + static_cast<size_t>(r) * a.rope_stride; };
  auto sn = [&](int r) { return a.sinv + static_cast<size_t>(r) * a.rope_stride; };
  auto q_at = [&](int r, int h, int d) {
    return rope_at(a.qkv + static_cast<size_t>(r) * ld + static_cast<size_t>(h) * hd,
                   cs(r), sn(r), d) *
           a.scale;
  };
  auto k_at = [&](int r, int d) {
    return rope_at(a.qkv + static_cast<size_t>(r) * ld + nq +
                       static_cast<size_t>(jh) * hd,
                   cs(r), sn(r), d);
  };
  auto v_at = [&](int r, int d) {
    return a.qkv[static_cast<size_t>(r) * ld + nq + nkv +
                 static_cast<size_t>(jh) * hd + d];
  };

  // 1. The group's query vectors: bf16(q), or q's int8 codes with the
  // scale sq = max(absmax, 1e-8) / 127, as doubles in the tensor-core A
  // layout: qp[v][16 b + 4 j + t] = q[v][16 b + 4 t + j] (rows past nv
  // and dims past hd zero), so lane t's four values of a 16-dim block
  // pair with the four consecutive cache values it loads.
  if constexpr (kInt8) {
    for (int v = warp; v < nv; v += nwarps) {
      const int r = row_of(vec_j(v)), h = vec_h(v);
      float qa = 0.0f;
      for (int d = lane; d < hd; d += 32) qa = fmaxf(qa, fabsf(q_at(r, h, d)));
      const float s = fmaxf(warp_max(qa), 1e-8f) / 127.0f;
      for (int d = lane; d < hd; d += 32)
        qq[v * hd + d] = static_cast<int8_t>(to_code(q_at(r, h, d) / s));
      if (lane == 0) sq[v] = s;
    }
    __syncthreads();
  }
  for (int i = tid; i < L.n8 * L.qs; i += kAttnThreads) {
    const int v = i / L.qs, e = i - v * L.qs;
    const int d = 16 * (e / 16) + 4 * (e % 4) + (e % 16) / 4;
    double q = 0.0;
    if (v < nv && e < 16 * L.nblk && d < hd) {
      if constexpr (kInt8)
        q = static_cast<double>(qq[v * hd + d]);
      else
        q = static_cast<double>(round_bf16(q_at(row_of(vec_j(v)), vec_h(v), d)));
    }
    qp[i] = q;
  }
  __syncthreads();

  // Staged walk over this block's piece [p0, p0 + pn) of a cache plane:
  // tile ti (kTileSlots rows) lands in buffer ti % kStages, kStages - 1
  // tiles ahead of the one in use; tile_ready(ti) waits for tile ti, then
  // (every thread past tile ti - 1) issues tile ti + kStages - 1 into its
  // buffer.
  const size_t plane = (static_cast<size_t>(b) * a.n_kv + jh) * a.S;
  const int nt = ceil_div(pn, kTileSlots);
  auto load_tile = [&](const cache_t* base, int ti) {
    const int t0 = ti * kTileSlots, rows = min(kTileSlots, pn - t0);
    const int per = L.row_bytes / L.chunk;
    unsigned char* dst = tiles + (ti % kStages) * kTileSlots * L.stride;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        base + (plane + p0 + t0) * hd);
    for (int i = tid; i < rows * per; i += kAttnThreads) {
      const int rr = i / per, cc = i - rr * per;
      cp_async(dst + rr * L.stride + cc * L.chunk,
               src + static_cast<size_t>(rr) * L.row_bytes + cc * L.chunk,
               L.chunk);
    }
    cp_async_commit();
  };
  auto tile_ready = [&](const cache_t* base, int ti) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (ti + kStages - 1 < nt)
      load_tile(base, ti + kStages - 1);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
    return tiles + (ti % kStages) * kTileSlots * L.stride;
  };
  auto prologue = [&](const cache_t* base) {
    for (int ti = 0; ti < kStages - 1; ++ti) {
      if (ti < nt)
        load_tile(base, ti);
      else
        cp_async_commit();
    }
  };
  const cache_t* kplane = static_cast<const cache_t*>(a.kc);
  const cache_t* vplane = static_cast<const cache_t*>(a.vc);

  // 2. Scores of the piece, masked to -inf where a vector cannot see the
  // slot: bf16(q) . k, or float(qq . kq) * sq * ks, the exact products
  // summed in f64 on the tensor cores.  Warp w takes the 8 slots 8 w ..
  // 8 w + 7 of a tile over every 8-vector tile, one accumulator per step
  // of a 16-dim block (four independent chains, added at the end).
  if constexpr (kInt8) {  // the piece's scales, one coalesced pass
    for (int i = tid; i < pn; i += kAttnThreads) {
      kss[i] = a.ks[plane + p0 + i];
      vss[i] = a.vs[plane + p0 + i];
    }
  }
  const int g = lane >> 2, tg = lane & 3;
  const int n_mt = L.n8 / 8;
  constexpr int esize = kInt8 ? 1 : 2;
  prologue(kplane);
  for (int ti = 0; ti < nt; ++ti) {
    const unsigned char* tile = tile_ready(kplane, ti);
    const int tn = min(kTileSlots, pn - ti * kTileSlots);
    if (8 * warp < tn) {
      double c[kMt][4][2];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[mt][j][0] = c[mt][j][1] = 0.0;
      const unsigned char* krow = tile + (8 * warp + g) * L.stride;
#pragma unroll 2
      for (int blk = 0; blk < L.nblk; ++blk) {
        const int d0 = 16 * blk + 4 * tg;
        double x[4];
        load4<kInt8>(krow + d0 * esize, d0, hd, x);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          if (mt >= n_mt) break;
          const double* qa = qp + (8 * mt + g) * L.qs + 16 * blk + tg;
#pragma unroll
          for (int j = 0; j < 4; ++j) dmma(c[mt][j], qa[4 * j], x[j]);
        }
      }
      // Lane (g, tg) holds vector 8 mt + g at slots 8 w + 2 tg + i.
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        if (mt >= n_mt) break;
        const int v = 8 * mt + g;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = 8 * warp + 2 * tg + i;
          if (v >= nv || t >= tn) continue;
          const double z = (c[mt][0][i] + c[mt][1][i]) + (c[mt][2][i] + c[mt][3][i]);
          const int tl = ti * kTileSlots + t, slot = p0 + tl;
          float s;
          if constexpr (kInt8)
            s = (static_cast<float>(z) * sq[v]) * kss[tl];
          else
            s = static_cast<float>(z);
          sc[v * a.piece + tl] = visible(slot, vec_j(v)) ? s : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // Block 0: the self score (the unrounded f32 q and k, f64 sum) and the
  // fresh scores of rows i < j (bf16: the f32 q against k_i RoPE'd with
  // row i's vectors; int8: float(qq . kq_i) * sq * ks_i, k_i through bf16
  // and the per-vector quantization, as the sequential step reads it
  // back), -inf past the window.  The group's scaled q and the stream's
  // rows 0 .. j_hi (RoPE'd k) are staged in the free tile ring first;
  // one warp per (vector, row i <= j).
  if (rank == 0) {
    float* qf = reinterpret_cast<float*>(tiles);  // [nv][hd]
    float* kf = qf + nv * hd;                     // [j_hi + 1][hd]
    for (int i = tid; i < nv * hd; i += kAttnThreads) {
      const int v = i / hd, d = i - v * hd;
      qf[i] = q_at(row_of(vec_j(v)), vec_h(v), d);
    }
    for (int i = tid; i < (j_hi + 1) * hd; i += kAttnThreads)
      kf[i] = k_at(row_of(i / hd), i % hd);
    __syncthreads();
    if constexpr (kInt8) {
      for (int i = warp; i < j_hi; i += nwarps) {
        float ka = 0.0f, va = 0.0f;
        for (int d = lane; d < hd; d += 32) {
          ka = fmaxf(ka, fabsf(round_bf16(kf[i * hd + d])));
          va = fmaxf(va, fabsf(round_bf16(v_at(row_of(i), d))));
        }
        const float ksf = fmaxf(warp_max(ka), 1e-8f) / 127.0f;
        const float vsf = fmaxf(warp_max(va), 1e-8f) / 127.0f;
        for (int d = lane; d < hd; d += 32)
          fkq[i * hd + d] = static_cast<int8_t>(to_code(round_bf16(kf[i * hd + d]) / ksf));
        if (lane == 0) {
          fks[i] = ksf;
          fvs[i] = vsf;
        }
      }
      __syncthreads();
    }
    for (int it = warp; it < nv * spec; it += nwarps) {
      const int v = it / spec, i = it - v * spec, j = vec_j(v);
      if (i > j) continue;
      float s;
      if (i == j || !kInt8) {
        double p = 0.0;
        for (int d = lane; d < hd; d += 32)
          p += static_cast<double>(qf[v * hd + d]) * kf[i * hd + d];
        s = static_cast<float>(warp_sum_d(p));
      } else {
        int p = 0;
        for (int d = lane; d < hd; d += 32)
          p += static_cast<int>(fkq[i * hd + d]) * static_cast<int>(qq[v * hd + d]);
        s = (static_cast<float>(warp_sum_i(p)) * sq[v]) * fks[i];
      }
      if (lane == 0) {
        if (i == j)
          self_s[v] = s;
        else
          fs[v * spec + i] = fresh(j, i) ? s : -INFINITY;
      }
    }
  }
  __syncthreads();
  // The block's max per vector (block 0: with the self and fresh scores).
  for (int v = warp; v < nv; v += nwarps) {
    float mx = -INFINITY;
    for (int t = lane; t < pn; t += 32) mx = fmaxf(mx, sc[v * a.piece + t]);
    mx = warp_max(mx);
    if (lane == 0) {
      if (rank == 0) {
        mx = fmaxf(mx, self_s[v]);
        for (int i = 0; i < vec_j(v); ++i) mx = fmaxf(mx, fs[v * spec + i]);
      }
      m_loc[v] = mx;
    }
  }

  // 3. The global max through distributed shared memory.
  cl.sync();
  for (int v = tid; v < nv; v += kAttnThreads)
    m_g[v] = ranks_max(cl, m_loc + v, C);
  __syncthreads();

  // 4. Weights e = expf(s - m): their f64 sum per vector; bf16: the
  // weight rounded to bf16; int8: e x vs, and its absmax.
  for (int v = warp; v < nv; v += nwarps) {
    const float m = m_g[v];
    double s = 0.0;
    float ea = 0.0f;
    for (int t = lane; t < pn; t += 32) {
      float* x = sc + v * a.piece + t;
      const float e = expf(*x - m);
      s += e;
      if constexpr (kInt8) {
        const float ew = *x != -INFINITY ? e * vss[t] : 0.0f;
        ea = fmaxf(ea, fabsf(ew));
        *x = ew;
      } else {
        *x = round_bf16(e);
      }
    }
    s = warp_sum_d(s);
    ea = warp_max(ea);
    if (lane == 0) {
      den_loc[v] = s;
      ea_loc[v] = ea;
    }
  }
  if (rank == 0) {
    for (int v = tid; v < nv; v += kAttnThreads)
      e_self[v] = expf(self_s[v] - m_g[v]);
    for (int it = tid; it < nv * spec; it += kAttnThreads) {
      const int v = it / spec, i = it - v * spec;
      if (i < vec_j(v)) fs[it] = expf(fs[it] - m_g[v]);  // e_i
    }
  }
  __syncthreads();
  if constexpr (kInt8) {
    // The requant group of each vector: the cache slots of every block
    // and the fresh rows, se = max(absmax, 1e-30) / 127.
    if (rank == 0)
      for (int v = tid; v < nv; v += kAttnThreads) {
        float ea = ea_loc[v];
        for (int i = 0; i < vec_j(v); ++i)
          if (fresh(vec_j(v), i)) ea = fmaxf(ea, fabsf(fs[v * spec + i] * fvs[i]));
        ea_loc[v] = ea;
      }
    cl.sync();
    for (int v = tid; v < nv; v += kAttnThreads)
      se[v] = fmaxf(fmaxf(ranks_max(cl, ea_loc + v, C), 0.0f), 1e-30f) / 127.0f;
    __syncthreads();
    for (int i = tid; i < nv * pn; i += kAttnThreads) {
      const int v = i / pn, t = i - v * pn;
      sci[v * a.piece + t] = static_cast<int>(to_code(sc[v * a.piece + t] / se[v]));
    }
    __syncthreads();
  }

  // 5. P.V over the piece on the tensor cores: bf16 weight x bf16 v, or
  // int8 code x int8 v, exact products summed in f64 (exact integers in
  // int8).  Warp w takes the 32-dim group w % n_dg (lane g: dims 4 g ..
  // 4 g + 3 of it, one per 8-dim output tile) and the slot steps s = w /
  // n_dg, + ksp, ... of each tile (4 slots a step), over every 8-vector
  // tile; the ksp partials are added in order afterwards.  The weights
  // (A) come from the score buffer: 0 past the piece or the group.
  const int dg = warp % L.n_dg, kq = warp / L.n_dg;
  double acc[kMt][4][2];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = 0.0;
  prologue(vplane);
  for (int ti = 0; ti < nt; ++ti) {
    const unsigned char* tile = tile_ready(vplane, ti);
    const int tn = min(kTileSlots, pn - ti * kTileSlots);
    if (kq < L.ksp) {
      const int d0 = 32 * dg + 4 * g;
#pragma unroll 2
      for (int st = kq; 4 * st < tn; st += L.ksp) {
        const int t = 4 * st + tg;
        double x[4];
        load4<kInt8>(tile + t * L.stride + d0 * esize, t < tn ? d0 : hd, hd, x);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          if (mt >= n_mt) break;
          const int v = 8 * mt + g;
          double av = 0.0;
          if (v < nv && t < tn) {
            const int at = v * a.piece + ti * kTileSlots + t;
            av = kInt8 ? static_cast<double>(sci[at]) : static_cast<double>(sc[at]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) dmma(acc[mt][j], av, x[j]);
        }
      }
    }
  }
  __syncthreads();
  // The partials of the ksp slot steps, added in order: lane (g, tg)
  // holds vector 8 mt + g, dims 32 dg + 4 (2 tg + i) + j.
  for (int r = 0; r < L.ksp; ++r) {
    if (kq == r) {
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        if (mt >= n_mt) break;
        const int v = 8 * mt + g;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int d = 32 * dg + 4 * (2 * tg + i) + j;
            if (v < nv && d < hd) {
              double* o = pvp + v * hd + d;
              *o = (r == 0 ? 0.0 : *o) + acc[mt][j][i];
            }
          }
      }
    }
    __syncthreads();
  }

  // 6. Block 0 adds the blocks' partials in block order, rounds once,
  // adds the fresh and self terms in f32 as the per-row walk did, and
  // writes the output, then k_new / v_new of the rows whose head 0 is in
  // this group.  The stream's v rows 0 .. j_hi are staged in the free
  // tile ring, and in int8 the fresh terms' codes (each a function of the
  // row and the dim, or of the vector and the row) once each.
  cl.sync();
  if (rank == 0) {
    float* vf = reinterpret_cast<float*>(tiles);  // [j_hi + 1][hd]
    float* vq = vf + (j_hi + 1) * hd;             // int8: [j_hi][hd]
    float* eq = vq + j_hi * hd;                   // int8: [nv][spec]
    for (int i = tid; i < (j_hi + 1) * hd; i += kAttnThreads)
      vf[i] = v_at(row_of(i / hd), i % hd);
    __syncthreads();
    if constexpr (kInt8) {
      for (int i = tid; i < j_hi * hd; i += kAttnThreads)
        vq[i] = to_code(round_bf16(vf[i]) / fvs[i / hd]);
      for (int it = tid; it < nv * spec; it += kAttnThreads) {
        const int v = it / spec, f = it - v * spec;
        if (f < vec_j(v)) eq[it] = to_code((fs[it] * fvs[f]) / se[v]);
      }
    }
    for (int v = tid; v < nv; v += kAttnThreads) {
      float den = static_cast<float>(ranks_sum(cl, den_loc + v, C));
      const int j = vec_j(v);
      for (int i = 0; i < j; ++i)
        if (fresh(j, i)) den = den + fs[v * spec + i];
      den_f[v] = den + e_self[v];
    }
    __syncthreads();
    for (int i = tid; i < nv * hd; i += kAttnThreads) {
      const int v = i / hd, d = i - v * hd;
      const double s = ranks_sum(cl, pvp + i, C);
      const int j = vec_j(v), r = row_of(j);
      float ctx;
      if constexpr (kInt8) {
        ctx = static_cast<float>(s) * se[v];
        for (int f = 0; f < j; ++f)
          if (fresh(j, f))
            ctx = ctx + (eq[v * spec + f] * vq[f * hd + d]) * se[v];
      } else {
        ctx = static_cast<float>(s);
        for (int f = 0; f < j; ++f)
          if (fresh(j, f)) ctx = ctx + fs[v * spec + f] * vf[f * hd + d];
      }
      ctx = ctx + e_self[v] * vf[j * hd + d];
      a.attn[static_cast<size_t>(r) * nq + static_cast<size_t>(vec_h(v)) * hd + d] =
          ctx / den_f[v];
    }
    for (int i = tid; i < (j_hi - j_lo + 1) * hd; i += kAttnThreads) {
      const int j = j_lo + i / hd, d = i % hd;
      if (j * G < v0 || j * G >= v0 + nv) continue;
      const size_t o = (static_cast<size_t>(row_of(j)) * a.n_kv + jh) * hd + d;
      a.kn[o] = __float2bfloat16(k_at(row_of(j), d));
      a.vn[o] = __float2bfloat16(vf[j * hd + d]);
    }
  }
  cl.sync();  // no block leaves while block 0 reads its shared memory
}

// Mode (f): the attention walked in chunks of ``chunk`` slots (spec = 1),
// over a bf16 cache or an int8 one (kInt8: codes with one f32 scale per
// cached vector, ks / vs [Bc, n_kv, S] for this layer), as the JAX
// kernel's chunked branch (decode_step_pallas.py:1085-1180) defines it:
// (m, den, ctx) start at (-1e30, 0, 0); per chunk m_new = max(m, max s),
// alpha = expf(m - m_new), e = expf(s - m_new) (rounded to bf16 for P.V,
// or, int8, e x vs requantized in one group per chunk, se = max(absmax,
// 1e-30) / 127), den = den alpha + sum e, ctx = ctx alpha + P.V(chunk);
// the self term merges last.  The int8 scores and codes are those of the
// cluster walk above (scores_of / ctx_of, :1045-1080).
//
// Only the max of that carry is sequential, and it is a prefix max: after
// chunk c, m_c = max(-1e30, every visible score of a slot before the
// chunk's end), whatever the order it is taken in.  Given m_c, a chunk's
// weights, its requant group, its f64 denominator and P.V sum depend on
// no other chunk; the f32 fold over the chunks, in chunk order, is a few
// operations a chunk.  So the walk runs as the cluster walk does:
//   * one thread-block cluster per (stream, kv head, group of query
//     heads), C blocks (up to 16); a block serves every query head of its
//     group, so a K / V row leaves HBM once per stream;
//   * the stream's own visible slots are walked ([max(0, off - window),
//     min(off, S)) bounded, the written head and ring slots of a head+ring
//     cache), not the batch's chunk range (JAX :1106-1119): a chunk a row
//     sees nothing of is an identity in the fold (alpha 1, sums 0), so
//     skipping it changes no bit;
//   * those slots, in rounds of ``kround`` whole chunks (one round unless
//     a span is too long for the cluster's shared memory), are cut into C
//     contiguous pieces of whole kTileSlots tiles; K then V tiles go
//     through the cp.async ring, the dots on the f64 tensor cores as in
//     attn_cluster_kernel (the exact products summed in f64);
//   * each block takes its piece's max M and the max F of its first
//     chunk's slots; after cluster.sync() it reads every block's (M, F)
//     through distributed shared memory and forms m_c for each chunk it
//     holds: the earlier pieces' M (and earlier rounds'), its own chunks
//     in order, and for its last chunk the later pieces' F;
//   * per chunk and piece: expf(s - m_c), the bf16 weight or e x vs, the
//     f64 denominator; int8: the chunk's absmax over the blocks that
//     share it (a second exchange) sets se_c, then the codes; the P.V
//     partial per chunk on the tensor cores, kept with m_c, se_c and the
//     denominator in a record a chunk;
//   * each block folds a slice of the dims (and every denominator): a
//     chunk's records added in block order, rounded once to f32 (int8:
//     times se_c), all chunks at once into the free tile ring, then the
//     chunks in chunk order with exactly the plain version's f32
//     operations, the self term last, and writes its slice of the output
//     (and of k_new / v_new).
// ops/decode_step.py::attention_chunk_split_plain states this walk and
// the CPU tests hold it bit for bit to the plain version.  What bounds it
// on the H100: the visible slots' K / V (and scales) once, as the
// cluster walk; the records and the fold add a few KB and microseconds.

// Shared memory of one block of the chunked walk: the tile ring, q as
// doubles (AttnLayout's), the piece's scores (then weights or codes) and
// int8 scales, per-vector values, ``nrec`` chunk records (f64 den [rv],
// f64 P.V [rv][hd], f32 m, absmax and se [rv] each) and the f32 carry
// (den per vector, the context [rv][hd]).  After the P.V pass the tile
// ring stages the fold's values.
struct ChunkLayout {
  AttnLayout base;
  size_t o_rec, rec_bytes, o_ctx, total;
  __host__ __device__ ChunkLayout(int hd, int rv, int piece, int nrec,
                                  bool int8)
      : base(hd, rv, piece, 0, int8) {
    rec_bytes = align16(sizeof(double) * static_cast<size_t>(rv) * (hd + 1) +
                        3 * sizeof(float) * rv);
    o_rec = base.o_fs;  // no fresh rows in mode (f)
    o_ctx = o_rec + static_cast<size_t>(nrec) * rec_bytes;
    total = o_ctx + align16(sizeof(float) * (kMaxVec +
                                             static_cast<size_t>(rv) * hd));
  }
};

// The chunked walk's launch shape, AttnPlan's fields and: ``kround``
// chunks a round, ``nrec`` chunk records a block.
struct ChunkPlan {
  AttnPlan pl;
  int kround, nrec;
};

// Chosen from the shape alone: every query head of a kv head in one group
// (split only where a block would not fit), about kClusterBlocks blocks
// in clusters no wider than the span's tiles, as attn_plan, and one round
// of every chunk a row can touch where its pieces fit kSmemTarget
// (failing that kSmemMax), else rounds of fewer chunks.  cluster == 0:
// nothing fits.
inline ChunkPlan chunk_plan(int streams, int n_heads, int n_kv, int hd,
                            int span, int chunk, bool int8) {
  const int G = n_heads / n_kv;
  const long long sp = span > 0 ? span : 1;
  const int tiles = static_cast<int>(ceil_div(static_cast<int>(sp),
                                              kTileSlots));
  const int k_all = static_cast<int>((sp + chunk - 1) / chunk) + 1;
  for (size_t limit : {kSmemTarget, kSmemMax}) {
    for (int rv = G < kMaxVec ? G : kMaxVec;; rv = ceil_div(rv, 2)) {
      const int n_vg = ceil_div(G, rv);
      const int units = streams * n_kv * n_vg;
      const int c_max = tiles < kMaxCluster ? tiles : kMaxCluster;
      int c0 = ceil_div(kClusterBlocks, units);
      c0 = c0 < 1 ? 1 : (c0 > c_max ? c_max : c0);
      for (int K = k_all;; K = ceil_div(K, 2)) {
        const long long rslots = static_cast<long long>(K) * chunk;
        const int rs = static_cast<int>(rslots < sp ? rslots : sp);
        for (int c = c0; c <= c_max; ++c) {
          const int piece = ceil_div(ceil_div(rs, c), kTileSlots) * kTileSlots;
          const int nr = (piece - 1) / chunk + 2;
          const int nrec = nr < K ? nr : K;
          const size_t smem = ChunkLayout(hd, rv, piece, nrec, int8).total;
          if (smem <= limit)
            return ChunkPlan{AttnPlan{c, rv, n_vg, piece, smem}, K, nrec};
        }
        if (K == 1) break;
      }
      if (rv == 1) break;
    }
  }
  return ChunkPlan{AttnPlan{0, 0, 0, 0, 0}, 0, 0};
}

// One cluster per (stream b, kv head jh, vector group vg): grid (C,
// streams x n_kv x n_vg), cluster (C, 1, 1), kAttnThreads threads.  Query
// vector v of the group is query head jh * G + v0 + v of row b.
template <bool kInt8, int kMt>
__global__ void __launch_bounds__(kAttnThreads) attn_chunk_kernel(
    const AttnArgs a) {
  constexpr int kStages = kAttnStages;
  using cache_t = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  pdl_trigger();
  pdl_wait();
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, chunk = a.chunk;
  const ChunkLayout CL(hd, a.rv, a.piece, a.nrec, kInt8);
  const AttnLayout& L = CL.base;
  unsigned char* tiles = smem;
  double* qp = reinterpret_cast<double*>(smem + L.o_qp);
  int8_t* qq = reinterpret_cast<int8_t*>(smem + L.o_qq);
  float* sq = reinterpret_cast<float*>(smem + L.o_sq);
  float* sc = reinterpret_cast<float*>(smem + L.o_sc);
  int* sci = reinterpret_cast<int*>(sc);  // int8: the requant codes
  float* kss = reinterpret_cast<float*>(smem + L.o_ksv);  // int8 [piece]
  float* vss = kss + a.piece;
  // Per vector: the piece's max M and its first chunk's max F (read by
  // the other blocks), the max before the piece and of the later pieces
  // its last chunk reaches, the running max through the rounds so far
  // (m_base; m_old before this round), the fold's running max within a
  // round, the self score, the carried denominator; the carried context
  // of this block's slice of dims.
  float* m_loc = reinterpret_cast<float*>(smem + L.o_small);
  float* f_loc = m_loc + kMaxVec;
  float* m_pre = f_loc + kMaxVec;
  float* m_post = m_pre + kMaxVec;
  float* m_base = m_post + kMaxVec;
  float* m_old = m_base + kMaxVec;
  float* m_fold = m_old + kMaxVec;
  float* s_self = m_fold + kMaxVec;
  float* den_run = reinterpret_cast<float*>(smem + CL.o_ctx);  // [kMaxVec]
  float* ctx_run = den_run + kMaxVec;                          // [rv][hd]
  const int rv = a.rv;
  // Record k: this block's slots of its k-th chunk of the round.
  auto rec = [&](unsigned char* base, int k) {
    return base + CL.o_rec + static_cast<size_t>(k) * CL.rec_bytes;
  };
  auto r_den = [&](unsigned char* r) { return reinterpret_cast<double*>(r); };
  auto r_pv = [&](unsigned char* r) {
    return reinterpret_cast<double*>(r) + rv;
  };
  auto r_m = [&](unsigned char* r) {
    return reinterpret_cast<float*>(r + sizeof(double) * rv * (hd + 1));
  };
  auto r_ea = [&](unsigned char* r) { return r_m(r) + rv; };
  auto r_se = [&](unsigned char* r) { return r_m(r) + 2 * rv; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kAttnThreads / 32;
  const int G = a.n_heads / a.n_kv;
  const int nq = a.n_heads * hd, nkv = a.n_kv * hd, ld = nq + 2 * nkv;
  const int vg = blockIdx.y % a.n_vg, bjh = blockIdx.y / a.n_vg;
  const int jh = bjh % a.n_kv, b = bjh / a.n_kv;
  const int v0 = vg * rv, nv = min(rv, G - v0);
  const int off = a.offs != nullptr ? a.offs[b] : a.off0;
  const bool ring = a.ring_size > 0;
  const int window = a.window;

  // The stream's visible slots [lo, hi) and the chunks they touch.
  int lo, hi;
  if (ring) {
    lo = 0;
    hi = off < a.ring_head ? off
                           : a.ring_head + min(a.ring_size, off - a.ring_head);
  } else {
    lo = window >= 0 ? max(0, off - window) : 0;
    hi = min(off, a.S);
  }
  const int c_beg = lo / chunk;
  const int c_end = hi > lo ? ceil_div(hi, chunk) : c_beg;

  auto vec_h = [&](int v) { return jh * G + v0 + v; };
  auto visible = [&](int slot) {
    if (ring) return ring_visible(slot, off, 0, window, a.ring_head, a.ring_size);
    return slot < off && slot < a.S && (window < 0 || off - slot <= window);
  };
  const float* cs = a.cosv + static_cast<size_t>(b) * a.rope_stride;
  const float* sn = a.sinv + static_cast<size_t>(b) * a.rope_stride;
  const float* row = a.qkv + static_cast<size_t>(b) * ld;
  auto q_at = [&](int h, int d) {
    return rope_at(row + static_cast<size_t>(h) * hd, cs, sn, d) * a.scale;
  };
  auto k_at = [&](int d) {
    return rope_at(row + nq + static_cast<size_t>(jh) * hd, cs, sn, d);
  };
  auto v_at = [&](int d) {
    return row[nq + nkv + static_cast<size_t>(jh) * hd + d];
  };

  // 1. The group's query vectors as attn_cluster_kernel stages them:
  // bf16(q), or q's int8 codes with sq = max(absmax, 1e-8) / 127, as
  // doubles in the tensor-core A layout; the self score (the unrounded
  // f32 q and k, f64 sum) and the carry (-1e30, 0, 0).  Each block
  // folds and writes the dims [d_lo, d_hi) of every vector.
  if constexpr (kInt8) {  // one read of q: a lane keeps its dims
    constexpr int kPer = kMaxHeadDim / 32;
    for (int v = warp; v < nv; v += nwarps) {
      const int h = vec_h(v);
      float qv[kPer];
      float qa = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = lane + 32 * j;
        qv[j] = d < hd ? q_at(h, d) : 0.0f;
        qa = fmaxf(qa, fabsf(qv[j]));
      }
      const float s = fmaxf(warp_max(qa), 1e-8f) / 127.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) qq[v * hd + d] = static_cast<int8_t>(to_code(qv[j] / s));
      }
      if (lane == 0) sq[v] = s;
    }
    __syncthreads();
  }
  for (int i = tid; i < L.n8 * L.qs; i += kAttnThreads) {
    const int v = i / L.qs, e = i - v * L.qs;
    const int d = 16 * (e / 16) + 4 * (e % 4) + (e % 16) / 4;
    double q = 0.0;
    if (v < nv && e < 16 * L.nblk && d < hd) {
      if constexpr (kInt8)
        q = static_cast<double>(qq[v * hd + d]);
      else
        q = static_cast<double>(round_bf16(q_at(vec_h(v), d)));
    }
    qp[i] = q;
  }
  const int d_lo = min(rank * ceil_div(hd, C), hd);
  const int d_hi = min(d_lo + ceil_div(hd, C), hd);
  for (int v = warp; v < nv; v += nwarps) {
    double p = 0.0;
    for (int d = lane; d < hd; d += 32)
      p += static_cast<double>(q_at(vec_h(v), d)) * k_at(d);
    p = warp_sum_d(p);
    if (lane == 0) {
      s_self[v] = static_cast<float>(p);
      m_base[v] = -1e30f;
      den_run[v] = 0.0f;
    }
  }
  for (int i = tid; i < nv * hd; i += kAttnThreads) ctx_run[i] = 0.0f;
  __syncthreads();

  const size_t plane = (static_cast<size_t>(b) * a.n_kv + jh) * a.S;
  const cache_t* kplane = static_cast<const cache_t*>(a.kc);
  const cache_t* vplane = static_cast<const cache_t*>(a.vc);
  const int g = lane >> 2, tg = lane & 3;
  const int n_mt = L.n8 / 8;
  constexpr int esize = kInt8 ? 1 : 2;
  const int dg = warp % L.n_dg, kq = warp / L.n_dg;

  for (int ca = c_beg; ca < c_end; ca += a.kround) {
    // The round's slots [ra, rb), cut into C pieces of whole tiles.
    const int cb = min(ca + a.kround, c_end);
    const int ra = max(lo, ca * chunk), rb = min(hi, cb * chunk);
    const int len = ceil_div(ceil_div(rb - ra, C), kTileSlots) * kTileSlots;
    auto pstart = [&](int q) { return min(ra + q * len, rb); };
    const int p0 = pstart(rank), pn = pstart(rank + 1) - p0;
    const int c_first = p0 / chunk;
    const int nk = pn > 0 ? (p0 + pn - 1) / chunk - c_first + 1 : 0;
    const int nt = ceil_div(pn, kTileSlots);
    // Does block q's piece hold slots of chunk c?
    auto holds = [&](int q, int c) {
      const int s0 = pstart(q), s1 = pstart(q + 1);
      return s1 > s0 && s0 < (c + 1) * chunk && s1 > c * chunk;
    };

    // Staged walk over the piece, as attn_cluster_kernel's.
    auto load_tile = [&](const cache_t* base, int ti) {
      const int t0 = ti * kTileSlots, rows = min(kTileSlots, pn - t0);
      const int per = L.row_bytes / L.chunk;
      unsigned char* dst = tiles + (ti % kStages) * kTileSlots * L.stride;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          base + (plane + p0 + t0) * hd);
      for (int i = tid; i < rows * per; i += kAttnThreads) {
        const int rr = i / per, cc = i - rr * per;
        cp_async(dst + rr * L.stride + cc * L.chunk,
                 src + static_cast<size_t>(rr) * L.row_bytes + cc * L.chunk,
                 L.chunk);
      }
      cp_async_commit();
    };
    auto tile_ready = [&](const cache_t* base, int ti) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (ti + kStages - 1 < nt)
        load_tile(base, ti + kStages - 1);
      else
        cp_async_commit();
      return tiles + (ti % kStages) * kTileSlots * L.stride;
    };
    auto prologue = [&](const cache_t* base) {
      for (int ti = 0; ti < kStages - 1; ++ti) {
        if (ti < nt)
          load_tile(base, ti);
        else
          cp_async_commit();
      }
    };

    // 2. Scores of the piece, -inf where the row cannot see the slot
    // (int8: the piece's scales read while the first tiles land).
    prologue(kplane);
    if constexpr (kInt8) {
      for (int i = tid; i < pn; i += kAttnThreads) {
        kss[i] = a.ks[plane + p0 + i];
        vss[i] = a.vs[plane + p0 + i];
      }
    }
    for (int ti = 0; ti < nt; ++ti) {
      const unsigned char* tile = tile_ready(kplane, ti);
      const int tn = min(kTileSlots, pn - ti * kTileSlots);
      if (8 * warp < tn) {
        double c[kMt][4][2];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[mt][j][0] = c[mt][j][1] = 0.0;
        const unsigned char* krow = tile + (8 * warp + g) * L.stride;
#pragma unroll 2
        for (int blk = 0; blk < L.nblk; ++blk) {
          const int d0 = 16 * blk + 4 * tg;
          double x[4];
          load4<kInt8>(krow + d0 * esize, d0, hd, x);
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt) {
            if (mt >= n_mt) break;
            const double* qa = qp + (8 * mt + g) * L.qs + 16 * blk + tg;
#pragma unroll
            for (int j = 0; j < 4; ++j) dmma(c[mt][j], qa[4 * j], x[j]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          if (mt >= n_mt) break;
          const int v = 8 * mt + g;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int t = 8 * warp + 2 * tg + i;
            if (v >= nv || t >= tn) continue;
            const double z = (c[mt][0][i] + c[mt][1][i]) + (c[mt][2][i] + c[mt][3][i]);
            const int tl = ti * kTileSlots + t;
            float s;
            if constexpr (kInt8)
              s = (static_cast<float>(z) * sq[v]) * kss[tl];
            else
              s = static_cast<float>(z);
            sc[v * a.piece + tl] = visible(p0 + tl) ? s : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

    // 3. The piece's max M and its first chunk's max F, then every
    // block's through distributed shared memory: the max before this
    // piece (earlier rounds and pieces), and of the later pieces that
    // reach into this piece's last chunk (their first chunk's slots).
    const int f_end = min(pn, (c_first + 1) * chunk - p0);
    for (int v = warp; v < nv; v += nwarps) {
      float mx = -INFINITY, fx = -INFINITY;
      for (int t = lane; t < pn; t += 32) {
        const float s = sc[v * a.piece + t];
        mx = fmaxf(mx, s);
        if (t < f_end) fx = fmaxf(fx, s);
      }
      mx = warp_max(mx);
      fx = warp_max(fx);
      if (lane == 0) {
        m_loc[v] = mx;
        f_loc[v] = fx;
      }
    }
    cl.sync();
    const int last_end = (c_first + nk) * chunk;  // end of the last chunk
    for (int v = tid; v < nv; v += kAttnThreads) {
      float pre = m_base[v], post = -INFINITY, all = m_base[v];
      for (int q = 0; q < C; ++q) {
        const float mq = *cl.map_shared_rank(m_loc + v, q);
        all = fmaxf(all, mq);
        if (q < rank) pre = fmaxf(pre, mq);
        if (q > rank && nk > 0 && pstart(q) < last_end &&
            pstart(q + 1) > pstart(q))
          post = fmaxf(post, *cl.map_shared_rank(f_loc + v, q));
      }
      m_pre[v] = pre;
      m_post[v] = post;
      m_old[v] = m_base[v];
      m_base[v] = all;  // the max through this round
    }
    __syncthreads();

    // 4. Per chunk of the piece: its max, then the running max m_c in
    // chunk order (the last chunk also over the later pieces').
    for (int it = warp; it < nv * nk; it += nwarps) {
      const int v = it / nk, k = it - v * nk;
      const int s0 = max(p0, (c_first + k) * chunk) - p0;
      const int s1 = min(p0 + pn, (c_first + k + 1) * chunk) - p0;
      float mx = -INFINITY;
      for (int t = s0 + lane; t < s1; t += 32) mx = fmaxf(mx, sc[v * a.piece + t]);
      mx = warp_max(mx);
      if (lane == 0) r_m(rec(smem, k))[v] = mx;
    }
    __syncthreads();
    for (int v = tid; v < nv; v += kAttnThreads) {
      float run = m_pre[v];
      for (int k = 0; k < nk; ++k) {
        float* m = r_m(rec(smem, k)) + v;
        run = fmaxf(run, *m);
        if (k == nk - 1) run = fmaxf(run, m_post[v]);
        *m = run;
      }
    }
    __syncthreads();

    // 5. e = expf(s - m_c): its f64 sum per chunk; bf16: the weight
    // rounded to bf16; int8: e x vs (0 where the row cannot see the
    // slot) and its absmax.
    for (int it = warp; it < nv * nk; it += nwarps) {
      const int v = it / nk, k = it - v * nk;
      unsigned char* r = rec(smem, k);
      const float m = r_m(r)[v];
      const int s0 = max(p0, (c_first + k) * chunk) - p0;
      const int s1 = min(p0 + pn, (c_first + k + 1) * chunk) - p0;
      double s = 0.0;
      float ea = 0.0f;
      for (int t = s0 + lane; t < s1; t += 32) {
        float* x = sc + v * a.piece + t;
        const float e = expf(*x - m);
        s += e;
        if constexpr (kInt8) {
          const float ew = *x != -INFINITY ? e * vss[t] : 0.0f;
          ea = fmaxf(ea, fabsf(ew));
          *x = ew;
        } else {
          *x = round_bf16(e);
        }
      }
      s = warp_sum_d(s);
      ea = warp_max(ea);
      if (lane == 0) {
        r_den(r)[v] = s;
        r_ea(r)[v] = ea;
      }
    }
    if constexpr (kInt8) {
      // Each chunk's requant group over the blocks that hold its slots,
      // se = max(absmax, 1e-30) / 127, then the codes.
      cl.sync();
      for (int it = tid; it < nv * nk; it += kAttnThreads) {
        const int v = it / nk, k = it - v * nk, c = c_first + k;
        unsigned char* r = rec(smem, k);
        float ea = r_ea(r)[v];
        for (int q = 0; q < C; ++q) {
          if (q == rank || !holds(q, c)) continue;
          unsigned char* rq = rec(cl.map_shared_rank(smem, q),
                                  c - pstart(q) / chunk);
          ea = fmaxf(ea, r_ea(rq)[v]);
        }
        r_se(r)[v] = fmaxf(fmaxf(ea, 0.0f), 1e-30f) / 127.0f;
      }
      __syncthreads();
      for (int i = tid; i < nv * pn; i += kAttnThreads) {
        const int v = i / pn, t = i - v * pn;
        const float se = r_se(rec(smem, (p0 + t) / chunk - c_first))[v];
        sci[v * a.piece + t] = static_cast<int>(to_code(sc[v * a.piece + t] / se));
      }
    }
    __syncthreads();

    // 6. P.V per chunk over the piece on the tensor cores, as
    // attn_cluster_kernel's: warp w takes the 32-dim group w % n_dg and
    // the slot steps w / n_dg, + ksp, ...; the weights of slots outside
    // the chunk read as 0.  At the chunk's last slot in the piece the ksp
    // partials go to its record, added in order.
    double acc[kMt][4][2];
    auto clear = [&]() {
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = 0.0;
    };
    clear();
    prologue(vplane);
    for (int ti = 0; ti < nt; ++ti) {
      const unsigned char* tile = tile_ready(vplane, ti);
      const int t0 = ti * kTileSlots;
      const int tn = min(kTileSlots, pn - t0);
      for (int a0 = t0; a0 < t0 + tn;) {
        const int k = (p0 + a0) / chunk - c_first;
        const int c_stop = (c_first + k + 1) * chunk - p0;
        const int a1 = min(t0 + tn, c_stop);
        if (kq < L.ksp) {
          const int d0 = 32 * dg + 4 * g;
#pragma unroll 2
          for (int st = (a0 - t0) / 4 + kq; 4 * st < a1 - t0; st += L.ksp) {
            const int t = 4 * st + tg;
            const bool in = t0 + t >= a0 && t0 + t < a1;
            double x[4];
            load4<kInt8>(tile + t * L.stride + d0 * esize, t < tn ? d0 : hd,
                         hd, x);
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt) {
              if (mt >= n_mt) break;
              const int v = 8 * mt + g;
              double av = 0.0;
              if (v < nv && in) {
                const int at = v * a.piece + t0 + t;
                av = kInt8 ? static_cast<double>(sci[at])
                           : static_cast<double>(sc[at]);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) dmma(acc[mt][j], av, x[j]);
            }
          }
        }
        if (a1 == c_stop || a1 == pn) {  // the chunk's last slot here
          double* pv = r_pv(rec(smem, k));
          for (int r = 0; r < L.ksp; ++r) {
            if (kq == r) {
#pragma unroll
              for (int mt = 0; mt < kMt; ++mt) {
                if (mt >= n_mt) break;
                const int v = 8 * mt + g;
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                  for (int i = 0; i < 2; ++i) {
                    const int d = 32 * dg + 4 * (2 * tg + i) + j;
                    if (v < nv && d < hd) {
                      double* o = pv + v * hd + d;
                      *o = (r == 0 ? 0.0 : *o) + acc[mt][j][i];
                    }
                  }
              }
            }
            __syncthreads();
          }
          clear();
        }
        a0 = a1;
      }
    }

    // 7. The fold, each block over its slice of dims (every block also
    // carries the denominators): for a batch of the round's chunks that
    // fits the free tile ring, first every (chunk, vector, dim) at once --
    // the chunk's records added in block order (f64), rounded once
    // (int8: times se_c), with m_c beside them -- then each (vector, dim)
    // in chunk order: acc = acc alpha + value, alpha = expf(m_{c-1} -
    // m_c), in f32 as the plain version.
    cl.sync();
    cp_async_wait<0>();
    {
      float* stage = reinterpret_cast<float*>(tiles);
      const int w = d_hi - d_lo + 1;  // the slice's dims and the den
      const int per = nv * (w + 1);   // a chunk's values and its m_c
      const int nb = static_cast<int>(L.o_qp / (sizeof(float) * per));
      auto holder = [&](int pos) { return (pos - ra) / len; };
      for (int c0 = ca; c0 < cb; c0 += nb) {
        const int c1 = min(c0 + nb, cb);
        for (int i = tid; i < (c1 - c0) * nv * w; i += kAttnThreads) {
          const int c = c0 + i / (nv * w), r = i % (nv * w);
          const int v = r / w, e = r - v * w, d = d_lo + e;
          const int qa = holder(max(c * chunk, ra));
          const int qb = holder(min((c + 1) * chunk, rb) - 1);
          double s = 0.0;
          float se = 1.0f, m_c = 0.0f;
          for (int q = qa; q <= qb; ++q) {
            unsigned char* rq = rec(cl.map_shared_rank(smem, q),
                                    c - pstart(q) / chunk);
            if (q == qa) {
              m_c = r_m(rq)[v];
              se = r_se(rq)[v];
            }
            s += d < d_hi ? r_pv(rq)[v * hd + d] : r_den(rq)[v];
          }
          float p = static_cast<float>(s);
          if (kInt8 && d < d_hi) p = p * se;
          float* st = stage + (c - c0) * per + v * (w + 1);
          st[e] = p;
          if (e == 0) st[w] = m_c;
        }
        __syncthreads();
        for (int i = tid; i < nv * w; i += kAttnThreads) {
          const int v = i / w, e = i - v * w, d = d_lo + e;
          float m = c0 == ca ? m_old[v] : m_fold[v];
          float* carry = d < d_hi ? ctx_run + v * hd + d : den_run + v;
          float acc_f = *carry;
          for (int c = c0; c < c1; ++c) {
            const float* st = stage + (c - c0) * per + v * (w + 1);
            const float m_c = st[w];
            const float alpha = expf(m - m_c);
            acc_f = acc_f * alpha + st[e];
            m = m_c;
          }
          *carry = acc_f;
        }
        __syncthreads();
        for (int v = tid; v < nv; v += kAttnThreads)
          m_fold[v] = stage[(c1 - 1 - c0) * per + v * (w + 1) + w];
        __syncthreads();
      }
    }
    cl.sync();  // the records are rewritten by the next round
  }

  // 8. Each block, over its slice of dims: the self term last and the
  // output; k_new / v_new (the group holding the kv head's first query
  // head writes them).
  for (int i = tid; i < nv * (d_hi - d_lo); i += kAttnThreads) {
    const int v = i / (d_hi - d_lo), d = d_lo + i % (d_hi - d_lo);
    const float m = m_base[v], ss = s_self[v];
    const float m_f = fmaxf(m, ss);
    const float alpha = expf(m - m_f);
    const float e_self = expf(ss - m_f);
    const float den = den_run[v] * alpha + e_self;
    const float ctx = ctx_run[v * hd + d] * alpha + e_self * v_at(d);
    a.attn[static_cast<size_t>(b) * nq + static_cast<size_t>(vec_h(v)) * hd + d] =
        ctx / den;
  }
  if (v0 == 0)
    for (int d = d_lo + tid; d < d_hi; d += kAttnThreads) {
      const size_t o = (static_cast<size_t>(b) * a.n_kv + jh) * hd + d;
      a.kn[o] = __float2bfloat16(k_at(d));
      a.vn[o] = __float2bfloat16(v_at(d));
    }
}

// What one layer's attention launch needs (K1 per layer, K4 per call).
// B = streams x spec rows; chunk > 0: mode (f).  The rest as AttnArgs.
struct AttnLaunch {
  const float* qkv;
  const float* cosv;
  const float* sinv;
  int rope_stride;
  const int* offs;
  int off0, B, spec;
  const void* kc;
  const void* vc;
  const float* ks;
  const float* vs;
  __nv_bfloat16* kn;
  __nv_bfloat16* vn;
  float* attn;
  int S, window, ring_head, ring_size, chunk, n_heads, n_kv, hd;
  float scale;
};

// The most cache slots one row sees: the window on a bounded cache, else
// all S (mode (f) walks them in chunks, the same span).
inline int attn_span(int S, int window, int ring_size) {
  return (ring_size == 0 && window >= 0 && window < S) ? window : S;
}

// One step's attention launch, sized before its first layer: the
// kernel of the geometry (the cluster walk, or the chunked walk in mode
// (f)) and its plan, with the kernel's attributes already set.  K1
// prepares once a step and launches it on every layer.
struct AttnPrep {
  void (*kernel)(const AttnArgs);
  AttnPlan pl;
  int kround, nrec;  // mode (f)
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Sizes the attention of a geometry and sets its kernel's attributes;
// cudaErrorInvalidValue when the geometry does not fit a block.
inline cudaError_t prepare_attention(int B, int spec, int n_heads, int n_kv,
                                     int hd, int S, int window, int ring_size,
                                     int chunk, bool kv8, AttnPrep* out) {
  *out = AttnPrep{};
  const int span = attn_span(S, window, ring_size);
  if (chunk > 0) {
    const ChunkPlan cp = chunk_plan(B, n_heads, n_kv, hd, span, chunk, kv8);
    out->pl = cp.pl;
    out->kround = cp.kround;
    out->nrec = cp.nrec;
  } else {
    out->pl = attn_plan(B / spec, n_heads, n_kv, spec, hd, span, kv8);
  }
  if (out->pl.cluster == 0) return cudaErrorInvalidValue;
  // Query-vector tiles of 8 (the accumulators a lane keeps): 1, 2 or 4.
  const int n_mt = ceil_div(out->pl.rv, 8);
  auto pick = [&](auto mt) {
    constexpr int kMt = decltype(mt)::value;
    if (chunk > 0)
      return kv8 ? attn_chunk_kernel<true, kMt> : attn_chunk_kernel<false, kMt>;
    return kv8 ? attn_cluster_kernel<true, kMt>
               : attn_cluster_kernel<false, kMt>;
  };
  out->kernel = n_mt == 1   ? pick(std::integral_constant<int, 1>())
                : n_mt == 2 ? pick(std::integral_constant<int, 2>())
                            : pick(std::integral_constant<int, 4>());
  cudaError_t e = set_smem(out->kernel, out->pl.smem);
  if (e == cudaSuccess && out->pl.cluster > 8)
    e = cudaFuncSetAttribute(out->kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// One layer's attention on the current stream, as ``pr`` prepared it: one
// cluster launch (``pdl``: a programmatic dependent launch, as K1
// launches its step).
inline cudaError_t launch_attention(const AttnLaunch& p, const AttnPrep& pr,
                                    cudaStream_t st, bool pdl = false) {
  const AttnPlan& pl = pr.pl;
  const AttnArgs a{p.qkv,  p.cosv,   p.sinv,      p.rope_stride, p.offs,
                   p.off0, p.spec,   p.kc,        p.vc,          p.ks,
                   p.vs,   p.kn,     p.vn,        p.attn,        p.S,
                   p.window, p.ring_head, p.ring_size, p.n_heads, p.n_kv,
                   p.hd,   p.scale,  pl.rv,       pl.n_vg,       pl.piece,
                   p.chunk, pr.kround, pr.nrec};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, p.B / p.spec * p.n_kv * pl.n_vg, 1);
  cfg.blockDim = dim3(kAttnThreads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, pr.kernel, a);
}

}  // namespace
}  // namespace vx
