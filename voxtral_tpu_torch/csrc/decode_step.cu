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
//       The attention walks the written slots only ([0, min(off, head))
//       and [head, head + min(size, off - head))), computes each slot's
//       (absolute position, written) exactly as build_valid and as the
//       plain version does, and masks each by the window of the row's
//       absolute query position.  Combines with every other mode: the
//       mask reads offs[b] per stream.
//   (h) g32 (q4g) weights: int8 codes (Q4_0 nibble - 8) with f16 group
//       scales [N, K/32] in place of the w8 row scales, for the four
//       stacks and the lm fold (_g32_mask_codes / _g32_matmul_tile,
//       :84-123): from 5 rows the weight stream's g32 form (k1_stream.cuh:
//       one int8 mma a group and 16 weight rows, the group sums in f64,
//       one weight pass up to 64 rows), below that the group-32 dp4a GEMV
//       of w8_common.cuh.  The JAX layouts
//       [L, SB, N, 128] / [L, 4 SB, 1, N] f32 exist for Mosaic; here the
//       codes keep the w8 layout [L, N, K] and the scales stay f16
//       (1.0625 instead of 1.125 bytes per weight, the same values).
//   (e) int8 KV cache (k_scales / v_scales given): int8 codes with one
//       f32 scale per cached vector [L, Bc, n_kv, S] (scores_of / ctx_of,
//       :1045-1080; the spec branch's fresh-row roundtrip, :831-929).
//       q is quantized per query head, the scores are integer dots
//       (__dp4a) times sq * ks[t], the softmax weights times vs[t] are
//       requantized in one group per row (cache slots and fresh rows
//       together) and P.V is an integer dot again:
//       attn_cluster_kernel<true>.
//   (g) bf16 weights (wfmt 2; wq8=False, :558, :667-677, :742-752, the
//       lm fold :1274-1281): the dense {"nt": w} leaves of
//       fuse_decode_weights_bf16, [L, N, K] bf16, streamed as they are
//       (the qkv phase in up to three segments wq / wk / wv, the FFN's in
//       w1 / w3), no scales.  row_quant writes the norm / ADA / SwiGLU row
//       as bf16 instead of int8 codes, and the exact bf16 x bf16
//       products are summed in f64: on the f64 tensor cores from 2 rows
//       (k1_stream.cuh), by bf16_row_dots (bf16_gemv.cuh) at one.  The attention
//       kernels are the same, so (g) combines with (b)-(f).  Bytes: 2 per
//       weight, 6.86 GB per step at full width with the lm table.
//   (f) chunked cache (chunk = Sc > 0, spec = 1; :1085-1180): an online
//       softmax over chunks of Sc slots in slot order, carrying
//       (m, denom, ctx); bf16 weights round against the running max and
//       the int8 requant group is per chunk.  Only the max is carried in
//       order, and it is a prefix max: attn_chunk_kernel<false / true>
//       walks each stream's own visible slots as the cluster walk does
//       (one cluster per stream and kv head, every query head of it a
//       block, the K / V rows once), forms each chunk's running max from
//       every block's piece maxima through distributed shared memory
//       before any expf, keeps per chunk its f64 sums (and int8 group)
//       and folds the chunks in chunk order in f32, each block over a
//       slice of the dims, exactly the plain version's operations.  A chunk a row sees nothing of
//       is an identity in the fold, so the row's chunks stand for the
//       batch's range (:1106-1119).  Shared memory does not bound S: a
//       span longer than the cluster holds runs in rounds of chunks.
//       Bytes: what bounds (e) and (f) are the visible slots' int8 codes
//       (half the bf16 cache) and their scale planes.
//   (i) lm_argmax (w8, g32 and bf16 tables; :1271-1300, :1479, :1605):
//       the greedy argmax folded into the lm_head (lm_argmax.cuh: per
//       vocab tile the (max, first index), then the tiles merged), so the
//       [B, V] logits are never written; the step returns the token of
//       each row.  Over a g32 table the fold's logits are mode (h)'s bit
//       for bit (the same dot: the stream's from 5 rows, g32_row_dots
//       below), over a bf16 table mode (g)'s
//       (the same bf16_row_dots over the bf16 rows row_quant writes, the
//       f32-rounded logit compared), so the token is torch.argmax of that
//       mode's logits.  Its caller is the data-parallel greedy decode
//       (parallel/dp_decode.py).
// The TPU kernel is one pallas_call whose sequential grid carries the
// residual across layers in VMEM.  CUDA blocks run in no order, so here
// the step is a fixed sequence of small kernels on one stream, with the
// residual in a [B, D] f32 buffer in HBM; per layer:
//
//   row_quant(norm)      rmsnorm x attn_norm, per-row int8 quant
//   gemv qkv             the weight stream (k1_stream.cuh) or a GEMV of
//                        w8_common.cuh / bf16_gemv.cuh, as planned
//   attention            pair RoPE, GQA attention over the cache slots
//                        [max(0, off + j - window), off), the fresh rows
//                        i < j of the stream and the row itself: one
//                        thread-block cluster per (stream, kv head) that
//                        splits the slots over its blocks and serves every
//                        query head and draft row of the stream
//                        (attn_step.cuh); k_new / v_new
//   row_quant(plain)     int8 quant of the attention output
//   gemv wo (+ x)        residual fused into the epilogue
//   row_quant(norm, ada) rmsnorm x ffn_norm x ADA vector, int8 quant
//   gemv w13
//   row_quant(swiglu)    silu(gate) * up, int8 quant
//   gemv w2 (+ x)
//
// then row_quant(final norm) and the lm_head GEMV or fold (mode (g):
// bf16 rows and the bf16 GEMVs in the same places).  9 launches per layer
// + 2.  A one-row step and a step the weight stream takes go out as
// programmatic dependent launches: each kernel may start while its
// predecessor runs and waits (pdl_wait) before it touches the
// activations, and the GEMVs fetch their first weights before that
// wait.  What bounds it on the H100: the weights streamed per step
// (3.43 GB w8 at full width, lm_head included; 6.86 GB bf16); the GEMVs
// read each weight byte once for up to 64 rows (spec: 8 streams x K = 8),
// everything else is a few KB per launch, but row_quant (one block a
// row) and the attention hold the weight stream up between GEMVs.
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

#include "attn_step.cuh"
#include "bf16_gemv.cuh"
#include "decode_common.cuh"
#include "k1_stream.cuh"
#include "lm_argmax.cuh"
#include "w8_common.cuh"

// All pointers are device pointers; lm_codes == NULL skips the lm fold.
// B rows = Bc streams x spec draft rows, ordered (stream, slot).
// wfmt: kW8, kG32 (mode (h)) or kBf16 (mode (g)).
// Layouts: x, xo [B, D] f32; norms / ada [L, D] f32; scales [L, N] f32
// (g32: [L, N, K/32] f16, lm_scale [V, D/32] f16; bf16: unused, NULL);
// cos / sin [hd] (rope_stride 0) or [B, hd] (rope_stride hd) f32,
// pair-expanded; offs [Bc] int32 or NULL (then off0 for every stream);
// caches [L, Bc, n_kv, S, hd] bf16 (int8 in mode (e)); wqkv [L, nq + 2 nkv, D], wo [L, D, nq],
// w13 [L, 2F, D], w2 [L, D, F] int8; lm_codes [V, D] int8, lm_scale [V]
// f32; kn / vn [L, B, n_kv, hd] bf16; logits [B, V] f32.  Mode (g): the
// four stacks and lm_codes are bf16, and the qkv stack may come in three
// segments wqkv [L, nqkv_a, D], wqkv_b [L, nqkv_b, D], wqkv_c (the rest)
// and w13 in two, w13 [L, F, D] and w13_b [L, F, D] (NULL: one stack).
// Scratch: xq [B, max(D, nq, F)] int8 (bf16 in mode (g)), sx [B],
// qkv [B, nq + 2 nkv], attn [B, nq],
// up [B, 2F] f32.  window < 0: no lower bound.  ring_size > 0: mode (d),
// the caches are head+ring buffers of ring_head + ring_size <= S slots
// and the offsets absolute positions.  k_scales / v_scales != NULL: mode
// (e), the caches are int8 codes with f32 scales [L, Bc, n_kv, S].
// chunk > 0: mode (f), the attention walks the cache in chunks of
// ``chunk`` slots (chunk divides S; spec must be 1).  lm_argmax != 0:
// mode (i), any wfmt: the lm fold writes token [B] int32, the first index
// of each row's largest logit, instead of the logits (lm_argmax.cuh or
// the stream's fold; scratch tmax / tidx [B, ceil(V / 8)] f32 / int32).
// plan (host memory, ops/decode_step.py::k1_stream_plans): {kc, stages,
// grid} of the weight stream for qkv, wo, w13, w2 and the lm table (kc 0:
// the earlier GEMV), then plan[15] != 0 to launch the step's kernels as
// programmatic dependent launches.  The host reads no offset: a pass
// launches without a device-to-host copy.
extern "C" int vx_decode_stack_step(
    const void* x, void* xo, const void* attn_norms, const void* ffn_norms,
    const void* ada, const void* sqkv, const void* so, const void* s13,
    const void* s2, const void* cosv, const void* sinv, const void* kc,
    const void* vc, const void* wqkv, const void* wo, const void* w13,
    const void* w2, const void* final_norm, const void* lm_codes,
    const void* lm_scale, void* kn, void* vn, void* logits, void* xq_buf,
    void* sx_buf, void* qkv_buf, void* attn_buf, void* up_buf,
    const void* offs, const void* k_scales, const void* v_scales,
    const void* wqkv_b, const void* wqkv_c, const void* w13_b, void* token,
    void* tmax_buf, void* tidx_buf, int B, int D, int L, int S, int n_heads,
    int n_kv, int hd, int F, int V, int off0, int spec, int rope_stride,
    int window, int wfmt, int nqkv_a, int nqkv_b, int ring_head,
    int ring_size, int chunk, int lm_argmax, float eps, float scale,
    const int* plan, void* stream) {
  using namespace vx;
  const bool ring = ring_size > 0;
  if (hd > kMaxHeadDim || hd % 2 || n_kv <= 0 || n_heads % n_kv ||
      spec < 1 || B % spec || L < 1 || plan == nullptr ||
      (offs == nullptr && (off0 < 0 || (!ring && off0 > S))) ||
      (ring && (ring_head < 0 || ring_head + ring_size > S)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool g32 = wfmt == kG32, bf16 = wfmt == kBf16;
  if ((wfmt != kW8 && !g32 && !bf16) ||
      (g32 && (D % 32 || (n_heads * hd) % 32 || F % 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool kv8 = k_scales != nullptr;
  if ((kv8 && (v_scales == nullptr || hd % 4)) ||
      (chunk != 0 && (chunk < 0 || S % chunk || spec != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The attention's plan and kernel attributes, once for all layers.
  AttnPrep prep;
  const cudaError_t pe = prepare_attention(B, spec, n_heads, n_kv, hd, S,
                                           window, ring_size, chunk, kv8,
                                           &prep);
  if (pe != cudaSuccess) return static_cast<int>(pe);
  if (lm_argmax &&
      (lm_codes == nullptr || token == nullptr ||
       tmax_buf == nullptr || tidx_buf == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = n_heads * hd, nkv = n_kv * hd, nqkv = nq + 2 * nkv;
  const int Bc = B / spec;
  if (bf16) {  // the qkv segments: nqkv_a, nqkv_b and the rest of the rows
    const int rest = nqkv - nqkv_a - nqkv_b;
    if (nqkv_a <= 0 || nqkv_b < 0 || rest < 0 ||
        (nqkv_b > 0) != (wqkv_b != nullptr) ||
        (rest > 0) != (wqkv_c != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  float* X = static_cast<float*>(xo);
  int8_t* xq = static_cast<int8_t*>(xq_buf);
  // Mode (g): the rows go to the GEMVs as bf16, in the same scratch.
  __nv_bfloat16* xb = bf16 ? static_cast<__nv_bfloat16*>(xq_buf) : nullptr;
  float* sx = static_cast<float*>(sx_buf);
  float* qkv = static_cast<float*>(qkv_buf);
  float* att = static_cast<float*>(attn_buf);
  float* up = static_cast<float*>(up_buf);
  const float* an = static_cast<const float*>(attn_norms);
  const float* fn = static_cast<const float*>(ffn_norms);
  const float* av = static_cast<const float*>(ada);
  // Layer l of an [L, N, K] stack of 1-byte (w8 / g32) or 2-byte (bf16)
  // weights.
  const size_t wsize = bf16 ? 2 : 1;
  auto wlayer = [&](const void* base, int l, int N, int K) -> const void* {
    if (base == nullptr) return nullptr;
    return static_cast<const char*>(base) +
           wsize * static_cast<size_t>(l) * N * K;
  };
  // The weight stream's plan of each linear (qkv, wo, w13, w2, lm; from
  // ops/decode_step.py::stream_plan, once a step): kc == 0 keeps the
  // earlier GEMVs for a shape the stream does not take.
  StreamPlan sp[5];
  // plan[15] != 0: the step's kernels go out as programmatic dependent
  // launches; 0: in plain stream order.
  const bool pdl = plan[15] != 0;
  const int kdim[5] = {D, nq, D, F, D};
  for (int i = 0; i < 5; ++i) {
    sp[i] = StreamPlan{plan[3 * i], plan[3 * i + 1], plan[3 * i + 2]};
    const cudaError_t e = prepare_stream(wfmt, B, kdim[i], sp[i]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int qa = bf16 ? nqkv_a : nqkv, qb = bf16 ? nqkv_b : 0;
  const int fa = (bf16 && w13_b != nullptr) ? F : 2 * F;
  // One linear of layer l (``lin`` indexes sp) over the rows row_quant
  // wrote: the stream (a programmatic dependent launch) or, where its
  // plan says so, the earlier GEMVs.  Mode (g) passes up to three
  // [L, n_i, K] bf16 segments (n0, n1 rows; the last takes the rest of
  // N); w8 / g32 one stack with its row (w8, [L, N] f32) or group (g32,
  // [L, N, K/32] f16) scales.
  auto linear = [&](int lin, const void* s0, const void* s1, const void* s2,
                    int n0, int n1, const void* sc, int l, const float* resid,
                    float* out, int N, int K) -> cudaError_t {
    const void* w0 = wlayer(s0, l, n0, K);
    const void* w1 = wlayer(s1, l, n1, K);
    const void* w2 = wlayer(s2, l, N - n0 - n1, K);
    const void* scl = nullptr;
    if (g32)
      scl = static_cast<const __half*>(sc) +
            static_cast<size_t>(l) * N * (K / 32);
    else if (!bf16)
      scl = static_cast<const float*>(sc) + static_cast<size_t>(l) * N;
    const void* xrow = bf16 ? static_cast<const void*>(xb) : xq;
    const StreamSegs sg{{static_cast<const char*>(w0),
                         static_cast<const char*>(w1),
                         static_cast<const char*>(w2)},
                        n0, n1};
    if (sp[lin].kc > 0 && stream_aligned(xrow, sg, g32 ? scl : nullptr)) {
      const StreamArgs a{xrow, sx, sg, scl, resid, out, nullptr, nullptr,
                         B, N, K, 0, 0};
      return launch_stream(wfmt, sp[lin], a, st, pdl);
    }
    return launch_gemv_ahead(wfmt, xrow, sx, sg, scl, resid, out, B, N, K,
                             st, pdl);
  };
  __nv_bfloat16* KN = static_cast<__nv_bfloat16*>(kn);
  __nv_bfloat16* VN = static_cast<__nv_bfloat16*>(vn);

  // Every launch of the step is a programmatic dependent launch: each
  // kernel waits for its predecessor before it touches the activations,
  // and the stream's GEMVs fetch their first weight tiles before that.
  // Layer 0 reads x itself (its wo GEMV adds x into xo), so no copy
  // node sits in the chain.
  const float* Xin = static_cast<const float*>(x);
  const size_t cache_layer = static_cast<size_t>(Bc) * n_kv * S * hd;
  const size_t new_layer = static_cast<size_t>(B) * n_kv * hd;
#define VX_TRY(call)                              \
  do {                                            \
    const cudaError_t e_ = (call);                \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)
  for (int l = 0; l < L; ++l) {
    VX_TRY(row_quant(Xin, D, D, an + static_cast<size_t>(l) * D, nullptr,
                     eps, kQuantNorm, B, xq, sx, xb, st, pdl));
    VX_TRY(linear(0, wqkv, bf16 ? wqkv_b : nullptr, bf16 ? wqkv_c : nullptr,
                  qa, qb, sqkv, l, nullptr, qkv, nqkv, D));
    const size_t scale_layer = static_cast<size_t>(Bc) * n_kv * S;
    const int esize = kv8 ? 1 : 2;  // bytes per cached value
    const size_t cache_off = static_cast<size_t>(esize) * l * cache_layer;
    AttnLaunch at{qkv,
                  static_cast<const float*>(cosv),
                  static_cast<const float*>(sinv),
                  rope_stride,
                  static_cast<const int*>(offs),
                  off0, B, spec,
                  static_cast<const char*>(kc) + cache_off,
                  static_cast<const char*>(vc) + cache_off,
                  kv8 ? static_cast<const float*>(k_scales) + l * scale_layer
                      : nullptr,
                  kv8 ? static_cast<const float*>(v_scales) + l * scale_layer
                      : nullptr,
                  KN + l * new_layer, VN + l * new_layer, att, S, window,
                  ring_head, ring_size, chunk, n_heads, n_kv, hd, scale};
    VX_TRY(launch_attention(at, prep, st, pdl));
    VX_TRY(row_quant(att, nq, nq, nullptr, nullptr, eps, kQuantPlain, B, xq,
                     sx, xb, st, pdl));
    VX_TRY(linear(1, wo, nullptr, nullptr, D, 0, so, l, Xin, X, D, nq));
    Xin = X;
    VX_TRY(row_quant(X, D, D, fn + static_cast<size_t>(l) * D,
                     av + static_cast<size_t>(l) * D, eps, kQuantNorm, B, xq,
                     sx, xb, st, pdl));
    VX_TRY(linear(2, w13, bf16 ? w13_b : nullptr, nullptr, fa, 2 * F - fa,
                  s13, l, nullptr, up, 2 * F, D));
    VX_TRY(row_quant(up, 2 * F, F, nullptr, nullptr, eps, kQuantSwiglu, B, xq,
                     sx, xb, st, pdl));
    VX_TRY(linear(3, w2, nullptr, nullptr, D, 0, s2, l, X, X, D, F));
  }
  if (lm_codes != nullptr) {
    VX_TRY(row_quant(X, D, D, static_cast<const float*>(final_norm), nullptr,
                     eps, kQuantNorm, B, xq, sx, xb, st, pdl));
    const void* xrow = bf16 ? static_cast<const void*>(xb) : xq;
    const StreamSegs sg{{static_cast<const char*>(lm_codes), nullptr, nullptr},
                        V, 0};
    if (lm_argmax && sp[4].kc > 0 &&
        stream_aligned(xrow, sg, g32 ? lm_scale : nullptr)) {
      // Mode (i) on the stream: the fold's partials a group of rows, then
      // the merge.
      const int groups = (V + stream_fmt(wfmt).rows - 1) /
                         stream_fmt(wfmt).rows;
      const StreamArgs a{xrow, sx, sg, lm_scale, nullptr, nullptr,
                         static_cast<float*>(tmax_buf),
                         static_cast<int*>(tidx_buf), B, V, D, 0, 0};
      VX_TRY(launch_stream(wfmt, sp[4], a, st, pdl));
      VX_TRY(launch_pdl(argmax_merge_kernel, dim3(B), dim3(256), 0, st, pdl,
                        static_cast<const float*>(tmax_buf),
                        static_cast<const int*>(tidx_buf), groups,
                        static_cast<float*>(nullptr),
                        static_cast<int*>(token)));
    } else if (lm_argmax) {  // mode (i) on the earlier fold
      launch_argmax(wfmt, xrow, sx, lm_codes, lm_scale, B, V, D,
                    static_cast<float*>(tmax_buf),
                    static_cast<int*>(tidx_buf), nullptr,
                    static_cast<int*>(token), st, pdl);
    } else {
      VX_TRY(linear(4, lm_codes, nullptr, nullptr, V, 0, lm_scale, 0, nullptr,
                    static_cast<float*>(logits), V, D));
    }
  }
#undef VX_TRY
  return static_cast<int>(cudaGetLastError());
}

// The attention of one layer alone, as K1 launches it per layer (a
// comparison entry: the card tests and chip_smoke.py's yardstick against
// scaled_dot_product_attention time and check the block without the
// GEMVs around it).  qkv [B, nq + 2 nkv] f32 un-roped; the other
// arguments as vx_decode_stack_step's, the caches and scales one layer's.
extern "C" int vx_attn_block(const void* qkv, const void* cosv,
                             const void* sinv, const void* kc, const void* vc,
                             const void* k_scales, const void* v_scales,
                             void* kn, void* vn, void* attn, const void* offs,
                             int B, int S, int n_heads, int n_kv, int hd,
                             int off0, int spec, int rope_stride, int window,
                             int ring_head, int ring_size, int chunk,
                             float scale, void* stream) {
  using namespace vx;
  const bool kv8 = k_scales != nullptr;
  if (hd > kMaxHeadDim || hd % 2 || n_kv <= 0 || n_heads % n_kv || spec < 1 ||
      B % spec || (kv8 && (v_scales == nullptr || hd % 4)) ||
      (ring_size > 0 && (ring_head < 0 || ring_head + ring_size > S)) ||
      (chunk != 0 && (chunk < 0 || S % chunk || spec != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnPrep prep;
  const cudaError_t pe = prepare_attention(B, spec, n_heads, n_kv, hd, S,
                                           window, ring_size, chunk, kv8,
                                           &prep);
  if (pe != cudaSuccess) return static_cast<int>(pe);
  const AttnLaunch at{static_cast<const float*>(qkv),
                      static_cast<const float*>(cosv),
                      static_cast<const float*>(sinv), rope_stride,
                      static_cast<const int*>(offs), off0, B, spec, kc, vc,
                      static_cast<const float*>(k_scales),
                      static_cast<const float*>(v_scales),
                      static_cast<__nv_bfloat16*>(kn),
                      static_cast<__nv_bfloat16*>(vn),
                      static_cast<float*>(attn), S, window, ring_head,
                      ring_size, chunk, n_heads, n_kv, hd, scale};
  const cudaError_t e =
      launch_attention(at, prep, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The cluster walk's launch shape for a geometry (attn_step.cuh::
// attn_plan): out = {cluster, vectors per cluster, clusters per (stream,
// kv head), score slots per block, shared memory bytes}.
extern "C" int vx_attn_plan(int streams, int n_heads, int n_kv, int spec,
                            int hd, int span, int int8, long long* out) {
  const vx::AttnPlan p =
      vx::attn_plan(streams, n_heads, n_kv, spec, hd, span, int8 != 0);
  out[0] = p.cluster;
  out[1] = p.rv;
  out[2] = p.n_vg;
  out[3] = p.piece;
  out[4] = static_cast<long long>(p.smem);
  return 0;
}

// Mode (f)'s chunked walk's launch shape (attn_step.cuh::chunk_plan):
// out = {cluster, vectors per cluster, clusters per (stream, kv head),
// score slots per block, chunks a round, chunk records per block, shared
// memory bytes}.
extern "C" int vx_attn_chunk_plan(int streams, int n_heads, int n_kv, int hd,
                                  int span, int chunk, int int8,
                                  long long* out) {
  if (chunk < 1 || n_kv < 1 || n_heads % n_kv) return 1;
  const vx::ChunkPlan p =
      vx::chunk_plan(streams, n_heads, n_kv, hd, span, chunk, int8 != 0);
  out[0] = p.pl.cluster;
  out[1] = p.pl.rv;
  out[2] = p.pl.n_vg;
  out[3] = p.pl.piece;
  out[4] = p.kround;
  out[5] = p.nrec;
  out[6] = static_cast<long long>(p.pl.smem);
  return 0;
}

// One linear of K1's weight stream alone, as a step launches it (the card
// tests and benches/torch_k1_times.py): out [M, N] = x . w^T with the
// format's epilogue (+ resid, may be NULL), or, with token != NULL, the
// fold: token [M] int32 the first index of each row's largest value
// (scratch tmax / tidx [M, ceil(N / 8)]).  w in up to three segments
// (n0, n1 rows; w8 and g32 one, n0 = N), scale as in
// vx_decode_stack_step; plan = {kc, stages, grid} of
// ops/decode_step.py::stream_plan, kc == 0 taking the earlier GEMV or
// fold.  Launched plainly (no predecessor to overlap).
extern "C" int vx_k1_linear(int fmt, const void* x, const void* sx,
                            const void* w0, const void* w1, const void* w2,
                            int n0, int n1, const void* scale,
                            const void* resid, void* out, void* tmax,
                            void* tidx, void* token, int M, int N, int K,
                            const int* plan, void* stream) {
  using namespace vx;
  if ((fmt != kW8 && fmt != kG32 && fmt != kBf16) || M < 1 || N < 1 ||
      plan == nullptr || (token == nullptr) == (out == nullptr) ||
      (token != nullptr && (tmax == nullptr || tidx == nullptr)) ||
      (fmt != kBf16 && (w1 != nullptr || w2 != nullptr || n0 != N)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StreamPlan p{plan[0], plan[1], plan[2]};
  cudaError_t e = prepare_stream(fmt, M, K, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const StreamSegs sg{{static_cast<const char*>(w0),
                       static_cast<const char*>(w1),
                       static_cast<const char*>(w2)},
                      n0, n1};
  const float* sxf = static_cast<const float*>(sx);
  const float* rf = static_cast<const float*>(resid);
  float* of = static_cast<float*>(out);
  if (p.kc > 0 && stream_aligned(x, sg, fmt == kG32 ? scale : nullptr)) {
    const StreamArgs a{x, sxf, sg, scale, rf, of,
                       static_cast<float*>(tmax), static_cast<int*>(tidx),
                       M, N, K, 0, 0};
    e = launch_stream(fmt, p, a, st, false);
    if (e == cudaSuccess && token != nullptr) {
      const int groups = (N + stream_fmt(fmt).rows - 1) / stream_fmt(fmt).rows;
      argmax_merge_kernel<<<M, 256, 0, st>>>(
          static_cast<const float*>(tmax), static_cast<const int*>(tidx),
          groups, nullptr, static_cast<int*>(token));
    }
  } else if (token != nullptr) {
    if (fmt == kBf16 && (w1 != nullptr || w2 != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    launch_argmax(fmt, x, sxf, w0, scale, M, N, K, static_cast<float*>(tmax),
                  static_cast<int*>(tidx), nullptr, static_cast<int*>(token),
                  st);
  } else {
    e = launch_gemv_ahead(fmt, x, sxf, sg, scale, rf, of, M, N, K, st, false);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
