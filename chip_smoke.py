#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (voxtral_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. device  — needs ``torch.cuda.is_available()``; prints the card's name
             and power limit as nvidia-smi reports them.
2. build   — nvcc builds voxtral_tpu_torch/csrc/*.cu for sm_90a.
3. w8      — Voxtral Mini 4B at full width with random w8 weights (seed
             0).  Kernels against their plain PyTorch versions on the
             card, at the main path's shapes, each time beside the plain
             version's and the card's bound: K2 w8_matmul (W8A8 GEMM;
             ``torch._int_mm`` timed beside it where it takes the shape),
             K1 decode_stack_step (26 layers + lm fold) in mode (a) at one
             row, mode (b) spec=8 at 1 and 8 streams (8 and 64 rows,
             distinct per-stream offsets) and mode (c) (an offset per
             row, 4 rows), each timed on the device (a CUDA graph of the
             step) and called from the host.  (The step's and K4's / K5's
             device time by launch class: benches/torch_k1_times.py
             --breakdown and benches/torch_tp_times.py, on this script's
             k1_breakdown / tp_breakdown.)  Main path: TranscribePipeline.
             transcribe_samples on a 16 s chirp, sequential and
             speculative (PipelineConfig(speculative=8), draft "ngram"
             and "pad"), each run with the launch counters set to 0 just
             before and read just after, tokens held against the same
             pipelines through the plain versions on the chirp's first
             6 s (near-tie rule; the pad-draft pair on its first 3 s, a
             pass per token being slow there), every speculative
             pass one K1 launch; then three mels (x, 0.9 x,
             1.1 x) with speculative=4 against the sequential batch.
4. K3      — q4_matmul (packed Q4_0 dequant + matmul) bit-equal to its
             plain version at every shape of the q4 path (decoder linears
             and the lm_head) at M = 1 and M = 8, each timed on the
             device (a CUDA graph of 20 calls) and called from the host.
5. q4g     — full-width random Q4_0 weights, unpacked (codes + f16 group
             scales): K1 mode (h) against its plain version at 1 row,
             spec=8 at 8 and 64 rows and mode (c) at 4 rows; K1's g32
             weight stream alone (k1_linear) on layer 0's four linears and
             the lm table at 2, 8 and 64 rows and its fold at 12 rows,
             bit for bit against g32_matmul_plain, the lm table timed
             beside its bound (check_g32_stream); the main
             path sequential and with speculative=8 + ngram drafts
             (tokens == plain path; spec == sequential; K1 launches ==
             steps, then passes).
6. q4      — the same weights nibble-packed: the per-op decode step, K3
             on every decoder linear and the lm_head (K3 launches ==
             183 per step x steps + 1), on the chirp's first 4 s;
             tokens == the plain path.
7. gguf    — a small-config GGUF and tekken.json written with the port's
             write_gguf; ``python -m voxtral_tpu_torch.cli --gguf ...
             --weight-format {q4,q4g,w8}`` on the card, each exiting 0
             with the library path's text; beside them, phase 11b.
8. stream  — live sessions (voxtral_tpu_torch.StreamingSession), each
             right after the one-shot phase whose model it reuses.  8a
             (w8): K1 mode (d), the head+ring mask, against its plain
             version at full width (S = 8238, ring (38, 8200), before and
             after the wrap, the head outside the window, spec=8 rows
             straddling the ring's end), timed with the window full and
             at a short history; a 40 s chirp fed in ragged pieces to a
             bounded (120 s) and an unbounded session, tokens against
             the same sessions through the plain versions (over the
             first 6 s of each, and the unbounded one from its kernel
             twin's checkpoint at 28 s to 38 s, past the encoder ring's
             wrap: the streams are causal), bounded
             against unbounded and the unbounded session against the
             one-shot path (near-tie rules), speculative=8 with pad and
             ngram drafts against sequential; a session restored 2P
             positions short of the decoder ring's wrap runs 4 steps
             through it, kernels against plain.  8b (q4g): K1 (d) in g32
             and the unbounded session, sequential and speculative.  8c
             (q4): a short bounded session on the per-op step (K3 launch
             count).  Every session runs with the launch counters set to
             0 just before and read just after (K1 launches == positions
             after the first step, or == passes).
10. pools  — pooled sessions (voxtral_tpu_torch.StreamPool), each after
             the session phase of its model.  10a (w8): K1 alone at full
             width in the pool's modes, bit-equal to plain and timed
             beside its bound: (c) x (d) at four streams in four ring
             phases (offsets 100 / 8237 / 8241 / 16000, S = 8238), mode
             (e) int8 KV on the same rows and with spec=8 (32 rows), mode
             (f) ``cache_chunk=512`` bounded (S = 1536, its third chunk
             dead and NaN-poisoned) and on the grown ring (S = 8704),
             bf16 and int8, (f) also on the device alone (CUDA graph);
             the attention block alone under (d) and (f) beside its
             bound and SDPA.  Then pools, each through the kernels and
             through the plain versions (those stopped after some ticks
             and held as a prefix), tokens equal slot by slot: B = 4
             unbounded with bf16 and with int8 caches (four 14 s chirps
             started a step apart, one finished at tick 6 and a fresh
             session attached to its slot; step ms by ready rows, the
             aggregate step RTF, the step's bound, cache bytes against
             the formula, peak memory); speculative=8 pools, pad and
             ngram drafts on both cache types, against the sequential
             pool over its first 8 ticks, and an ngram pool with all
             four chirps started in one tick and every slot live for 8
             ticks against the sequential pool of that start (tokens
             per pass); four slots restored at four
             ring phases with their windows full (synthetic checkpoints),
             4 steps together, on both cache types; the chunked rung forced by replacing
             ``_fused_plan``, bounded and unbounded; a pooled stream
             against a solo session under the layout control; slot_state
             -> solo session -> an int8 pool; last, K1 alone against
             plain at every cache geometry those pools handed it (sizes
             read off the pools' tensors: bf16 spec=8 at four ring
             streams, two-stream rings, the bounded chunked cache, ...).
             K2 is held at every pool size's row counts.  10b (q4g): K1
             (e) on g32 weights, a B = 2 int8 pool and its geometry.  10c (q4): the generic pool, B = 2,
             on the per-op step (K3).  Every pool runs with the launch
             counters set to 0 just before and read just after.
11. dense  — after the w8 pools: random dense weights at full width,
             built on the card (seed 0, DENSE_SCALE).  11a (bf16): the
             fuse is memory-neutral (memory_allocated after the build
             within 1 % of the tree's bytes) and admission counts the
             tree; the dense bf16 linear (cuBLAS bf16 GEMM, f32 sums)
             timed beside the same product on f32 copies; K1 mode (g)
             against its plain version, bit-equal and timed beside its
             bound, at 1, 8 and 64 rows, 4 rows (c), under (d) at offset
             16000 (S = 8238), (e) at four ring phases and (f) bounded
             (S = 1536); the 16 s chirp sequential and with
             speculative=8 + ngram drafts (K1 launches == steps, then
             passes; spec == sequential; kernel == plain over 4 s); an
             unbounded session (kernel == plain over 6 s); B = 2 pools
             with bf16 and int8 caches (kernel == plain), the int8 pool
             held against the bf16 one (each stream at least five
             distinct tokens), K1 at every geometry they handed it.
             11b (run with phase 7's processes): ``python -m
             voxtral_tpu_torch.cli --model DIR --dtype {bfloat16,w8}`` on
             a small SafeTensors directory the script writes (the GGUF's
             model, random dense weights), each exiting 0 with the
             library path's text.  11d (bf16 mesh, right after 11a on
             its model): K1 mode (i) over the bf16 table alone at 1, 8
             and 12 rows (12: two table passes, two planted ties, one
             across a fold tile), bit-equal to plain and == the argmax of
             mode (g)'s logits, timed from a CUDA graph and from the host
             beside its bound; a dp = 2 mesh whose data groups share the
             card and the stacks (no copy); two chirps sequential and
             speculative=8 ngram (== the single card's batch exactly;
             K1 (i) bf16 launches == 2 x positions); an unbounded session
             on the mesh (== the single card's); B = 4 dp = 2 pools on
             the bf16 and int8 caches (== the single card's pools
             exactly, == plain over their first ticks); a dp pool slot
             restored on one device.  11c
             (f32): the per-op step on the chirp's first 4 s (no kernel
             launched), RTF and peak memory.
12. batched — after the w8 sessions, on their model: K7
             decode_layer_step alone against its plain version at full
             width (layers 0 and 25, 1 and 8 rows, S = 151 at offsets 40
             and 150, and S = 8400 at offset 8300 with the window full),
             bit for bit, timed beside its bound; the merge cost
             measured (the one-shot decode loop's ms per position at 1,
             2, 4, 8 rows of the 16 s chirp, fitted to c0 + c1 B; the
             encode half per position) beside pipeline.DEFAULT_MERGE_COST;
             TranscribePipeline.transcribe_samples_batched on eight
             chirps of 4-16 s (batch_size=8), tokens and texts held to
             each buffer alone, aggregate tok/s beside one at a time, the
             plain side on three 2 s buffers in one batch; the same batch
             on the per-layer route (oneshot_plan replaced): K7 launches
             == 26 x steps, no K1, tokens == the stack route's, decode
             memory below the stack route's; the route's step ms at 1
             and 8 rows; oneshot_plan's rungs on this card in rows of
             30 s chunks; a 40 s file at max_mel_frames=1500 (15 / 15 /
             10 s) under the measured cost, a forced merge and none,
             held to each chunk alone.  Phase 7 also runs the CLI's
             --audio-list with --batch-files 4 and --timestamps on the
             --model directory.
13. mesh   — after the batched phase, on the w8 model's tree (one
             card: every mesh's shards share it).  K1 mode (i)
             (lm_argmax) at 1 and 8 rows, bit-equal to plain and == the
             argmax of mode (a)'s logits; K4 attn_half_step (tp = 2
             local shapes: 1 row at S = 151, 8 spec rows, the largest
             one-shot cache S = 194 at offset 187, four streams of a row
             as a B = 4 pool steps them) and K5 ffn_half_step (1, 4 and 8
             rows) bit-equal, timed from a CUDA graph and from the host; K6 lm_half_argmax on both vocab shards at 1 and 8
             rows, then with a planted tie inside shard 0 and one across
             the shards (the lowest global index on every row, == the
             plain argmax over the whole table).  The 16 s chirp on a
             tp = 2 mesh, sequential (K4 == K5 == 52 x steps, K6 == 2 x
             steps, no K1) and speculative=8 ngram (== sequential), the
             plain TP side on its first 6 s (== kernels), the TP tokens
             against the single card's (ROADMAP §3's rule); two chirps on
             dp = 2 (== the single card's batch exactly; K1 (i) launches
             == 2 x steps) and on 2 x 2 (== tp = 2 on the batch), each
             sequential and speculative; ``--tp 2`` on one card exits 2
             with the JAX CLI's message.
13c. mesh streams — after phase 13.  First ROADMAP §3's TP rule on the
             random w8 tree of phase 13: an unbounded session on a tp = 2
             mesh over the 16 s chirp and a B = 4 tp = 2 pool against the
             single card's, the speculative=8 ngram tp = 2 session against
             the sequential one by the spec near-tie rule.  Then, on a w8
             tree quantized on the card from the dense DENSE_SCALE tree
             (``utils.quantize.quantize_params_w8``; the random w8 tree's
             pooled streams emit one distinct token, this one's many), where
             a tp = 2 stream parts from the single card at its first decoded
             token: the plain single card with TP's quantization groups
             (``tp_quant_groups``: the WO and W2 inputs quantized per shard)
             as the second witness, to which the tp = 2 session (first 4 s)
             and pool (first 5 ticks) are held by the kernel near-tie rule;
             K4 alone
             at tp = 2 in its cache modes (K4_MODE_CASES: (d)
             head+ring, (e) int8 and (e) x (b) spec=8 at four streams at
             offsets 100 / 8237 / 8241 / 16000 of S = 8238; (f) chunks of
             512 on S = 1536 bounded, its third chunk dead, and on the
             grown ring S = 8704, bf16 and int8), bit-equal to plain,
             timed from a CUDA graph beside its bound; the unbounded
             tp = 2 session over the chirp in ragged pieces, sequential
             (K4 == K5 == 52 x positions, K6 == 2 x, no K1) and
             speculative=8 ngram (held to sequential by the margin-gap
             rule; the single card's own pair reported beside it), the
             plain TP session on its first 4 s (== kernels);
             B = 4 pools of four 6 s chirps a tick apart on the single
             card, tp = 2 (bf16 and int8 caches), dp = 2 and 2 x 2: dp ==
             the single card's pool and 2 x 2 == tp = 2 token for token,
             the int8 pool against the bf16 one by ROADMAP §3's rule (five
             distinct tokens a stream or more; g per stream, on the streams
             that agree past their first step, at least two), tp = 2
             against the single card as it is reported; the chunked rung
             forced on a tp = 2 B = 2
             pool, kernels against plain over 3 ticks; a 2 x 2 pool's
             slot checkpointed and restored on one device, run to the
             stream's end through the kernels and the plain versions.
13d. q4g mesh — right after the q4g one-shot phase (5), on its random
             full-width q4g tree: K1 mode (i) over the g32 table at 1 and
             8 rows (== the argmax of mode (h)'s logits), K4 in g32 (1
             row, 8 spec rows, four streams; (d), (e) and (f) at four
             streams, windows full), K5 in g32 (1, 4 and 8 rows) and K6 on a g32 vocab shard
             (1 and 8 rows, the planted ties), each bit-equal to plain,
             timed from a CUDA graph and from the host beside its bound;
             the one-shot path of phase 13 on q4g (mesh_oneshot: tp = 2
             sequential and speculative, the plain TP side on its first
             4 s, the TP rule against the single q4g card, or TP's
             quantization groups when they part at the first decoded
             token; dp = 2 == the single card, 2 x 2 == tp = 2, every
             launch a g32 one); an unbounded tp = 2 session on 8 s, B = 4
             tp = 2 pools on the bf16 and int8 caches and a dp = 2 pool,
             each held to the plain versions over its first 2 ticks; a
             2 x 2 slot restored on one device; the CLI's ``--gguf
             --weight-format q4g`` with and without ``--tp 2`` on
             small_gguf (with ``--device cpu`` on one card), each
             printing the library path's line on its mesh, tp = 2 held
             to one device with TP's quantization groups.  On the plain
             prefix the speculative tp = 2 run is held to its plain twin,
             and the witness (fresh_through_cache: the pass's earlier
             fresh rows read back through the bf16 cache) to plain
             sequential; only then may a q4g speculative row part from
             sequential above the spec near-tie, by the margin-gap rule
             (spec_held).
13b.       on two cards or more only (alone: ``mesh_cards_main``), for
             the w8 tree (after phase 13c), the q4g tree (after 13d) and
             the bf16 tree (in 11d): each mesh that fits with every shard
             on a card of its own (w8, q4g: tp = 2, dp = 2, 2 x 2; bf16:
             dp = 2), tokens == the same mesh on card 0 (dp == the single
             card), the peak memory per card; the unbounded tp = 2
             session and (four cards) a 2 x 2 B = 4 pool (bf16: a dp = 2
             pool) over cards of their own == the same on card 0; for
             w8 on four cards the CLI's ``--tp 2 --dp 2`` exits 0.
14. serving — after the w8 pools, on their model (run_serving_w8):
             ``voxtral_tpu_torch.serving.make_server(pool_streams=4,
             pool_unbounded=True, state_dir=..., prewarm=True)`` on
             127.0.0.1, driven over HTTP: /transcribe_pcm of the 16 s
             chirp against transcribe_samples (K1 / K2 launches equal),
             two concurrent /transcribe uploads in one batch,
             ?timestamps=1 words, four concurrent /stream sessions (held
             to a direct StreamPool of the same pieces), the SSE route, a
             stream drained and resumed by a second server, and the 503
             admission of a solo session; any other status or an ERROR
             record on the server's logger fails the run.  It prints the
             request and feed round trips beside the library's wall and
             the pool's step, the SSE time to first delta, peak memory.
9. numbers — RTF, decode ms/token, the weight stream per decode step
             against its bound, passes, peak GPU memory, the sessions'
             step ms and step RTF against the step's bound, time to first
             text, tokens per pass, cache bytes, each beside the card
             name and power limit.

The full-width q4 / q4g trees tile ONE quantized random layer per stack
(as random_w8_params tiles its codes): quantizing 4 billion normal
draws on the host takes minutes.  The 131072 x 3072 token table is drawn
as random Q4_0 codes and scales directly, for the same reason.

The script imports the port (``voxtral_tpu_torch``) only, and fails if
``jax`` or any module of the JAX package ``voxtral_tpu`` was loaded by
the end of the run.

The second-to-last line of stdout is the kernels' JSON record, the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

AUDIO_SECS = 16.0
W8_PLAIN_SECS = 6.0   # the w8 plain-path one-shot runs (sequential, ngram)
PAD_PLAIN_SECS = 3.0  # the plain-path pad-draft speculative run (w8)
Q4G_PLAIN_SECS = 6.0  # the q4g plain paths (sequential, spec), a prefix
Q4_SECS = 4.0         # the packed-q4 one-shot (per-op, host-bound)
SR = 16000

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s and
# bf16 FLOP/s.  A bound is the larger of bytes / HBM rate and operations
# / the rate of their type.
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
F64_TC_FLOPS = 67e12  # the f64 tensor cores (DMMA)
F64_FLOPS = 34e12     # f64 outside the tensor cores (an fma is two)

# K2: the int32 sum is exact and both versions apply (z * sx) * scale in
# f32, so they must agree to the last bit; the bound is the one the port
# promises, 1e-6 relative.
K2_RTOL = 1e-6
# K1: kernel and plain version accumulate every float reduction in f64
# and round once to f32, and the kernels are built without FMA
# contraction, so they agree bit for bit unless a libm routine (expf,
# sqrtf) differed by an ulp.  Such an ulp can flip an int8 activation
# code, which 26 layers of random weights amplify (measured ~8% of the
# logits when the reductions were f32 in different orders).  Bound: 1e-5
# of the largest value for x_out and the logits, one bf16 ulp for k/v.
K1_RTOL = 1e-5
KV_RTOL = 2 ** -8
# A token flip between the kernel and the plain path is accepted only at
# a near-tie: the plain path's top-2 logit margin there below this (the
# logits of this model span about +-3.5; a few f32 ulps of drift).
MARGIN_TIE = 1e-3
# Speculative against sequential tokens: the spec step reads the fresh
# rows i < j as f32 where the sequential step reads them back from the
# bf16 cache, so their logits differ by bf16-rounding amounts (the JAX
# test allows 2e-3 relative, tests/test_spec_decode.py); with logits of
# about +-3.5 a flip is a near-tie below 2e-3 x 3.5 ~ 1e-2.
SPEC_MARGIN_TIE = 1e-2
# Two cache layouts (bounded and head+ring) of one encoder attention
# layer at full width: the same visible keys in another slot order,
# beside another count of masked slots (exact zeros), so the f32 sums
# round otherwise and the bf16 output moves by at most an ulp either way.
LAYOUT_LAYER_RTOL = 2 ** -7
# Sessions of two layouts (or a session and the one-shot path) carry
# such roundings through 58 layers of random weights, which amplify
# them: measured against a pair of bounded sessions that differ in their
# cache length alone (the noise a layout change makes without any ring).
# The head+ring session may differ from the bounded one by at most this
# factor times that noise, in audio embeds and in logits; a token flip
# between layouts is accepted only at a top-2 margin below twice the
# noise's largest logit difference.
LAYOUT_NOISE_FACTOR = 3.0
SPEC_K = 8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def release() -> None:
    """Free what the finished phase held on the card.  A pool and its
    unfinished sessions refer to each other, so dropping the names leaves
    their caches to the cycle collector: run it, then return the freed
    blocks, or the next phase's peak memory counts them."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device ms per call of ``fn`` with the host out of the way: ``reps``
    calls captured in one CUDA graph, the graph replayed ``iters`` times
    (for a wrapper whose host work outlasts its kernels)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = cuda_ms(graph.replay, iters) / reps
    del graph
    return ms


def in_turns(kernel_fn, plain_fn, iters: int, plain_iters: int):
    """(kernel ms, plain ms), timed kernel, plain, kernel: the plain
    version, a yardstick many times slower (no check reads its time),
    once between the kernel's two."""
    k1 = cuda_ms(kernel_fn, iters)
    p = cuda_ms(plain_fn, plain_iters)
    k2 = cuda_ms(kernel_fn, iters)
    return (k1 + k2) / 2, p


def bound(nbytes: float, ops: float, peak_ops: float):
    """(bound ms, "bytes" or "operations") on the H100's peaks."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def chirp() -> np.ndarray:
    """The 16 s speech-band chirp of bench.py."""
    t = np.arange(int(AUDIO_SECS * SR)) / SR
    return (0.5 * np.sin(2 * np.pi * (200 + 150 * t) * t)).astype(np.float32)


def compare(tag, got, ref, tols):
    """Fail unless each output is within its tolerance (share of the
    largest value) of the plain version's; -> worst abs error."""
    import torch

    worst = 0.0
    for name, g, r, tol in zip(("x_out", "k_new", "v_new", "logits"), got,
                               ref, tols):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        rel = err / r.abs().max().item()
        print(f"{tag} {name}: max_abs_err {err:.3e} ({rel:.3e} of max, "
              f"bit-equal {torch.equal(g, r)})", flush=True)
        if not rel <= tol:
            fail(f"{tag} {name}: error {rel:.3e} of max > {tol}")
        worst = max(worst, err)
    if got[3].argmax(-1).tolist() != ref[3].argmax(-1).tolist():
        fail(f"{tag}: argmax differs from the plain version")
    return worst


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------


def pool_k2_shapes(cfg, streams: int) -> list:
    """(M, K, N) of a pooled step's K2 launches at ``streams`` slots: the
    encoder's linears (wq / wk / wv, wo, w1 / w3, w2) at streams x 4P
    rows and the adapter's two at streams x P."""
    e, a = cfg.audio_encoder, cfg.adapter
    qd = e.n_heads * e.head_dim
    me, ma = streams * 4 * P_STEP, streams * P_STEP
    return [(me, e.dim, qd), (me, qd, e.dim), (me, e.dim, e.hidden_dim),
            (me, e.hidden_dim, e.dim), (ma, a.input_dim, a.output_dim),
            (ma, a.output_dim, a.output_dim)]


def k2_shapes(cfg) -> list:
    """(M, K, N) of every K2 launch shape ``check_k2`` holds and times
    (``benches/torch_k2_times.py`` times the same list)."""
    # (M, K, N): lm_head after prefill; prefill wq; encoder w1 and w2
    # (608 positions for 16 s); adapter w1 (152 positions); ADA w0 / w2;
    # the encoder's wq / wk / wv and wo at 608 positions.
    # Then the live session's: a steady step's encoder at its 32 new
    # frames (wq / wk / wv, wo, w1 / w3, w2) and adapter at P = 8 rows
    # (w1, w2); the first step's encoder head (152 frames) and adapter
    # (38 rows); its per-op decoder at one row (wq, wk / wv, wo, w1 / w3,
    # w2).  Then the pooled step's, for every pool size this script
    # builds (``make_pool`` refuses another).
    shapes = [(1, 3072, 131072), (38, 3072, 4096), (608, 1280, 5120),
              (608, 5120, 1280), (152, 5120, 3072), (1, 3072, 32),
              (1, 32, 3072), (608, 1280, 2048), (608, 2048, 1280),
              (32, 1280, 2048), (32, 2048, 1280), (32, 1280, 5120),
              (32, 5120, 1280), (8, 5120, 3072), (8, 3072, 3072),
              (152, 1280, 5120), (38, 5120, 3072), (1, 3072, 4096),
              (1, 3072, 1024), (1, 4096, 3072), (1, 3072, 9216),
              (1, 9216, 3072)]
    for streams in POOL_STREAMS:
        shapes += [sh for sh in pool_k2_shapes(cfg, streams)
                   if sh not in shapes]
    return shapes


def check_k2(cfg, dev, card):
    """K2 at the main path's shapes -> (max abs err, {shape: (device ms,
    plain ms, library ms or None, bound ms, bound by, route, GEMV ms or
    None, host-called ms)}).  Kernel, library call and GEMV route are
    timed on the device (CUDA graph), the wrapper also from the host.
    Each line names the route ``k2_plan`` gave the shape; at 16 < M <= 64
    rows the GEMV is timed beside the tensor-core GEMM (the plan's choice
    there rests on these times)."""
    import torch

    from voxtral_tpu_torch.ops import w8_kernel as k2

    shapes = k2_shapes(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    worst, times, above = 0.0, {}, []
    for m, k, n in shapes:
        xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev,
                           generator=gen)
        codes = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                              device=dev, generator=gen)
        sx = torch.rand((m, 1), device=dev, generator=gen) * 0.1 + 1e-3
        scale = torch.rand((n,), device=dev, generator=gen) * 1e-2 + 1e-4
        got = k2.w8_matmul(xq, sx, codes, scale)
        torch.cuda.synchronize()
        ref = k2.w8_matmul_plain(xq, sx, codes, scale)
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        if not rel <= K2_RTOL:
            fail(f"K2 w8_matmul {m}x{k}x{n}: error {rel:.3e} of max > "
                 f"{K2_RTOL}")
        worst = max(worst, err)
        host_ms, plain_ms = in_turns(
            lambda: k2.w8_matmul(xq, sx, codes, scale),
            lambda: k2.w8_matmul_plain(xq, sx, codes, scale), 20, 3)
        ms = graph_ms(lambda: k2.w8_matmul(xq, sx, codes, scale))
        route, splits = k2.w8_matmul_route(xq, codes)
        path = (f"{k2.ROUTE_NAMES[route]}"
                + (f", K in {splits} slices" if splits > 1 else ""))
        gemv_ms = None
        if route != k2.ROUTE_GEMV and m <= 64:
            alt = k2.w8_matmul_on(k2.ROUTE_GEMV, xq, sx, codes, scale)
            torch.cuda.synchronize()
            if not torch.equal(alt, ref):
                fail(f"K2 w8_matmul {m}x{k}x{n}: the GEMV route is not "
                     "bit-equal to the plain version")
            gemv_ms = graph_ms(lambda: k2.w8_matmul_on(k2.ROUTE_GEMV, xq,
                                                       sx, codes, scale))
            path += f"; the GEMV route {gemv_ms:.4f} ms"
        # The library call computing the same function: cuBLAS's int8 GEMM
        # (torch._int_mm, exact int32) + the same f32 epilogue, its
        # device time as the kernel's.  It refuses M <= 16 (and K or N
        # not % 8).
        try:
            lib_ms = graph_ms(lambda: torch._int_mm(xq, codes.T).float()
                              * sx * scale)
            lib = f"{lib_ms:.4f} ms"
        except (RuntimeError, NotImplementedError) as exc:
            lib_ms = None
            lib = f"refused ({str(exc).splitlines()[0][:80]})"
        if lib_ms is not None and m > 16 and ms > lib_ms:
            above.append(f"{m}x{k}x{n} ({ms:.4f} > {lib_ms:.4f} ms)")
        out = m * n * 4
        b_ms, b_by = bound(nbytes(xq, sx, codes, scale) + out, 2 * m * n * k,
                           INT8_OPS)
        times[(m, k, n)] = (ms, plain_ms, lib_ms, b_ms, b_by, path, gemv_ms,
                            host_ms)
        gbs = (m * k + n * k) / ms / 1e6
        print(f"K2 w8_matmul M={m} K={k} N={n}: max_abs_err {err:.3e} "
              f"(bit-equal {torch.equal(got, ref)}), kernel {ms:.4f} ms on "
              f"the device (CUDA graph; {gbs:.1f} GB/s of int8 operands), "
              f"{host_ms:.4f} ms called from the host, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"torch._int_mm + epilogue {lib} on the device; path {path} "
              f"[{card}]", flush=True)
    n_lib = sum(1 for (m, _, _), t in times.items()
                if m > 16 and t[2] is not None)
    print(f"K2 above 16 rows, device times: at or below torch._int_mm + "
          f"epilogue at {n_lib - len(above)} of {n_lib} shapes; above at "
          f"{', '.join(above) or 'none'} [{card}]", flush=True)
    return worst, times


# q4 path shapes (N, K): wq, wk / wv, wo, w1 / w3, w2, lm_head; the live
# session's adapter w1 and w2 (at P = 8 rows).
K3_SHAPES = [(4096, 3072), (1024, 3072), (3072, 4096), (9216, 3072),
             (3072, 9216), (131072, 3072), (3072, 5120), (3072, 3072)]


def check_k3(dev, card):
    """K3 at every shape of the q4 path, M = 1 and 8, bit-equal to its
    plain version (the same f32 group sums in k order, the groups in f64)
    -> (max abs err, {(M, N, K): (device ms, plain ms, bound ms, bound
    by, host-called ms)}).  Device ms: 20 calls in a CUDA graph;
    host-called: the wrapper's loop between CUDA events."""
    import torch

    from voxtral_tpu_torch.ops import q4_kernel as k3

    gen = torch.Generator(device=dev).manual_seed(3)
    worst, times = 0.0, {}
    for n, k in K3_SHAPES:
        # Any int32 is a valid word of eight nibbles.
        packed = torch.randint(-2 ** 31, 2 ** 31, (k // 8, n),
                               dtype=torch.int32, device=dev, generator=gen)
        sign = torch.randint(0, 2, (k // 32, n), device=dev,
                             generator=gen) * 2 - 1
        scales = ((torch.rand((k // 32, n), device=dev, generator=gen)
                   * 4e-3 + 1e-3) * sign).to(torch.bfloat16)
        for m in (1, 8):
            x = torch.randn((m, k), device=dev, generator=gen)
            got = k3.q4_matmul_packed(x, packed, scales)
            torch.cuda.synchronize()
            ref = k3.q4_matmul_plain(x, packed, scales)
            err = (got - ref).abs().max().item()
            if not torch.equal(got, ref):
                fail(f"K3 q4_matmul M={m} N={n} K={k}: not bit-equal to the "
                     f"plain version (max abs err {err:.3e})")
            worst = max(worst, err)
            call = lambda: k3.q4_matmul_packed(x, packed, scales)  # noqa
            host, plain_ms = in_turns(
                call, lambda: k3.q4_matmul_plain(x, packed, scales), 20, 2)
            ms = graph_ms(call)
            b_ms, b_by = bound(nbytes(x, packed, scales) + m * n * 4,
                               2 * m * n * k, BF16_FLOPS)
            times[(m, n, k)] = (ms, plain_ms, b_ms, b_by, host)
            print(f"K3 q4_matmul M={m} N={n} K={k}: bit-equal, plan "
                  f"{k3.k3_plan(m, n, k)}; kernel {ms:.4f} ms on the device "
                  f"(CUDA graph; {nbytes(packed, scales) / ms / 1e6:.1f} GB/s "
                  f"of weights), {host:.4f} ms called from the host, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{100 * b_ms / ms:.1f} % of it) [{card}]", flush=True)
    return worst, times


def lm_fold(model):
    """(final norm, lm codes, lm scale) of the model's K1 lm fold: the
    w8 or g32 table, or the dense bf16 table (no scale) in mode (g)."""
    dec = model.params["decoder"]
    if model.decode_route == "q4g":
        f = model.fused_decode
        return dec["norm"].float(), f["lm_codes"], f["lm_scale"]
    if model.decode_route == "bf16":
        return dec["norm"].float(), dec["tok_embeddings"], None
    emb = dec["tok_embeddings"]["w8"]
    return dec["norm"].float(), emb["codes"], emb["scale"]


def stack_tensors(fused) -> list:
    """The four weight stacks of a fused dict, mode (g)'s segments
    (wq / wk / wv, w1 / w3) one by one."""
    out = []
    for key in ("wqkv", "wo", "w13", "w2"):
        w = fused[key]
        out += list(w) if isinstance(w, tuple) else [w]
    return out


def n_stack_weights(model) -> int:
    return sum(t.numel() for t in stack_tensors(model.fused_decode))


def weight_ops_peak(model) -> float:
    """The peak rate of the step's products: mode (g)'s exact bf16
    products are summed on the f64 tensor cores, the others are int8."""
    return F64_TC_FLOPS if model.decode_route == "bf16" else INT8_OPS


# The launch classes of a K1 step (kernel name fragment -> class), and the
# step's GEMVs in launch order: four a layer, then the lm head or fold.
K1_CLASSES = (("row_quant", "row_quant"), ("attn", "attention"),
              ("argmax_merge", "lm fold merge"))
K1_GEMVS = ("qkv", "wo", "w13", "w2")


def k1_breakdown(fn, n_layers: int, steps: int = 3) -> dict:
    """Device ms of one K1 step ``fn`` by launch class, summed over the
    step (``torch.profiler``, ``steps`` eager steps): row_quant, each
    GEMV shape (by launch order), the attention, the lm head or fold and
    its merge; beside them the step in a CUDA graph and the idle share
    (graph ms less the kernels' sum, over graph ms).  A kernel launched
    early (programmatic dependent launch) counts its wait too, so time
    ``fn`` in plain stream order (ops.decode_step.K1_PDL = False) for
    each class's own time.  {"error": ...} when the profiler saw no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not evts:
        return {"error": "the profiler saw no device time"}
    per_step = 4 * n_layers + 1
    out, n_gemv = {}, 0
    for e in evts:
        name = e.name
        cls = next((c for frag, c in K1_CLASSES if frag in name), None)
        if cls is None and "emcpy" in name:
            cls = "memcpy"
        if cls is None and ("gemv" in name or "stream" in name
                            or "argmax_tile" in name):
            i = n_gemv % per_step
            cls = ("lm head or fold" if i == per_step - 1
                   else f"gemv {K1_GEMVS[i % 4]}")
            n_gemv += 1
        cls = cls or f"other {name[:40]}"
        us = e.time_range.end - e.time_range.start
        out[cls] = out.get(cls, 0.0) + us / 1e3 / steps
    total = sum(out.values())
    g_ms = graph_ms(fn, reps=10, iters=5)
    return {"classes_ms": {k: round(v, 4) for k, v in sorted(out.items())},
            "kernel_sum_ms": round(total, 4), "graph_ms": round(g_ms, 4),
            "idle_share": round((g_ms - total) / g_ms, 4),
            "gemv_launches_per_step": n_gemv / steps}


def step_weight_bytes(model) -> int:
    """Bytes of weights one K1 step streams, from the shapes: codes (or
    bf16 weights) and scales of the four stacks and of the lm table,
    plus the norms."""
    fused = model.fused_decode
    keys = ("sqkv", "so", "s13", "s2", "attn_norm", "ffn_norm")
    return nbytes(*stack_tensors(fused), *(fused[k] for k in keys),
                  *lm_fold(model)[1:])


def check_k1(model, dev, card, offs, spec, iters, plain_iters):
    """One K1 step (26 layers + lm fold) on the model's fused weights
    over len(offs) streams x ``spec`` rows against the plain version.
    ``offs`` an int: mode (a), one stream at that scalar offset, cache
    S = 240; a list: an int32 device offset per stream and RoPE per row,
    cache S = 240 + spec - 1.  Timed on the device (a CUDA graph of the
    step) and from the host (a loop of calls).  -> (max abs err, device
    ms, plain ms, bound ms, bound by, host-called ms)."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    cfg = model.config.language_model
    fused = model.fused_decode
    L, D, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    scalar = isinstance(offs, int)
    offl = [offs] if scalar else offs
    S, bc = 240 + spec - 1, len(offl)
    gen = torch.Generator(device=dev).manual_seed(1 if scalar
                                                  else 2 + bc * spec)
    shape = (L, bc, cfg.n_kv_heads, S, hd)
    kc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    x = torch.randn((bc * spec, D), device=dev, generator=gen)
    off = torch.tensor(offl, dtype=torch.int32, device=dev)
    if scalar:
        c, s = k1.rope_pair_vectors(offs, hd, cfg.rope_theta, device=dev)
        off = offs
    else:
        pos = (off[:, None] + torch.arange(spec, device=dev)).reshape(-1)
        c, s = k1.rope_pair_vectors(pos, hd, cfg.rope_theta, device=dev)
    ada = k1.ada_vectors(model.params["decoder"], model.t_embed(6.0))
    args = (x, off, fused["attn_norm"], fused["ffn_norm"], ada,
            fused["sqkv"], fused["so"], fused["s13"], fused["s2"], c, s,
            kc, vc, fused["wqkv"], fused["wo"], fused["w13"], fused["w2"],
            *lm_fold(model))
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
              eps=cfg.norm_eps, window=cfg.sliding_window, spec=spec)
    tag = (f"K1 decode_stack_step [{model.decode_route}] spec={spec} "
           f"streams={bc} rows={bc * spec}")
    got = k1.decode_stack_step(*args, **kw)
    torch.cuda.synchronize()
    ref = k1.decode_stack_step_plain(*args, **kw)
    worst = compare(tag, got, ref, (K1_RTOL, KV_RTOL, KV_RTOL, K1_RTOL))
    call = lambda: k1.decode_stack_step(*args, **kw)  # noqa: E731
    host_ms, plain_ms = in_turns(
        call, lambda: k1.decode_stack_step_plain(*args, **kw), iters,
        plain_iters)
    ms = graph_ms(call, reps=10, iters=5)
    wbytes = step_weight_bytes(model)
    # What the step must move: its weights once, the cache slots below
    # each stream's offset, x in and out, k/v new, logits out.
    n_vocab = lm_fold(model)[1].shape[0]
    kv_read = sum(2 * L * cfg.n_kv_heads * o * hd * 2 for o in offl)
    moved = (wbytes + kv_read + 2 * nbytes(x) + 2 * nbytes(got[1])
             + bc * spec * n_vocab * 4)
    n_weights = n_stack_weights(model)
    b_ms, b_by = bound(moved, 2 * bc * spec * (n_weights + n_vocab * D),
                       weight_ops_peak(model))
    tag = f"{tag} S={S} offsets {offl[0]}..{offl[-1]}"
    print(f"{tag}: kernel {ms:.3f} ms on the device (CUDA graph), "
          f"{host_ms:.3f} ms called from the host, plain {plain_ms:.3f} ms; "
          f"weights {wbytes / 1e9:.4f} GB/pass -> {wbytes / ms / 1e6:.1f} "
          f"GB/s; bound {b_ms:.4f} ms ({b_by}; {100 * b_ms / ms:.1f} % of "
          f"it) [{card}]", flush=True)
    return worst, ms, plain_ms, b_ms, b_by, host_ms


def tp_stacks(fmt: str, cfg, dev, seed: int = 0) -> dict:
    """Random local stacks of one shard at tp = 2, cfg.n_layers layers:
    wqkv [L, nqkv_l, D], wo [L, D, nq_l], w13 [L, 2 F_l, D], w2 [L, D,
    F_l] int8 codes, one layer's scales (f32 rows, or f16 groups in
    g32), the norms and the ADA vector.  Shared with
    benches/torch_tp_times.py."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    L, D = cfg.n_layers, cfg.dim
    nq = cfg.n_heads // 2 * cfg.head_dim
    nkv = cfg.n_kv_heads // 2 * cfg.head_dim
    fl = cfg.hidden_dim // 2

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                             generator=gen)

    def scales(n, k):
        if fmt == "g32":
            return (torch.rand((n, k // 32), device=dev, generator=gen)
                    * 2e-3 + 1e-4).half()
        return torch.rand((n,), device=dev, generator=gen) * 4e-4 + 1e-5

    def vec():
        return 1 + 0.1 * torch.randn((D,), device=dev, generator=gen)

    nqkv = nq + 2 * nkv
    return {"wqkv": codes(L, nqkv, D), "sqkv": scales(nqkv, D),
            "wo": codes(L, D, nq), "so": scales(D, nq),
            "w13": codes(L, 2 * fl, D), "s13": scales(2 * fl, D),
            "w2": codes(L, D, fl), "s2": scales(D, fl),
            "attn_norm": vec(), "ffn_norm": vec(), "ada": vec()}


TP_CLASSES = (("row_quant", "row"), ("attn", "attention"),
              ("emcpy", "memcpy"))


def tp_breakdown(fn, kern: str, steps: int = 5) -> dict:
    """Device ms of one K4 / K5 call ``fn`` by launch class, summed over
    the call (``steps`` eager calls under ``torch.profiler``): the row
    kernels, the attention, the GEMVs by their order in a call (K4: qkv
    before the attention, wo after it; K5: w13, then w2).  A kernel
    launched ahead of its predecessor counts its wait too.  Shared with
    benches/torch_tp_times.py."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not evts:
        return {"error": "the profiler saw no device time"}
    out, launches, n_gemv, after = {}, 0, 0, False
    for e in evts:
        cls = next((c for frag, c in TP_CLASSES if frag in e.name), None)
        if cls == "attention":
            after = True
        elif cls is None:
            if kern == "K4":
                cls, after = ("gemv wo" if after else "gemv qkv"), False
            else:
                cls = ("gemv w13", "gemv w2")[n_gemv % 2]
                n_gemv += 1
        launches += 1
        us = e.time_range.end - e.time_range.start
        out[cls] = out.get(cls, 0.0) + us / 1e3 / steps
    return {"classes_ms": {k: round(v, 5) for k, v in sorted(out.items())},
            "kernel_sum_ms": round(sum(out.values()), 5),
            "launches_per_call": launches / steps,
            "names": sorted({e.name[:60] for e in evts})}


def check_k1_modes(model, dev, card):
    """K1 at 1 row (mode a), spec=8 at 8 and 64 rows (b), 4 rows (c)."""
    one = check_k1(model, dev, card, 235, 1, 20, 1)
    spec8 = check_k1(model, dev, card, [235], SPEC_K, 20, 1)
    spread = [150 + round(i * 85 / 7) for i in range(8)]  # 150 .. 235
    spec64 = check_k1(model, dev, card, spread, SPEC_K, 10, 1)
    rows4 = check_k1(model, dev, card, [60, 120, 180, 235], 1, 20, 1)
    print(f"K1 step ms on the device (CUDA graph) [{model.decode_route}] "
          f"[{card}]: 1 row {one[1]:.3f}, spec={SPEC_K} 8 rows "
          f"{spec8[1]:.3f}, 64 rows {spec64[1]:.3f}; 4 rows with per-row "
          f"offsets {rows4[1]:.3f}", flush=True)
    return {"one": one, "spec8": spec8, "spec64": spec64, "rows4": rows4,
            "err": max(one[0], spec8[0], spec64[0], rows4[0])}


# ---------------------------------------------------------------------------
# Main-path runs
# ---------------------------------------------------------------------------


def first_divergence(name, got, ref, margins, tie):
    """Fail unless ``got`` equals ``ref`` or first differs where the
    reference's top-2 margin is below ``tie``; -> tokens identical."""
    if got.tolist() == ref.tolist():
        return True
    i = int(np.nonzero(got != ref)[0][0])
    margin = float(margins[i])
    print(f"{name}: first token divergence at position {i}: {got[i]} vs "
          f"{ref[i]}, reference top-2 margin {margin:.3e} (tie threshold "
          f"{tie})", flush=True)
    if not margin < tie:
        fail(f"{name}: tokens diverge at a margin above the near-tie "
             "threshold")
    return False


def spec_held(name, spec, seq, margins, spec_margins=None):
    """A q4g mesh's speculative tokens against its sequential ones by the
    spec near-tie rule (first_divergence with SPEC_MARGIN_TIE).  A parting
    above the near-tie passes only by the margin-gap rule
    (tp_against_single) with ``spec_margins()``, the speculative run's own
    top-2 margins: a speculative pass reads its earlier fresh rows in f32
    where the sequential step reads them back from the bf16 cache
    (fresh_through_cache, held in mesh_oneshot, is the witness), and on
    the random q4g tree that moves the logits beyond the near-tie, so the
    two may part only where the sequential margin is below twice their
    margin gap before the parting (ROADMAP §3).  w8 meshes keep the
    near-tie rule alone -> tokens identical."""
    if spec.tolist() == seq.tolist():
        return True
    i = int(np.nonzero(spec != seq)[0][0])
    margin = float(margins[i])
    print(f"{name}: first token divergence at position {i}: {spec[i]} vs "
          f"{seq[i]}, reference top-2 margin {margin:.3e} (tie threshold "
          f"{SPEC_MARGIN_TIE})", flush=True)
    if margin < SPEC_MARGIN_TIE:
        return False
    if spec_margins is None:
        fail(f"{name}: tokens diverge at a margin above the near-tie "
             "threshold")
    agree, gap, part = tp_against_single(
        spec, spec_margins(), seq, margins,
        f"{name}: speculative parts from sequential")
    print(f"{name}: above the near-tie; the margin-gap rule: the first "
          f"{agree} tokens agree, margin gap over them {gap:.4e}, "
          f"sequential margin at the parting {part:.4e}", flush=True)
    return False


def fresh_through_cache(attn):
    """The witness for a speculative pass parting from the sequential
    steps: ``attn`` (``ops.decode_step._attention_plain``) with a pass's
    rows taken one at a time as the sequential step takes them, row j at
    offset ``offs + j`` over the cache with the earlier rows' K / V
    written into it through the cache's dtype (bf16), where the pass
    reads them in f32.  Sequential calls (spec = 1) are unchanged."""
    import torch

    def one_by_one(q, k, v, k_cache, v_cache, offs, window, spec, n_kv,
                   scale, ring=None, k_scales=None, v_scales=None,
                   cache_chunk=None):
        if spec == 1:
            return attn(q, k, v, k_cache, v_cache, offs, window, spec, n_kv,
                        scale, ring, k_scales, v_scales, cache_chunk)
        if ring is not None or k_scales is not None or cache_chunk:
            fail("fresh_through_cache takes a bf16 cache without a ring")
        Bc = q.shape[0] // spec
        kc, vc = k_cache.clone(), v_cache.clone()
        rows = torch.arange(Bc, device=kc.device)
        qS, kS, vS = (t.reshape(Bc, spec, *t.shape[1:]) for t in (q, k, v))
        out = []
        for j in range(spec):
            out.append(attn(qS[:, j], kS[:, j], vS[:, j], kc, vc, offs + j,
                            window, 1, n_kv, scale))
            slot = (offs + j).long()
            kc[rows, :, slot] = kS[:, j].to(kc.dtype)
            vc[rows, :, slot] = vS[:, j].to(vc.dtype)
        return torch.stack(out, dim=1).reshape(q.shape[0], -1)

    return one_by_one


def counted_run(pipe, sig, dev):
    """transcribe_samples once after a warm-up, with every kernel's
    launch counter set to 0 just before and read just after ->
    (wall s, {kernel: launches}, peak GB, the chunks' tokens).  The
    warm-up (cuBLAS / cuDNN handles) is the same path one level down,
    where the tokens can be read."""
    chunks = pipe._chunk_tokens(sig, SR)
    _, wall, launches, peak = counted(
        lambda: pipe.transcribe_samples(sig, SR), dev)
    return wall, launches, peak, chunks


def plain_tokens(plain, tok, sig, pcfg=None):
    """The plain path's tokens and top-2 margins for the chirp."""
    from voxtral_tpu_torch.pipeline import TranscribePipeline

    plain.record_margins = True
    toks = TranscribePipeline(plain, tok, pcfg)._chunk_tokens(sig, SR)[0]
    margins = plain.last_margins[0].copy()
    if not np.isfinite(margins).all():
        fail("non-finite logits on the plain path")
    return toks, margins


def encode_seconds(pipe, model, padded) -> float:
    """Host mel + encoder + adapter, end to end."""
    import torch

    t0 = time.perf_counter()
    mel = pipe.mel.compute_log_batch(padded)
    with torch.no_grad():
        model.encode_audio(mel)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_w8(cfg, dev, card, sig, tok):
    """Phase 3: the w8 model, its kernel checks and main path."""
    import torch

    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.models.voxtral import PREFIX_LEN, VoxtralModel
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline
    from voxtral_tpu_torch.utils.quantize import random_w8_params

    t0 = time.perf_counter()
    params = params_from_numpy(random_w8_params(cfg, seed=0), dev)
    model = VoxtralModel(params, cfg, dev)
    plain = VoxtralModel(params, cfg, dev, kernels=False)
    plain.fused_decode = model.fused_decode  # the same stacks, not a copy
    torch.cuda.synchronize()
    print(f"random w8 weights (seed 0) built and moved: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    k2_err, k2_times = check_k2(cfg, dev, card)
    k1w = check_k1_modes(model, dev, card)

    pipe = TranscribePipeline(model, tok)
    # The kernel path's margins judge near-ties against the speculative
    # runs (bit-equal to the plain path's where both ran).
    model.record_margins = True
    try:
        wall, launches, peak_gb, chunks = counted_run(pipe, sig, dev)
        seq_margins = model.last_margins[0].copy()
    finally:
        model.record_margins = False
    if len(chunks) != 1:
        fail(f"16 s should be one chunk, got {len(chunks)}")
    tokens = chunks[0]
    padded = pipe.padded_chunks(sig, SR)[0].samples
    padded_mel_t = pipe.mel.num_frames(len(padded))
    seq = model.decoder_seq_len(padded_mel_t)
    n_tok = seq - PREFIX_LEN
    n_steps = n_tok - 1
    print(f"main path: mel T={padded_mel_t}, decoder positions {seq}, "
          f"{len(tokens)} tokens, {n_steps} decode steps", flush=True)
    if len(tokens) != n_tok:
        fail(f"token count {len(tokens)} != decoder_seq_len - 38 = {n_tok}")
    if launches["decode_stack_step"] != n_steps:
        fail(f"K1 launches {launches['decode_stack_step']} != decode steps "
             f"{n_steps}")
    e, lm = cfg.audio_encoder, cfg.language_model
    min_k2 = e.n_layers * 7 + 2 + lm.n_layers * 9
    if launches["w8_matmul"] < min_k2:
        fail(f"K2 launches {launches['w8_matmul']} < encoder + adapter + "
             f"prefill linears {min_k2}")
    print(f"launch counts in the w8 main-path run: K2 w8_matmul "
          f"{launches['w8_matmul']} (encoder + adapter + prefill linears: "
          f"{min_k2}), K1 decode_stack_step {launches['decode_stack_step']}",
          flush=True)
    # The plain versions take ~0.1 s a step: the pairs run on the chirp's
    # first W8_PLAIN_SECS (PAD_PLAIN_SECS with pad drafts, a pass per
    # token).
    head = sig[:int(W8_PLAIN_SECS * SR)]
    k_head = pipe._chunk_tokens(head, SR)[0]
    p_tokens, p_margins = plain_tokens(plain, tok, head)
    same = first_divergence("w8 sequential kernel vs plain", k_head,
                            p_tokens, p_margins, MARGIN_TIE)
    print(f"tokens kernel == plain over the first {W8_PLAIN_SECS:.0f} s "
          f"({len(k_head)} tokens): {same} ({len(set(tokens.tolist()))} "
          f"distinct over 16 s; min plain top-2 margin "
          f"{float(p_margins.min()):.3e})", flush=True)

    spec_runs = {}
    for draft in ("ngram", "pad"):
        pcfg = PipelineConfig(speculative=SPEC_K, draft=draft)
        spipe = TranscribePipeline(model, tok, pcfg)
        s_wall, s_launch, s_peak, s_chunks = counted_run(spipe, sig, dev)
        passes = model.last_spec_passes
        tag = f"w8 speculative K={SPEC_K} draft={draft}"
        if s_launch["decode_stack_step"] != passes or passes < 1:
            fail(f"{tag}: K1 launches {s_launch['decode_stack_step']} != "
                 f"passes {passes}")
        if s_launch["w8_matmul"] < min_k2:
            fail(f"{tag}: K2 launches {s_launch['w8_matmul']} < {min_k2}")
        s_tokens = s_chunks[0]
        if len(s_tokens) != n_tok:
            fail(f"{tag}: {len(s_tokens)} tokens != {n_tok}")
        same_seq = first_divergence(f"{tag} vs sequential kernel", s_tokens,
                                    tokens, seq_margins, SPEC_MARGIN_TIE)
        part = sig[:int((W8_PLAIN_SECS if draft == "ngram"
                         else PAD_PLAIN_SECS) * SR)]
        k_tokens = spipe._chunk_tokens(part, SR)[0]
        ps_tokens, ps_margins = plain_tokens(plain, tok, part, pcfg)
        if len(k_tokens) != len(ps_tokens) or len(k_tokens) < 2 * SPEC_K:
            fail(f"{tag}: {len(k_tokens)} kernel tokens against "
                 f"{len(ps_tokens)} plain ones")
        same_plain = first_divergence(f"{tag} kernel vs plain", k_tokens,
                                      ps_tokens, ps_margins, MARGIN_TIE)
        spec_runs[draft] = dict(wall=s_wall, launches=s_launch,
                                passes=passes, peak=s_peak)
        print(f"{tag}: launch counts K2 w8_matmul {s_launch['w8_matmul']}, "
              f"K1 decode_stack_step {s_launch['decode_stack_step']} = "
              f"passes {passes} ({n_steps / passes:.3f} decode tokens per "
              f"pass); tokens == sequential kernel: {same_seq}, == spec "
              f"plain over {len(part) / SR:.0f} s ({len(k_tokens)} tokens): "
              f"{same_plain}", flush=True)

    mel = pipe.mel.compute_log_batch(padded)
    mel3 = np.concatenate([mel, mel * 0.9, mel * 1.1], axis=0)
    model.record_margins = True
    b_seq = model.transcribe_streaming_batch(mel3)
    b_margins = model.last_margins
    model.record_margins = False
    b_spec = model.transcribe_streaming_batch(mel3, speculative=4)
    b_same = [first_divergence(f"batched speculative=4 row {r}", b_spec[r],
                               b_seq[r], b_margins[r], SPEC_MARGIN_TIE)
              for r in range(3)]
    print(f"batched speculative=4, 3 rows (x, 0.9x, 1.1x): tokens == "
          f"sequential batch per row {b_same}, {model.last_spec_passes} "
          f"passes for {n_steps} decode positions", flush=True)

    enc_s = encode_seconds(pipe, model, padded)
    step_bytes = step_weight_bytes(model)
    report("w8", wall, enc_s, n_tok, peak_gb, card)
    print(f"w8 decode step weight stream: {step_bytes / 1e9:.4f} GB/step / "
          f"{k1w['one'][1]:.3f} ms = {step_bytes / k1w['one'][1] / 1e6:.1f} "
          f"GB/s; bound {step_bytes / HBM_BPS * 1e3:.4f} ms [{card}]",
          flush=True)
    for draft, run in spec_runs.items():
        report(f"w8 speculative K={SPEC_K} draft={draft}", run["wall"],
               enc_s, n_tok, run["peak"], card, run["passes"], n_steps,
               k1w["spec8"][1])
    return dict(k2_err=k2_err, k2_times=k2_times, k1=k1w,
                launches=launches, spec_runs=spec_runs, n_tok=n_tok,
                n_steps=n_steps, model=model, plain=plain, tokens=tokens,
                margins=seq_margins)


def report(tag, wall, enc_s, n_tok, peak, card, passes=None, n_steps=None,
           spec_step_ms=None, secs=AUDIO_SECS):
    print(f"{tag}: RTF {wall / secs:.5f} ({wall * 1e3:.1f} ms for "
          f"{secs:.0f} s audio, transcribe_samples end to end), decode "
          f"stage {(wall - enc_s) * 1e3 / n_tok:.3f} ms/token (minus mel + "
          f"encoder + adapter {enc_s * 1e3:.1f} ms, over {n_tok} tokens, "
          f"prefill included), peak GPU memory {peak:.3f} GB [{card}]",
          flush=True)
    if passes:
        per_pass = (wall - enc_s) * 1e3 / passes
        print(f"{tag}: {passes} passes, {n_steps / passes:.3f} decode tokens "
              f"per pass, {per_pass:.3f} ms per pass end to end (prefill "
              f"included) against a {spec_step_ms:.3f} ms K1 spec step "
              f"[{card}]", flush=True)


# ---------------------------------------------------------------------------
# Full-width Q4_0 trees
# ---------------------------------------------------------------------------


def random_q4_tree(cfg, seed: int = 0) -> dict:
    """random_q4_params(cfg, pack=False)'s tree at full width, built in
    seconds: each stack tiles one quantized random layer; the token table
    is random Q4_0 codes (-8..7) and f16 scales drawn directly."""
    import ml_dtypes

    from voxtral_tpu_torch.ops.q4 import quantize_to_q4_params

    rng = np.random.default_rng(seed)
    e, l, a = cfg.audio_encoder, cfg.language_model, cfg.adapter
    tc = cfg.ada_rms_norm_t_cond_dim or 32
    bf16 = np.dtype(ml_dtypes.bfloat16)

    def q4(n, k, layers=0):
        w = rng.standard_normal((n, k), dtype=np.float32) * 0.02
        leaf = quantize_to_q4_params(w)["q4"]
        if layers:
            leaf = {key: np.ascontiguousarray(
                np.broadcast_to(v, (layers, *v.shape)))
                for key, v in leaf.items()}
        return {"q4": leaf}

    def dense(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.02).astype(
            bf16)

    def zeros(*shape):
        return np.zeros(shape, bf16)

    def ones(*shape):
        return np.ones(shape, bf16)

    qd_e, E = e.n_heads * e.head_dim, e.n_layers
    qd, kvd, L = l.n_heads * l.head_dim, l.n_kv_heads * l.head_dim, l.n_layers
    table = {"q4": {
        "codes": rng.integers(-8, 8, size=(l.vocab_size, l.dim),
                              dtype=np.int8),
        "scales": (rng.random((l.vocab_size, l.dim // 32), dtype=np.float32)
                   * 4e-3 + 1e-3).astype(np.float16)}}
    return {
        "encoder": {
            "conv": {"conv1": dense(e.dim, 128, 3), "conv1_b": zeros(e.dim),
                     "conv2": dense(e.dim, e.dim, 3), "conv2_b": zeros(e.dim)},
            "layers": {
                "attention_norm": ones(E, e.dim),
                "attention": {"wq": q4(qd_e, e.dim, E), "wq_b": zeros(E, qd_e),
                              "wk": q4(qd_e, e.dim, E),
                              "wv": q4(qd_e, e.dim, E), "wv_b": zeros(E, qd_e),
                              "wo": q4(e.dim, qd_e, E), "wo_b": zeros(E, e.dim)},
                "ffn_norm": ones(E, e.dim),
                "ffn": {"w1": q4(e.hidden_dim, e.dim, E),
                        "w2": q4(e.dim, e.hidden_dim, E),
                        "w2_b": zeros(E, e.dim),
                        "w3": q4(e.hidden_dim, e.dim, E)},
            },
            "norm": ones(e.dim),
        },
        "decoder": {
            "tok_embeddings": table,
            "layers": {
                "ada": {"w0": q4(tc, l.dim, L), "w2": q4(l.dim, tc, L)},
                "attention_norm": ones(L, l.dim),
                "attention": {"wq": q4(qd, l.dim, L), "wk": q4(kvd, l.dim, L),
                              "wv": q4(kvd, l.dim, L), "wo": q4(l.dim, qd, L)},
                "ffn_norm": ones(L, l.dim),
                "ffn": {"w1": q4(l.hidden_dim, l.dim, L),
                        "w2": q4(l.dim, l.hidden_dim, L),
                        "w3": q4(l.hidden_dim, l.dim, L)},
            },
            "norm": ones(l.dim),
        },
        "adapter": {"w1": q4(a.output_dim, a.input_dim),
                    "w2": q4(a.output_dim, a.output_dim)},
    }


def pack_device(codes):
    """ops.q4_kernel.pack_codes on the device: int8 [..., N, K] ->
    int32 [..., K/8, N]."""
    import torch

    *lead, n, k = codes.shape
    c = (codes.to(torch.int64) + 8).transpose(-1, -2).reshape(
        *lead, k // 8, 8, n)
    shifts = (4 * torch.arange(8, device=codes.device)).view(8, 1)
    words = (c << shifts).sum(dim=-2)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def packed_tree(tree):
    """The q4 (packed) form of an unpacked q4 tensor tree, as
    random_q4_params(pack=True) and the GGUF loader store it: leaves
    whose shape K3 takes (K % 256 == 0, N % 128 == 0) nibble-packed with
    bf16 scales; the others unchanged."""
    import torch

    if not isinstance(tree, dict):
        return tree
    q = tree.get("q4")
    if q is not None and "codes" in q:
        n, k = q["codes"].shape[-2:]
        if k % 256 == 0 and n % 128 == 0:
            return {"q4": {
                "codes_packed": pack_device(q["codes"]),
                "scales_t": q["scales"].transpose(-1, -2).to(
                    torch.bfloat16).contiguous()}}
    return {key: packed_tree(v) for key, v in tree.items()}


def check_pack_device(dev):
    """pack_device and the scale transpose agree with the host helpers."""
    import torch

    from voxtral_tpu_torch.device import to_torch
    from voxtral_tpu_torch.ops.q4_kernel import pack_codes, transpose_scales

    rng = np.random.default_rng(9)
    codes = rng.integers(-8, 8, size=(256, 512), dtype=np.int8)
    scales = (rng.random((256, 16), dtype=np.float32) * 0.01).astype(
        np.float16)
    got = packed_tree({"q4": {"codes": to_torch(codes, dev),
                              "scales": to_torch(scales, dev)}})["q4"]
    if not (torch.equal(got["codes_packed"].cpu(),
                        torch.from_numpy(pack_codes(codes)))
            and torch.equal(got["scales_t"].cpu().view(torch.int16),
                            to_torch(transpose_scales(scales), "cpu")
                            .view(torch.int16))):
        fail("device packing differs from ops.q4_kernel.pack_codes")


def run_q4g(tree, cfg, dev, card, sig, tok, n_tok):
    """Phase 5: q4g weights — K1 mode (h) checks and the main path."""
    import torch

    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline

    params = params_from_numpy(tree, dev)
    model = VoxtralModel(params, cfg, dev)
    if model.decode_route != "q4g":
        fail(f"unpacked q4 weights route to {model.decode_route}, not q4g")
    plain = VoxtralModel(params, cfg, dev, kernels=False)
    plain.fused_decode = model.fused_decode
    torch.cuda.synchronize()
    k1h = check_k1_modes(model, dev, card)
    k1h["stream"] = check_g32_stream(model, dev, card)

    pipe = TranscribePipeline(model, tok)
    wall, launches, peak, chunks = counted_run(pipe, sig, dev)
    tokens = chunks[0]
    n_steps = n_tok - 1
    if len(tokens) != n_tok:
        fail(f"q4g: {len(tokens)} tokens != {n_tok}")
    if launches["decode_stack_step"] != n_steps:
        fail(f"q4g: K1 launches {launches['decode_stack_step']} != decode "
             f"steps {n_steps}")
    # The kernel path's own margins judge speculative against
    # sequential; the plain paths run the chirp's first Q4G_PLAIN_SECS.
    model.record_margins = True
    pipe._chunk_tokens(sig, SR)
    margins = model.last_margins[0].copy()
    model.record_margins = False
    part = sig[:int(Q4G_PLAIN_SECS * SR)]
    p_tokens, p_margins = plain_tokens(plain, tok, part)
    same = first_divergence("q4g sequential kernel vs plain",
                            pipe._chunk_tokens(part, SR)[0], p_tokens,
                            p_margins, MARGIN_TIE)
    print(f"q4g main path: launch counts {launches}; tokens kernel == plain "
          f"over {Q4G_PLAIN_SECS:.0f} s ({len(p_tokens)} tokens): {same} "
          f"({len(set(tokens.tolist()))} distinct; min plain top-2 margin "
          f"{float(p_margins.min()):.3e})", flush=True)

    pcfg = PipelineConfig(speculative=SPEC_K, draft="ngram")
    spipe = TranscribePipeline(model, tok, pcfg)
    s_wall, s_launch, s_peak, s_chunks = counted_run(spipe, sig, dev)
    passes = model.last_spec_passes
    if s_launch["decode_stack_step"] != passes or passes < 1:
        fail(f"q4g spec: K1 launches {s_launch['decode_stack_step']} != "
             f"passes {passes}")
    s_tokens = s_chunks[0]
    same_seq = first_divergence("q4g speculative vs sequential", s_tokens,
                                tokens, margins, SPEC_MARGIN_TIE)
    ps_tokens, ps_margins = plain_tokens(plain, tok, part, pcfg)
    same_plain = first_divergence("q4g speculative kernel vs plain",
                                  spipe._chunk_tokens(part, SR)[0],
                                  ps_tokens, ps_margins, MARGIN_TIE)
    print(f"q4g speculative K={SPEC_K} draft=ngram: launch counts {s_launch}"
          f", {passes} passes; tokens == sequential: {same_seq}, == spec "
          f"plain: {same_plain}", flush=True)

    padded = pipe.padded_chunks(sig, SR)[0].samples
    enc_s = encode_seconds(pipe, model, padded)
    step_bytes = step_weight_bytes(model)
    report("q4g", wall, enc_s, n_tok, peak, card)
    report(f"q4g speculative K={SPEC_K} draft=ngram", s_wall, enc_s, n_tok,
           s_peak, card, passes, n_steps, k1h["spec8"][1])
    print(f"q4g decode step weight stream: {step_bytes / 1e9:.4f} GB/step / "
          f"{k1h['one'][1]:.3f} ms = {step_bytes / k1h['one'][1] / 1e6:.1f} "
          f"GB/s; bound {step_bytes / HBM_BPS * 1e3:.4f} ms [{card}]",
          flush=True)
    return dict(k1=k1h, launches=launches, spec_launches=s_launch,
                passes=passes, model=model, plain=plain, tokens=tokens,
                margins=margins)


@contextlib.contextmanager
def g32_stream_from(rows: int):
    """Inside the block, ops.decode_step's g32 stream is taken from
    ``rows`` rows (``STREAM_MIN_ROWS["g32"]``, the plan cache cleared on
    the way in and out).  Shared with benches/torch_k1_times.py and
    benches/torch_tp_times.py."""
    from voxtral_tpu_torch.ops import decode_step as k1

    rule = k1.STREAM_MIN_ROWS["g32"]
    k1.STREAM_MIN_ROWS["g32"] = rows
    k1.stream_plan.cache_clear()
    try:
        yield
    finally:
        k1.STREAM_MIN_ROWS["g32"] = rule
        k1.stream_plan.cache_clear()


def g32_routes_ms(call, ref, names=("gemv", "stream"), **graph_kw) -> dict:
    """Device ms of ``call`` on each g32 route, the earlier kernels
    (``names[0]``: the stream never) and the stream from one row
    (``names[1]``), each held bit-equal to ``ref`` first: {route: ms, or
    "not bit-equal"}.  The sweep behind ``STREAM_MIN_ROWS["g32"]``."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    out = {}
    for name, rows in zip(names, (k1.STREAM_MAX_M + 1, 1)):
        with g32_stream_from(rows):
            got = call()
            torch.cuda.synchronize()
            out[name] = (graph_ms(call, **graph_kw)
                         if all(torch.equal(g, r) for g, r in zip(got, ref))
                         else "not bit-equal")
    return out


# K1's g32 weight stream alone (check_g32_stream): the row counts of its
# linears, and of its fold over the lm table (12: two 8-row tiles, one
# table pass).
G32_STREAM_ROWS = (2, SPEC_K, 64)
G32_FOLD_ROWS = 12


def check_g32_stream(model, dev, card) -> dict:
    """K1's g32 weight stream alone (``k1_linear``, as the step launches
    it) on the q4g model's layer-0 linears (qkv, wo, w13, w2) and its lm
    table at G32_STREAM_ROWS rows, each bit for bit against
    ``k1_linear_plain`` (the stream's plan checked to take the shape);
    the lm table timed beside its plain version and its bound; then the
    fold over the lm table at G32_FOLD_ROWS rows (one pass: 12 <= 64),
    the token == the plain argmax.  Below ``STREAM_MIN_ROWS["g32"]`` rows
    (the main path's dp4a GEMV there) the stream is forced for the check.
    -> {rows: times, "fold": times, "err": 0.0}."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    fused = model.fused_decode
    _, lm_codes, lm_scale = lm_fold(model)
    linears = {name: (fused[name][0], fused[s][0]) for name, s in
               (("wqkv", "sqkv"), ("wo", "so"), ("w13", "s13"),
                ("w2", "s2"))}
    linears["lm table"] = (lm_codes, lm_scale)
    sms = k1._sm_count(dev.index or 0)
    out = {"err": 0.0}
    with g32_stream_from(min(k1.STREAM_MIN_ROWS["g32"],
                             min(G32_STREAM_ROWS))):
        _g32_stream_cases(k1, linears, lm_codes, lm_scale, sms, dev, card,
                          out)
    print(f"K1 g32 stream bounds (bytes, int8 and f64 operations) [{card}]: "
          + ", ".join(f"{r} rows {out[r][2]:.4f} ms ({out[r][3]})"
                      for r in G32_STREAM_ROWS)
          + f", fold {out['fold'][2]:.4f} ms", flush=True)
    return out


def _g32_stream_cases(k1, linears, lm_codes, lm_scale, sms, dev, card,
                      out) -> None:
    """check_g32_stream's cases, into ``out``."""
    import torch

    def operands(rows, k, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randint(-127, 128, (rows, k), dtype=torch.int8,
                          device=dev, generator=gen)
        sx = torch.rand(rows, device=dev, generator=gen) * 1e-2 + 1e-4
        return x, sx

    def bound_of(rows, w, sc, n_out):
        # (bytes, int8 operations, the bound over bytes, the int8 and the
        # f64 operations: an int32 -> f64 add and an fma a group).
        moved = nbytes(w, sc) + rows * (w.shape[1] + 4) + n_out
        groups = rows * w.shape[0] * (w.shape[1] // 32)
        ops = 2 * rows * w.numel()
        return moved, ops, max(bound(moved, ops, INT8_OPS),
                               bound(moved, 3 * groups, F64_FLOPS))

    for rows in G32_STREAM_ROWS:
        for name, (w, sc) in linears.items():
            if k1.stream_plan("g32", rows, *w.shape, sms) is None:
                fail(f"K1 g32 stream: no plan for {name} {tuple(w.shape)} "
                     f"at {rows} rows")
            x, sx = operands(rows, w.shape[1], rows)
            got = k1.k1_linear(x, w, sc, sx)
            torch.cuda.synchronize()
            if not torch.equal(got, k1.k1_linear_plain(x, w, sc, sx)):
                fail(f"K1 g32 stream {name} at {rows} rows: not bit-equal "
                     "to g32_matmul_plain")
        x, sx = operands(rows, lm_codes.shape[1], rows)
        moved, ops, (b_ms, b_by) = bound_of(rows, lm_codes, lm_scale,
                                            rows * lm_codes.shape[0] * 4)
        _, t = timed_kernel(
            f"K1 g32 weight stream (k1_stream.cuh) rows={rows} lm table "
            f"{tuple(lm_codes.shape)} (layer 0's linears bit-equal too)",
            lambda: (k1.k1_linear(x, lm_codes, lm_scale, sx),),
            lambda: (k1.k1_linear_plain(x, lm_codes, lm_scale, sx),),
            moved, ops, card)
        out[rows] = (t[0], t[1], b_ms, b_by, t[4])
    rows = G32_FOLD_ROWS
    x, sx = operands(rows, lm_codes.shape[1], rows)
    moved, ops, (b_ms, b_by) = bound_of(rows, lm_codes, lm_scale, rows * 4)
    _, t = timed_kernel(
        f"K1 g32 stream fold rows={rows} over the lm table (one pass)",
        lambda: (k1.k1_linear(x, lm_codes, lm_scale, sx, lm_argmax=True),),
        lambda: (k1.lm_token_plain(k1.k1_linear_plain(x, lm_codes, lm_scale,
                                                      sx)),),
        moved, ops, card)
    out["fold"] = (t[0], t[1], b_ms, b_by, t[4])


def run_q4(tree, cfg, dev, card, sig, tok):
    """Phase 6: packed q4 weights — the per-op step on K3, on the
    chirp's first Q4_SECS (the per-op step is host-bound: a longer clip
    holds nothing more)."""
    import torch

    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.pipeline import TranscribePipeline

    params = packed_tree(params_from_numpy(tree, dev))
    torch.cuda.empty_cache()
    model = VoxtralModel(params, cfg, dev)
    if model.decode_route != "per_op":
        fail(f"packed q4 weights route to {model.decode_route}, not per_op")
    plain = VoxtralModel(params, cfg, dev, kernels=False)
    lm = cfg.language_model
    pipe = TranscribePipeline(model, tok)
    sig = sig[:int(Q4_SECS * SR)]
    wall, launches, peak, chunks = counted_run(pipe, sig, dev)
    tokens = chunks[0]
    padded = pipe.padded_chunks(sig, SR)[0].samples
    n_tok = model.decoder_seq_len(pipe.mel.num_frames(len(padded))) - 38
    n_steps = n_tok - 1
    per_step = 7 * lm.n_layers + 1  # decoder linears + the lm_head
    expect = per_step * n_steps + 1  # + the first-token lm_head
    if len(tokens) != n_tok:
        fail(f"q4: {len(tokens)} tokens != {n_tok}")
    if launches["q4_matmul"] != expect:
        fail(f"q4: K3 launches {launches['q4_matmul']} != {per_step} x "
             f"{n_steps} steps + 1 = {expect}")
    p_tokens, margins = plain_tokens(plain, tok, sig)
    same = first_divergence("q4 sequential kernel vs plain", tokens,
                            p_tokens, margins, MARGIN_TIE)
    print(f"q4 main path: launch counts {launches} (K3: {per_step} per step "
          f"x {n_steps} + 1 = {expect}); tokens kernel == plain: {same} "
          f"({len(set(tokens.tolist()))} distinct; min plain top-2 margin "
          f"{float(margins.min()):.3e})", flush=True)
    enc_s = encode_seconds(pipe, model, padded)
    report("q4", wall, enc_s, n_tok, peak, card, secs=Q4_SECS)
    dec = params["decoder"]
    leaves = [dec["layers"][g][w]["q4"] for g, ws in (
        ("attention", ("wq", "wk", "wv", "wo")),
        ("ffn", ("w1", "w2", "w3"))) for w in ws]
    leaves.append(dec["tok_embeddings"]["q4"])
    step_bytes = nbytes(*(t for q in leaves for t in q.values()))
    step_ms = (wall - enc_s) * 1e3 / n_tok
    print(f"q4 decode step weight stream: {step_bytes / 1e9:.4f} GB/step "
          f"(packed codes + bf16 scales, lm_head included) / {step_ms:.3f} "
          f"ms per token end to end = {step_bytes / step_ms / 1e6:.1f} GB/s;"
          f" bound {step_bytes / HBM_BPS * 1e3:.4f} ms [{card}]", flush=True)
    return dict(launches=launches, model=model, plain=plain)


# ---------------------------------------------------------------------------
# Streaming sessions
# ---------------------------------------------------------------------------

STREAM_SECS = 40.0     # w8: past the encoder ring's wrap (~32 s)
# How far the plain-path w8 sessions run from the start (their first
# steps), and the unbounded one's second stretch, restored from the
# kernel session's checkpoint at WRAP_FROM_SECS, through the encoder
# ring's wrap to PLAIN_WRAP_SECS.
PLAIN_BOUNDED_SECS = PLAIN_UNBOUNDED_SECS = 6.0
WRAP_FROM_SECS, PLAIN_WRAP_SECS = 28.0, 38.0
Q4G_STREAM_SECS = 20.0
Q4G_PLAIN_STREAM_SECS = 10.0  # the q4g session's plain twin, as a prefix
Q4_STREAM_SECS = 8.0
Q4_PLAIN_STREAM_SECS = 5.0  # the q4 session's plain twin, as a prefix
P_STEP = 8             # decoder positions per steady step (1.28 s)
# K1 mode (d) at full width: (offset, spec) — before any wrap, the last
# slot before it, wrapped, wrapped with the head outside the window, and
# spec rows straddling the ring's end / far past it.
RING_CASES = [(100, 1), (8237, 1), (8241, 1), (16000, 1), (8234, SPEC_K),
              (16000, SPEC_K)]


def stream_signal(secs: float) -> np.ndarray:
    """A slow speech-band chirp (200 Hz + 60 Hz/s), peak 0.95."""
    t = np.arange(int(secs * SR)) / SR
    sig = np.sin(2 * np.pi * (200 + 60 * t) * t)
    return (0.95 * sig / np.abs(sig).max()).astype(np.float32)


def ragged_pieces(sig: np.ndarray, seed: int = 4) -> list:
    """0.16 s pieces, every seventh of an odd size (1 .. 6000 samples)."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1, 6000)) if i % 7 == 3 else 2560
             for i in range(len(sig) // 1000 + 8)]
    cuts = np.cumsum(sizes)
    return np.split(sig, cuts[cuts < len(sig)])


def ring_geometry(lm):
    """The unbounded session's decoder ring (38, window + P) and S."""
    from voxtral_tpu_torch.models.voxtral import PREFIX_LEN

    ring = (PREFIX_LEN, lm.sliding_window + P_STEP)
    return ring, sum(ring)


def enc_ring_geometry(enc):
    """The unbounded session's encoder ring: a head of 4 x 38 frames and
    the window rounded up to the 4P-frame write granule."""
    gran = 4 * P_STEP
    return 4 * 38, -(-(enc.sliding_window + gran) // gran) * gran


def check_enc_ring_layer(model, dev, card):
    """The session's encoder head+ring layout at full width, one layer
    deep: ``attention_with_cache`` over 4P new frames at offsets before,
    just past and well past the ring's wrap, in the bounded layout
    (position p at slot p of a 120 s cache) and the head+ring one, both
    caches holding the same random K/V at every position the layout
    keeps.  Dense random bf16 weights, so the linears are the same f32
    matmuls on both sides.  The ring write must land at ring_slot
    (exact) and the outputs agree within LAYOUT_LAYER_RTOL of the
    largest.  -> worst error, as a share of the largest output."""
    import torch

    from voxtral_tpu_torch.models.encoder import encoder_spec
    from voxtral_tpu_torch.models.layers import (
        attention_with_cache,
        ring_slot,
        rope_tables,
    )

    enc = model.config.audio_encoder
    spec = encoder_spec(enc)
    D, hd = enc.dim, enc.head_dim
    head, size = ring = enc_ring_geometry(enc)
    n_new = 4 * P_STEP
    s_bounded = 4 * (int(120 * 6.25) + 38 + 2 * P_STEP)
    gen = torch.Generator(device=dev).manual_seed(13)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale
                ).bfloat16()

    nq, nkv = enc.n_heads * hd, enc.n_kv_heads * hd
    p = {"wq": rand(D, nq, scale=D ** -0.5), "wk": rand(D, nkv, scale=D ** -0.5),
         "wv": rand(D, nkv, scale=D ** -0.5), "wo": rand(nq, D, scale=nq ** -0.5)}
    cos, sin = rope_tables(hd, 4096, enc.rope_theta, device=dev)
    worst = 0.0
    for off in (head + 14 * n_new, head + 26 * n_new, head + 42 * n_new):
        kv_shape = (1, off, enc.n_kv_heads, hd)
        k_all, v_all = rand(*kv_shape), rand(*kv_shape)
        kb = torch.zeros((1, s_bounded) + kv_shape[2:], dtype=torch.bfloat16,
                         device=dev)
        vb = torch.zeros_like(kb)
        kb[:, :off], vb[:, :off] = k_all, v_all
        kr = torch.zeros((1, head + size) + kv_shape[2:],
                         dtype=torch.bfloat16, device=dev)
        vr = torch.zeros_like(kr)
        pos = torch.arange(off, device=dev)
        kept = pos[(pos < head) | (pos >= max(head, off - size))]
        kr[:, ring_slot(kept, head, size)] = k_all[:, kept]
        vr[:, ring_slot(kept, head, size)] = v_all[:, kept]
        x = rand(1, n_new, D)
        out_b, kb, vb = attention_with_cache(x, p, spec, cos, sin, kb, vb, off)
        out_r, kr, vr = attention_with_cache(x, p, spec, cos, sin, kr, vr, off,
                                             ring=ring)
        slots = ring_slot(torch.arange(off, off + n_new, device=dev), head,
                          size)
        writes = (torch.equal(kr[:, slots], kb[:, off:off + n_new])
                  and torch.equal(vr[:, slots], vb[:, off:off + n_new]))
        err = ((out_r.float() - out_b.float()).abs().max()
               / out_b.float().abs().max()).item()
        worst = max(worst, err)
        print(f"encoder ring layout, one layer at full width, offset {off} "
              f"(ring {ring}, bounded {s_bounded} slots): ring writes "
              f"exact {writes}; output error {err:.3e} of max (bit-equal "
              f"{torch.equal(out_r, out_b)}; bound {LAYOUT_LAYER_RTOL}) "
              f"[{card}]", flush=True)
        if not writes:
            fail(f"encoder ring layout at offset {off}: the new K/V did not "
                 "land at their ring slots")
        if not err <= LAYOUT_LAYER_RTOL:
            fail(f"encoder ring layout at offset {off}: output error "
                 f"{err:.3e} of max > {LAYOUT_LAYER_RTOL}")
    return worst


def check_k1_ring(model, dev, card):
    """K1 mode (d) against its plain version at full width: a head+ring
    cache of S = 8238 slots, ring (38, 8200), window 8192, at every
    RING_CASES entry (bit-equal within K1_RTOL / KV_RTOL); timed at
    offset 16000 (window full) and 100, and spec=8 at 16000.
    -> (max abs err, {(off, spec): (ms, plain ms, bound ms, bound by)})."""
    import torch

    from voxtral_tpu_torch.models.layers import ring_k_positions
    from voxtral_tpu_torch.ops import decode_step as k1

    cfg = model.config.language_model
    fused = model.fused_decode
    L, D, hd, n_kv = cfg.n_layers, cfg.dim, cfg.head_dim, cfg.n_kv_heads
    ring, S = ring_geometry(cfg)
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (L, 1, n_kv, S, hd)
    kc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    ada = k1.ada_vectors(model.params["decoder"], model.t_embed(6.0))
    wbytes = step_weight_bytes(model)
    n_vocab = lm_fold(model)[1].shape[0]
    n_weights = n_stack_weights(model)
    timed = {(16000, 1), (100, 1), (16000, SPEC_K)}
    worst, times = 0.0, {}
    for off, spec in RING_CASES:
        x = torch.randn((spec, D), device=dev, generator=gen)
        c, s = k1.rope_pair_vectors(
            off + torch.arange(spec, device=dev), hd, cfg.rope_theta)
        offset = off
        if spec == 1:
            c, s = c[0].contiguous(), s[0].contiguous()
        else:
            offset = torch.tensor([off], dtype=torch.int32, device=dev)
        args = (x, offset, fused["attn_norm"], fused["ffn_norm"], ada,
                fused["sqkv"], fused["so"], fused["s13"], fused["s2"], c, s,
                kc, vc, fused["wqkv"], fused["wo"], fused["w13"],
                fused["w2"], *lm_fold(model))
        kw = dict(n_heads=cfg.n_heads, n_kv=n_kv, head_dim=hd,
                  eps=cfg.norm_eps, window=cfg.sliding_window, spec=spec,
                  ring=ring)
        tag = (f"K1 mode (d) [{model.decode_route}] ring={ring} S={S} "
               f"offset={off} spec={spec}")
        got = k1.decode_stack_step(*args, **kw)
        torch.cuda.synchronize()
        ref = k1.decode_stack_step_plain(*args, **kw)
        worst = max(worst, compare(tag, got, ref,
                                   (K1_RTOL, KV_RTOL, KV_RTOL, K1_RTOL)))
        if (off, spec) not in timed:
            continue
        ms, plain_ms = in_turns(lambda: k1.decode_stack_step(*args, **kw),
                                lambda: k1.decode_stack_step_plain(*args,
                                                                   **kw),
                                20, 2)
        # The cache slots this step must read: written and within the
        # window of row 0 (the later spec rows see a subset of them).
        p_abs, written = ring_k_positions(*ring, off, device=dev)
        seen = int((written & (off - p_abs <= cfg.sliding_window)).sum())
        kv_read = 2 * L * n_kv * seen * hd * 2
        moved = (wbytes + kv_read + 2 * nbytes(x) + 2 * nbytes(got[1])
                 + spec * n_vocab * 4)
        b_ms, b_by = bound(moved, 2 * spec * (n_weights + n_vocab * D),
                           weight_ops_peak(model))
        times[(off, spec)] = (ms, plain_ms, b_ms, b_by)
        print(f"{tag}: kernel {ms:.3f} ms called from the host, plain "
              f"{plain_ms:.3f} ms; "
              f"{seen} cache slots read ({kv_read / 1e9:.4f} GB) + weights "
              f"{wbytes / 1e9:.4f} GB; bound {b_ms:.4f} ms ({b_by}; "
              f"{100 * b_ms / ms:.1f} % of it) [{card}]",
              flush=True)
    del kc, vc
    return worst, times


class Share:
    """A share of a wrapper's launches (its ``attr`` counter: K1's mode
    (i) launches, a half's g32 launches), set to 0 and read like the
    wrapper's own ``launches``."""

    def __init__(self, fn, attr: str):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.fn, self.attr, n)


def stream_counters():
    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.ops import q4_kernel as k3
    from voxtral_tpu_torch.ops import w8_kernel as k2

    from voxtral_tpu_torch.ops import decode_tp as ktp

    step = k1.decode_stack_step
    return {"w8_matmul": k2.w8_matmul, "decode_stack_step": step,
            "decode_layer_step": k1.decode_layer_step,
            "q4_matmul": k3.q4_matmul_packed,
            "attn_half_step": ktp.attn_half_step,
            "ffn_half_step": ktp.ffn_half_step,
            "lm_half_argmax": ktp.lm_half_argmax,
            "decode_stack_step_lm_argmax": Share(step, "argmax_launches"),
            # The g32 (q4g) modes of K4, K5, K6 and K1 (i): their own
            # entries of the record.
            "attn_half_step_g32": Share(ktp.attn_half_step, "g32_launches"),
            "ffn_half_step_g32": Share(ktp.ffn_half_step, "g32_launches"),
            "lm_half_argmax_g32": Share(ktp.lm_half_argmax, "g32_launches"),
            "decode_stack_step_lm_argmax_g32": Share(
                step, "argmax_g32_launches"),
            # K1's g32 steps on the weight stream and K6's g32 folds on
            # it (from 5 rows): their own entries of the record.
            "decode_stack_step_g32_stream": Share(step,
                                                  "g32_stream_launches"),
            "lm_half_argmax_g32_stream": Share(ktp.lm_half_argmax,
                                               "stream_launches"),
            # K1 (i) over a bf16 table (phase 11d).
            "decode_stack_step_lm_argmax_bf16": Share(
                step, "argmax_bf16_launches")}


def stream_run(model, pieces, dev, keep=False, finish=True,
               snapshot_secs=None, **kw) -> dict:
    """One StreamingSession over ``pieces`` then finish() (unless
    ``finish`` is False: the tokens are then a prefix of the whole
    stream's), each feed timed to a synchronize, with every launch
    counter set to 0 just before and read just after.  A feed that ran the first step gives
    the time to first text; a feed that advanced by exactly P positions
    one steady step's time.  ``keep`` (a sequential session) also keeps
    each position's logits [n, V] and audio embed [n, D] on the device,
    as ``kept``.  ``snapshot_secs``: the session's state_dict after the
    first piece that ends past that much audio, and the count of pieces
    fed, as ``snapshot``."""
    import torch

    from voxtral_tpu_torch.streaming import StreamingSession

    counters = stream_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    t_start = time.perf_counter()
    ses = StreamingSession(model, step_positions=P_STEP, **kw)
    first_ms, step_ms, encode_ms = None, [], []
    steady_inputs = ses._steady_inputs

    def timed_inputs(mel_win):
        # The encode half of a steady step (conv, encoder, adapter; the
        # host mel ran just before), timed between two synchronizes.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = steady_inputs(mel_win)
        torch.cuda.synchronize()
        encode_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    ses._steady_inputs = timed_inputs
    logits_kept, embeds_kept = [], []
    if keep:
        record, encode = ses._record, ses._encode

        def kept_record(out, tokens, logits):
            logits_kept.append(logits.float().reshape(-1, logits.shape[-1])
                               .clone())
            record(out, tokens, logits)

        def kept_encode(x):
            audio = encode(x)
            embeds_kept.append(audio[0].float().clone())
            return audio

        ses._record, ses._encode = kept_record, kept_encode
    snapshot, fed = None, 0
    for i, piece in enumerate(pieces):
        done = ses.positions_done
        t0 = time.perf_counter()
        ses.feed(piece)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if done == 0 and ses.positions_done:
            first_ms = dt
        elif ses.positions_done - done == P_STEP:
            step_ms.append(dt)
        fed += len(piece)
        if snapshot is None and snapshot_secs and fed >= snapshot_secs * SR:
            snapshot = (ses.state_dict(), i + 1)
    if finish:
        ses.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    # The wrapper refers back to the session: drop it, so the session and
    # its caches go when the last reference does, not at a later GC pass.
    del ses._steady_inputs
    if keep:
        del ses._record, ses._encode
    launches = {name: fn.launches for name, fn in counters.items()}
    # Numbers only: a run keeps no session, so its caches go with it.
    out = dict(positions=ses.positions_done, spec=ses.spec_metrics(),
               max_enc=ses._max_enc, tokens=np.asarray(ses.tokens), wall=wall,
               first_ms=first_ms, step_ms=step_ms, encode_ms=encode_ms,
               launches=launches,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               cache_gb=ses.cache_bytes / 1e9,
               margins=np.asarray(ses.margins) if ses.margins else None)
    if keep:
        out["kept"] = (torch.cat(logits_kept), torch.cat(embeds_kept))
    if snapshot_secs:
        out["snapshot"] = snapshot
    if out["margins"] is not None and not np.isfinite(out["margins"]).all():
        fail("non-finite logits in a streaming session")
    if len(ses.tokens) != ses.positions_done - 38:
        fail(f"session tokens {len(ses.tokens)} != positions "
             f"{ses.positions_done} - 38")
    return out


def plain_stream(plain, pieces, dev, secs=None, **kw) -> dict:
    """stream_run on the plain-path model, with top-2 margins; with
    ``secs``, over the pieces that end within that much audio and
    without finish(): a causal stream's tokens up to there are the whole
    stream's, and the plain versions are many times slower."""
    if secs is not None:
        ends = np.cumsum([len(p) for p in pieces])
        pieces = pieces[:int(np.searchsorted(ends, secs * SR, "right"))]
        kw["finish"] = False
    plain.record_margins = True
    try:
        return stream_run(plain, pieces, dev, **kw)
    finally:
        plain.record_margins = False


def plain_stream_from(plain, snapshot, pieces, dev, secs) -> dict:
    """The plain path from a kernel session's checkpoint (``snapshot``,
    stream_run's: the state and the pieces it had taken) over the pieces
    that end within ``secs`` of audio, with top-2 margins -> tokens (the
    checkpoint's, then the plain path's own from index ``first``), their
    margins, positions and the encoder ring's size."""
    import torch

    from voxtral_tpu_torch.streaming import StreamingSession

    state, start = snapshot
    ends = np.cumsum([len(p) for p in pieces])
    stop = int(np.searchsorted(ends, secs * SR, "right"))
    plain.record_margins = True
    try:
        ses = StreamingSession.restore(plain, state)
        t0 = time.perf_counter()
        for piece in pieces[start:stop]:
            ses.feed(piece)
        torch.cuda.synchronize()
    finally:
        plain.record_margins = False
    out = dict(tokens=np.asarray(ses.tokens), margins=np.asarray(ses.margins),
               first=len(state["tokens"]), positions=ses.positions_done,
               max_enc=ses._max_enc, wall=time.perf_counter() - t0)
    if len(out["margins"]) != len(out["tokens"]) - out["first"]:
        fail(f"restored plain session: {len(out['margins'])} margins for "
             f"{len(out['tokens']) - out['first']} new tokens")
    return out


def check_stream_launches(tag, run, route):
    """K1 launches == positions decoded after the first step (one per
    position sequentially, one per pass speculatively)."""
    if route == "per_op":
        return
    steady = run["positions"] - 38 - P_STEP
    k1n = run["launches"]["decode_stack_step"]
    metrics = run["spec"]
    expect = metrics["passes"] if metrics else steady
    if k1n != expect or k1n < 1:
        fail(f"{tag}: K1 launches {k1n} != {'passes' if metrics else 'positions'}"
             f" {expect}")


def stream_step_bound(model, window_full: bool) -> tuple:
    """(GB, ms) one steady step must move at least: the encoder and
    adapter weights once, the decoder's K1 weights P times, and with the
    window full P reads of its 8192 cached positions."""
    def tree_bytes(t):
        return (sum(tree_bytes(v) for v in t.values()) if isinstance(t, dict)
                else nbytes(t))

    cfg = model.config.language_model
    gb = (tree_bytes(model.params["encoder"])
          + tree_bytes(model.params["adapter"])
          + P_STEP * step_weight_bytes(model))
    if window_full:
        gb += P_STEP * 2 * cfg.n_layers * cfg.n_kv_heads * \
            cfg.sliding_window * cfg.head_dim * 2
    return gb / 1e9, gb / HBM_BPS * 1e3


def report_stream(tag, run, card, model=None):
    steps = np.asarray(run["step_ms"])
    line = (f"{tag}: {run['positions']} positions, "
            f"{len(steps)} steady steps of {P_STEP} positions: median "
            f"{np.median(steps):.2f} ms, max {steps.max():.2f} ms, step RTF "
            f"{np.median(steps) / (P_STEP * 160):.5f} (median / 1280 ms); "
            f"of which conv + encoder + adapter median "
            f"{np.median(run['encode_ms']):.2f} ms; "
            f"time to first text {run['first_ms']:.1f} ms; cache "
            f"{run['cache_gb']:.4f} GB allocated, peak GPU memory "
            f"{run['peak_gb']:.3f} GB; launches {run['launches']}")
    if model is not None:
        gb, b_ms = stream_step_bound(model, False)
        gb_full, b_full = stream_step_bound(model, True)
        line += (f"; step bound {b_ms:.3f} ms ({gb:.2f} GB), {b_full:.3f} "
                 f"ms with the window full ({gb_full:.2f} GB)")
    print(f"{line} [{card}]", flush=True)


def restored_samples(p0: int, n_steps: int) -> tuple:
    """(first sample, count) of the audio a stream restored at ``p0``
    positions needs for ``n_steps`` more steady steps."""
    from voxtral_tpu_torch.streaming import MEL_HOP, _mel_frames_needed

    base = MEL_HOP * (16 * p0 - 8)
    return base, _mel_frames_needed(16 * (p0 + n_steps * P_STEP) + 8) - base


def restored_state(cfg, dev, p0: int, n_steps: int, gen, signal) -> dict:
    """A checkpoint of an unbounded stream at ``p0`` positions without the
    audio that leads there: random bf16 caches (on the card), a random
    last audio embed, and the samples ``n_steps`` more steps need
    (``signal(secs)`` makes them).  What ``StreamingSession.restore``
    takes, solo or into a pool's slot."""
    import torch

    lm, enc = cfg.language_model, cfg.audio_encoder
    _, S = ring_geometry(lm)

    def rand(*shape):
        return (torch.randn(shape, device=dev, generator=gen) * 0.5
                ).bfloat16()

    enc_s = sum(enc_ring_geometry(enc))
    base, n = restored_samples(p0, n_steps)
    return {
        "version": 1, "P": P_STEP, "unbounded": True, "max_dec": S,
        "delay_tokens": 6.0, "samples": signal(n / SR + 0.01)[:n],
        "samples_base": base, "positions_done": p0,
        "tokens": np.full(p0 - 38, 32, np.int32), "text": "",
        "finished": False, "prev_token": 1007,
        "prev_audio": rand(1, 1, lm.dim).float(),
        "enc_k": rand(enc.n_layers, 1, enc_s, enc.n_kv_heads, enc.head_dim),
        "enc_v": rand(enc.n_layers, 1, enc_s, enc.n_kv_heads, enc.head_dim),
        "enc_len": 4 * p0,
        "dec_k": rand(lm.n_layers, 1, S, lm.n_kv_heads, lm.head_dim),
        "dec_v": rand(lm.n_layers, 1, S, lm.n_kv_heads, lm.head_dim),
        "dec_len": p0, "endpoint_mark": 0,
    }


def run_stream_wrap(model, plain, dev, card):
    """A decoder-ring wrap at full width, without 22 minutes of audio: a
    session restored from a state 2P positions short of 38 + 8200, its
    caches random bf16, runs 4 steady steps through the wrap, with the
    kernels and through the plain versions -> (same, k1 launches)."""
    import torch

    from voxtral_tpu_torch.streaming import StreamingSession

    ring, S = ring_geometry(model.config.language_model)
    p0 = S - 2 * P_STEP
    n_steps = 4
    gen = torch.Generator(device=dev).manual_seed(11)
    state = restored_state(model.config, dev, p0, n_steps, gen,
                           stream_signal)
    out = {}
    for name, m in (("kernel", model), ("plain", plain)):
        m.record_margins = name == "plain"
        counters = stream_counters()
        for fn in counters.values():
            fn.launches = 0
        ses = StreamingSession.restore(m, state)
        ses.feed(np.zeros(0, np.float32))
        torch.cuda.synchronize()
        m.record_margins = False
        if ses.positions_done != p0 + n_steps * P_STEP:
            fail(f"ring wrap: {ses.positions_done} positions done, expected "
                 f"{p0 + n_steps * P_STEP}")
        out[name] = (np.asarray(ses.tokens[p0 - 38:]), ses.margins,
                     {n: fn.launches for n, fn in counters.items()})
    del state
    toks, _, launches = out["kernel"]
    ptoks, margins, _ = out["plain"]
    k1n = launches["decode_stack_step"]
    if k1n != n_steps * P_STEP:
        fail(f"ring wrap: K1 launches {k1n} != {n_steps * P_STEP}")
    same = first_divergence("ring wrap kernel vs plain", toks, ptoks,
                            np.asarray(margins), MARGIN_TIE)
    print(f"decoder ring wrap at full width: positions {p0} -> "
          f"{p0 + n_steps * P_STEP} through slot {S} (ring {ring}), "
          f"{n_steps} steps, K1 launches {k1n}; tokens kernel == plain: "
          f"{same} ({len(set(toks.tolist()))} distinct, min plain top-2 "
          f"margin {min(margins):.3e}) [{card}]", flush=True)
    return same, launches


def layout_witness(model, pieces, dev, card, bounded, unbounded):
    """Sessions of two cache layouts, position by position, on the kernel
    model: the ``bounded`` 120 s session (a ``stream_run(keep=True)``)
    against a bounded 60 s one run here (the cache length alone: the
    noise) and against the ``unbounded`` one (head+ring).
    For each pair, the relative L2 difference of the audio embeds (which
    no token feeds) over the whole stream, and the largest logit
    difference up to and with the first token where the pair parts
    (after it their inputs differ).  Fail unless the head+ring pair
    stays within LAYOUT_NOISE_FACTOR of the noise in both.  -> (the tie
    threshold for token flips between layouts, the noise pair's (embeds,
    logits) differences)."""
    import torch

    runs = {"bounded": bounded, "unbounded": unbounded,
            "bounded 60 s": stream_run(model, pieces, dev, keep=True,
                                       max_duration_s=60)}
    ref_log, ref_emb = runs["bounded"].pop("kept")
    ref_tok = runs["bounded"]["tokens"]
    wrap = runs["unbounded"]["max_enc"] // 4  # first position past the wrap
    diff = {}
    for name in ("bounded 60 s", "unbounded"):
        log, emb = runs[name].pop("kept")
        tok = runs[name]["tokens"]
        parted = np.nonzero(tok != ref_tok)[0]
        n = int(parted[0]) + 1 if len(parted) else len(tok)
        d_log = (log[:n] - ref_log[:n]).abs().amax(-1).cpu().numpy()
        rel = ((emb - ref_emb).norm(dim=-1)
               / ref_emb.norm(dim=-1)).cpu().numpy()
        margin = None
        if len(parted):
            top2 = ref_log[n - 1].topk(2).values
            margin = float(top2[0] - top2[1])
        diff[name] = (float(rel.max()), float(d_log.max()))
        print(f"layouts, bounded 120 s vs {name} session: audio embeds "
              f"bit-identical at {int((rel == 0).sum())} of {len(rel)} "
              f"positions, relative L2 difference median "
              f"{float(np.median(rel)):.3e}, max {float(rel[:wrap].max()):.3e} "
              f"before position {wrap} and "
              f"{float(rel[wrap:].max(initial=0)):.3e} from it; logits over "
              f"{n} tokens: largest difference {float(d_log.max()):.3e} "
              f"(median {float(np.median(d_log)):.3e}, at token 0 "
              f"{float(d_log[0]):.3e}; logits span "
              f"+-{float(ref_log[:n].abs().max()):.3f}); tokens "
              + (f"part at token {n - 1} (bounded top-2 margin {margin:.3e})"
                 if margin is not None else "identical")
              + f" [{card}]", flush=True)
        del log, emb
    del ref_log, ref_emb, runs
    torch.cuda.empty_cache()
    (n_emb, n_log), (r_emb, r_log) = diff["bounded 60 s"], diff["unbounded"]

    def ratio(r, n):
        return r / n if n else (0.0 if r == 0 else float("inf"))

    print(f"layouts: head+ring / cache-length noise = {ratio(r_emb, n_emb):.3f}"
          f" (embeds), {ratio(r_log, n_log):.3f} (logits); bound "
          f"{LAYOUT_NOISE_FACTOR} [{card}]", flush=True)
    if not (r_emb <= LAYOUT_NOISE_FACTOR * n_emb
            and r_log <= LAYOUT_NOISE_FACTOR * n_log):
        fail("the head+ring session moved embeds or logits by more than "
             f"{LAYOUT_NOISE_FACTOR} x what a cache-length change alone does")
    return 2 * n_log, (n_emb, n_log)


def run_stream_w8(model, plain, dev, card, tok):
    """Phase 8a: K1 mode (d) checks and the w8 sessions (40 s)."""
    import torch

    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline

    k1_err, k1_times = check_k1_ring(model, dev, card)
    check_enc_ring_layer(model, dev, card)
    torch.cuda.empty_cache()
    sig = stream_signal(STREAM_SECS)
    pieces = ragged_pieces(sig)
    runs = {}
    # The plain sessions stop early (their first steps); the unbounded
    # one has a second stretch, restored from the kernel session's
    # checkpoint before the encoder ring's wrap and run past it.  The
    # kernel sessions keep their margins too (they judge the comparisons
    # between layouts and with the speculative sessions).
    for name, kw, plain_secs in (
            ("bounded", dict(max_duration_s=120), PLAIN_BOUNDED_SECS),
            ("unbounded", dict(unbounded=True), PLAIN_UNBOUNDED_SECS)):
        model.record_margins = True
        try:
            run = stream_run(model, pieces, dev, keep=True,
                             snapshot_secs=(WRAP_FROM_SECS if kw.get(
                                 "unbounded") else None), **kw)
        finally:
            model.record_margins = False
        check_stream_launches(f"w8 {name}", run, "w8")
        if run["launches"]["w8_matmul"] < 1:
            fail(f"w8 {name} session: no K2 launch")
        ref = plain_stream(plain, pieces, dev, secs=plain_secs, **kw)
        n = len(ref["tokens"])
        if not P_STEP < n <= len(run["tokens"]):
            fail(f"w8 {name} session: the plain path gave {n} tokens")
        same = first_divergence(f"w8 {name} session kernel vs plain",
                                run["tokens"][:n], ref["tokens"],
                                ref["margins"], MARGIN_TIE)
        gap = float(np.abs(run["margins"][:n] - ref["margins"]).max())
        if same and not gap <= MARGIN_TIE:
            fail(f"w8 {name} session: top-2 margins of the kernel and plain "
                 f"paths differ by {gap:.3e}")
        runs[name] = dict(run=run, plain=ref, same=same)
        report_stream(f"w8 {name} session", run, card, model)
        print(f"w8 {name} session: tokens kernel == plain over the first "
              f"{n} of {len(run['tokens'])}: {same} "
              f"({len(set(run['tokens'].tolist()))} distinct, min plain "
              f"top-2 margin {ref['margins'].min():.3e}); plain path "
              f"{ref['wall']:.1f} s [{card}]", flush=True)
    unb = runs["unbounded"]["run"]
    wrap = plain_stream_from(plain, unb.pop("snapshot"), pieces, dev,
                             PLAIN_WRAP_SECS)
    lo, hi = wrap["first"], len(wrap["tokens"])
    if not (4 * unb["positions"] > unb["max_enc"]
            and 4 * wrap["positions"] > wrap["max_enc"] + 8 * P_STEP
            and hi <= len(unb["tokens"])
            and (wrap["tokens"][:lo] == unb["tokens"][:lo]).all()):
        fail("an unbounded w8 session never wrapped its encoder ring, or "
             "the plain path's restored stretch does not continue the "
             "kernel session")
    same_wrap = first_divergence(
        "w8 unbounded session kernel vs plain through the encoder wrap",
        unb["tokens"][lo:hi], wrap["tokens"][lo:], wrap["margins"],
        MARGIN_TIE)
    print(f"w8 unbounded session, plain path restored from the kernel "
          f"session at token {lo} ({WRAP_FROM_SECS:.0f} s) to "
          f"{PLAIN_WRAP_SECS:.0f} s, through the encoder ring's wrap "
          f"(position {wrap['max_enc'] // 4}): tokens kernel == plain over "
          f"{hi - lo}: {same_wrap} (min plain top-2 margin "
          f"{wrap['margins'].min():.3e}); plain path {wrap['wall']:.1f} s "
          f"[{card}]", flush=True)
    layout_tie, layout_noise = layout_witness(
        model, pieces, dev, card, runs["bounded"]["run"], unb)
    b_tok, u_tok = (runs[n]["run"]["tokens"] for n in ("bounded", "unbounded"))
    same_bu = first_divergence("w8 bounded vs unbounded session", b_tok, u_tok,
                               unb["margins"],
                               layout_tie)
    # The one-shot path on the same audio, in one chunk.
    model.record_margins = True
    pipe = TranscribePipeline(model, tok, PipelineConfig(
        max_mel_frames=int(STREAM_SECS * 100) + 2000, peak_normalize=None))
    one = pipe._chunk_tokens(sig, SR)
    one_margins = model.last_margins[0]
    model.record_margins = False
    if len(one) != 1:
        fail(f"one-shot: {len(one)} chunks, expected 1")
    n = min(len(one[0]), len(u_tok))
    agree = float((one[0][:n] == u_tok[:n]).mean())
    same_one = first_divergence("w8 unbounded session vs one-shot",
                                u_tok[:n], one[0][:n], one_margins[:n],
                                layout_tie)
    print(f"w8 sessions: bounded == unbounded tokens: {same_bu}; unbounded "
          f"session vs one-shot transcribe_samples over {n} positions: "
          f"identical {same_one}, agreement rate {agree:.4f} [{card}]",
          flush=True)
    spec = {}
    for draft in ("pad", "ngram"):
        run = stream_run(model, pieces, dev, unbounded=True,
                         speculative=SPEC_K, draft=draft)
        check_stream_launches(f"w8 spec {draft}", run, "w8")
        m = run["spec"]
        same = first_divergence(f"w8 unbounded speculative={SPEC_K} {draft} "
                                "vs sequential", run["tokens"], u_tok,
                                unb["margins"],
                                SPEC_MARGIN_TIE)
        spec[draft] = dict(run=run, metrics=m, same=same)
        report_stream(f"w8 unbounded speculative={SPEC_K} draft={draft} "
                      "session", run, card)
        print(f"w8 speculative={SPEC_K} draft={draft} session: {m}; tokens "
              f"== sequential: {same} [{card}]", flush=True)
    _, wrap_launches = run_stream_wrap(model, plain, dev, card)
    return dict(k1_err=k1_err, k1_times=k1_times, runs=runs, spec=spec,
                wrap_launches=wrap_launches, layout_noise=layout_noise)


def run_stream_q4g(model, plain, dev, card):
    """Phase 8b: the q4g unbounded session, sequential and spec (pad)."""
    k1_err, k1_times = check_k1_ring(model, dev, card)
    pieces = ragged_pieces(stream_signal(Q4G_STREAM_SECS), seed=5)
    model.record_margins = True  # they judge spec against sequential
    try:
        run = stream_run(model, pieces, dev, unbounded=True)
    finally:
        model.record_margins = False
    check_stream_launches("q4g unbounded", run, "q4g")
    ref = plain_stream(plain, pieces, dev, secs=Q4G_PLAIN_STREAM_SECS,
                       unbounded=True)
    n = len(ref["tokens"])
    if n < P_STEP:
        fail(f"q4g plain session: only {n} tokens")
    same = first_divergence("q4g unbounded session kernel vs plain",
                            run["tokens"][:n], ref["tokens"], ref["margins"],
                            MARGIN_TIE)
    report_stream("q4g unbounded session", run, card, model)
    spec = stream_run(model, pieces, dev, unbounded=True,
                      speculative=SPEC_K, draft="pad")
    check_stream_launches("q4g spec pad", spec, "q4g")
    same_spec = first_divergence(f"q4g speculative={SPEC_K} pad vs "
                                 "sequential", spec["tokens"], run["tokens"],
                                 run["margins"], SPEC_MARGIN_TIE)
    report_stream(f"q4g unbounded speculative={SPEC_K} draft=pad session",
                  spec, card)
    print(f"q4g sessions: kernel == plain {same}, spec == sequential "
          f"{same_spec}, {spec['spec']} [{card}]",
          flush=True)
    return dict(k1_err=k1_err, k1_times=k1_times, run=run, spec=spec)


def run_stream_q4(model, plain, dev, card):
    """Phase 8c: a short bounded packed-q4 session, the per-op step on
    K3.  K3 launches: 1 (the first token's lm_head; the 38-row prefill
    dequantizes) + 183 per per-op position (the 7 x 26 decoder linears
    and the lm_head at one row) + 2 per steady step (the adapter's two
    linears at P = 8 rows; the encoder's 32-row matmuls dequantize)."""
    pieces = ragged_pieces(stream_signal(Q4_STREAM_SECS), seed=6)
    lm = model.config.language_model
    run = stream_run(model, pieces, dev, max_duration_s=Q4_STREAM_SECS + 4)
    per_pos = 7 * lm.n_layers + 1
    steady = (run["positions"] - 38 - P_STEP) // P_STEP
    expect = 1 + per_pos * (P_STEP - 1) + steady * (per_pos * P_STEP + 2)
    if run["launches"]["q4_matmul"] != expect:
        fail(f"q4 session: K3 launches {run['launches']['q4_matmul']} != "
             f"{expect}")
    ref = plain_stream(plain, pieces, dev, secs=Q4_PLAIN_STREAM_SECS,
                       max_duration_s=Q4_STREAM_SECS + 4)
    n = len(ref["tokens"])
    if n < P_STEP:
        fail(f"q4 plain session: only {n} tokens")
    same = first_divergence("q4 bounded session kernel vs plain",
                            run["tokens"][:n], ref["tokens"], ref["margins"],
                            MARGIN_TIE)
    report_stream("q4 bounded session (per-op, K3)", run, card)
    print(f"q4 session: K3 launches {expect} = 1 + {per_pos} x "
          f"{P_STEP - 1} + {steady} steps x ({per_pos} x {P_STEP} + 2); "
          f"tokens kernel == plain {same} [{card}]", flush=True)
    return dict(run=run)


# ---------------------------------------------------------------------------
# Pooled streaming (StreamPool)
# ---------------------------------------------------------------------------

POOL_SECS = 14.0       # each stream of the B = 4 pools
POOL_SHORT_SECS = 9.0  # the chunked, checkpoint and q4g pools
POOL_Q4_SECS = 4.0     # the packed-q4 generic pool (per-op, slow)
TICK = 2560 * P_STEP   # samples of one steady step (1.28 s)
POOL_OFFS = [100, 8237, 8241, 16000]  # four streams, four ring phases
POOL_STREAMS = (4, 2)  # the pool sizes of this script (K2 is held at them)
# How many ticks the slower side of a pair of pool runs takes (the plain
# path; a speculative pool beside its sequential twin): the streams are
# causal, so its tokens are held as a prefix of the full run's.
B4_PLAIN_TICKS = 8     # of 15: every ready count, the detach and attach
B4_REPLACE_TICK = 6    # stream 1 finishes, a fresh session takes its slot
B4_SPEC_TICKS = 8
SHORT_PLAIN_TICKS = 3  # of the short pools' 9
# Every decoder-cache geometry a pool of this run handed to K1, by the
# model's decode route: {route: {(streams, S, ring, chunk, int8, spec,
# reach)}}, ``reach`` the offsets' bound.  K1 alone is held against its
# plain version at each (``check_k1_pool_geometries``).
POOL_GEOMETRIES: dict = {}


def pool_signal(secs: float, i: int) -> np.ndarray:
    """Stream i's chirp: 200 + 40 i Hz rising 60 + 10 i Hz/s, peak 0.95."""
    t = np.arange(int(secs * SR)) / SR
    sig = np.sin(2 * np.pi * (200 + 40 * i + (60 + 10 * i) * t) * t)
    return (0.95 * sig / np.abs(sig).max()).astype(np.float32)


def make_pool(model, streams: int, **kw):
    """A StreamPool of one of POOL_STREAMS sizes, its K1 geometry noted
    in POOL_GEOMETRIES."""
    from voxtral_tpu_torch.streaming import StreamPool

    if streams not in POOL_STREAMS:
        fail(f"a pool of {streams} streams: K2 is held at {POOL_STREAMS}")
    pool = StreamPool(model, max_streams=streams, step_positions=P_STEP, **kw)
    if pool._fused is not None and model.parallel is None:
        _, bc, _, n_slots, _ = pool.dec_k.shape
        POOL_GEOMETRIES.setdefault(model.decode_route, set()).add(
            (bc, n_slots, pool._dec_ring, pool._cache_chunk, pool.cache_int8,
             max(1, pool.speculative), pool.max_dec))
    return pool


def kv_step_case(model, dev, card, tag, S, offs, spec, ring, int8, chunk,
                 dead=None, iters=10, timed=True):
    """One K1 step at full width over len(offs) streams x spec rows in a
    cache mode of this slice -- per-row ring phases ((c) x (d)), int8 KV
    (e), the chunked walk (f) -- against the plain version, timed in
    turns, with its bound: the weights, and of the cache only the slots
    some row sees (int8: codes and their scales).  ``dead``: a slot slice
    holding NaN, which must not be read.  -> (max abs err, host-called
    ms, plain ms, bound ms, bound by, device ms from a CUDA graph in mode
    (f), else None); only the error when not ``timed``."""
    import torch

    from voxtral_tpu_torch.models.layers import ring_k_positions
    from voxtral_tpu_torch.ops import decode_step as k1

    cfg = model.config.language_model
    fused = model.fused_decode
    L, D, hd, n_kv = cfg.n_layers, cfg.dim, cfg.head_dim, cfg.n_kv_heads
    bc = len(offs)
    gen = torch.Generator(device=dev).manual_seed(17 + bc * spec + S)
    shape = (L, bc, n_kv, S, hd)
    kc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    kw = dict(n_heads=cfg.n_heads, n_kv=n_kv, head_dim=hd, eps=cfg.norm_eps,
              window=cfg.sliding_window, spec=spec, ring=ring,
              cache_chunk=chunk)
    if int8:
        kc, ks = k1.quantize_kv(kc)
        vc, vs = k1.quantize_kv(vc)
        if dead is not None:
            ks[:, :, :, dead] = float("nan")
            vs[:, :, :, dead] = float("nan")
        kw.update(k_scales=ks, v_scales=vs)
    elif dead is not None:
        kc[:, :, :, dead] = float("nan")
        vc[:, :, :, dead] = float("nan")
    x = torch.randn((bc * spec, D), device=dev, generator=gen)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    pos = (off[:, None] + torch.arange(spec, device=dev)).reshape(-1)
    c, s = k1.rope_pair_vectors(pos, hd, cfg.rope_theta)
    ada = k1.ada_vectors(model.params["decoder"], model.t_embed(6.0))
    args = (x, off, fused["attn_norm"], fused["ffn_norm"], ada,
            fused["sqkv"], fused["so"], fused["s13"], fused["s2"], c, s,
            kc, vc, fused["wqkv"], fused["wo"], fused["w13"], fused["w2"],
            *lm_fold(model))
    tag = (f"K1 {tag} [{model.decode_route}] S={S} ring={ring} "
           f"offsets={offs} spec={spec} cache_chunk={chunk}")
    got = k1.decode_stack_step(*args, **kw)
    torch.cuda.synchronize()
    ref = k1.decode_stack_step_plain(*args, **kw)
    if not all(torch.isfinite(r.float()).all() for r in ref):
        fail(f"{tag}: the plain version read a poisoned slot")
    worst = compare(tag, got, ref, (K1_RTOL, KV_RTOL, KV_RTOL, K1_RTOL))
    if not timed:
        del kc, vc, kw, args
        torch.cuda.empty_cache()
        return (worst,)
    ms, plain_ms = in_turns(lambda: k1.decode_stack_step(*args, **kw),
                            lambda: k1.decode_stack_step_plain(*args, **kw),
                            iters, 1)
    # Mode (f) also on the device alone (CUDA graph).
    dev_ms = (graph_ms(lambda: k1.decode_stack_step(*args, **kw), reps=10,
                       iters=5) if chunk else None)
    # Slots the step must read: per stream, those its first row sees.
    seen = 0
    for o in offs:
        if ring is None:
            seen += min(o, S) - max(0, o - cfg.sliding_window)
        else:
            p_abs, written = ring_k_positions(*ring, o, device=dev, slots=S)
            seen += int((written & (o - p_abs <= cfg.sliding_window)).sum())
    per_slot = hd * (1 if int8 else 2) + (4 if int8 else 0)
    kv_read = 2 * L * n_kv * seen * per_slot
    n_vocab = lm_fold(model)[1].shape[0]
    wbytes = step_weight_bytes(model)
    moved = (wbytes + kv_read + 2 * nbytes(x) + 2 * nbytes(got[1])
             + bc * spec * n_vocab * 4)
    n_weights = n_stack_weights(model)
    b_ms, b_by = bound(moved, 2 * bc * spec * (n_weights + n_vocab * D),
                       weight_ops_peak(model))
    on_dev = ("" if dev_ms is None else
              f"{dev_ms:.3f} ms on the device (CUDA graph; "
              f"{100 * b_ms / dev_ms:.1f} % of the bound), ")
    print(f"{tag}: kernel {on_dev}{ms:.3f} ms called from the host, plain "
          f"{plain_ms:.3f} ms; {seen} cache "
          f"slots read ({kv_read / 1e9:.4f} GB) + weights "
          f"{wbytes / 1e9:.4f} GB; bound {b_ms:.4f} ms ({b_by}; "
          f"{100 * b_ms / ms:.1f} % of it) [{card}]", flush=True)
    del kc, vc, kw, args
    torch.cuda.empty_cache()
    return worst, ms, plain_ms, b_ms, b_by, dev_ms


def sdpa_visible_ms(qkv, kc, vc, vis, nh: int) -> float:
    """Device ms (CUDA graph) of torch's scaled_dot_product_attention
    over each stream's visible bf16 K / V (``vis``: slot indices per
    stream of kc / vc [streams, n_kv, S, hd]), GQA expanded to the ``nh``
    query heads and padded to the longest under a boolean mask, the
    gather done before the timing.  A yardstick the port never calls."""
    import torch

    streams, nkv, _, hd = kc.shape
    n = max(len(v) for v in vis)
    kx = torch.zeros((streams, nh, n, hd), dtype=torch.bfloat16,
                     device=kc.device)
    vx = torch.zeros_like(kx)
    mask = torch.zeros((streams, 1, 1, n), dtype=torch.bool,
                       device=kc.device)
    for b, idx in enumerate(vis):
        kx[b, :, :len(idx)] = kc[b][:, idx].repeat_interleave(nh // nkv,
                                                              dim=0)
        vx[b, :, :len(idx)] = vc[b][:, idx].repeat_interleave(nh // nkv,
                                                              dim=0)
        mask[b, :, :, :len(idx)] = True
    q = qkv[:, :nh * hd].reshape(streams, nh, 1, hd).bfloat16()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return graph_ms(lambda: sdpa(q, kx, vx, attn_mask=mask))


def chunk_block_case(lm, dev, offs, int8: bool, seed: int):
    """The attention block alone (``ops.decode_step.attention_block``)
    in mode (f), chunk 512, one layer at full width on the chunked pools'
    grown ring (17 chunks of 512 slots), bf16 or int8 cache: held to its
    plain version with torch.equal, then its device ms (CUDA graph), the
    device ms of scaled_dot_product_attention over the same visible K / V
    in bf16 (int8: the codes times their scales; a yardstick only: it
    computes neither the per-chunk rounding nor the int8 groups), and
    its bound (the visible K / V, and their scales, read once).
    -> (ms, sdpa ms, bound ms, bound by, visible slots), or None when
    not bit-equal."""
    import torch

    from voxtral_tpu_torch.models.layers import ring_k_positions
    from voxtral_tpu_torch.ops import decode_step as k1

    nh, nkv, hd, win = lm.n_heads, lm.n_kv_heads, lm.head_dim, \
        lm.sliding_window
    ring, _ = ring_geometry(lm)
    S = 8704
    ring = (ring[0], S - ring[0])
    streams = len(offs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((streams, (nh + 2 * nkv) * hd), device=dev,
                      generator=gen)
    kc = (torch.randn((streams, nkv, S, hd), device=dev, generator=gen)
          * 0.5).bfloat16()
    vc = (torch.randn((streams, nkv, S, hd), device=dev, generator=gen)
          * 0.5).bfloat16()
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    c, s = k1.rope_pair_vectors(off, hd, lm.rope_theta)
    kw = dict(n_heads=nh, n_kv=nkv, head_dim=hd, window=win, ring=ring,
              cache_chunk=512)
    kb, vb = kc, vc
    if int8:
        (kc, ks), (vc, vs) = k1.quantize_kv(kc), k1.quantize_kv(vc)
        kw.update(k_scales=ks, v_scales=vs)
        kb = (kc.float() * ks[..., None]).bfloat16()
        vb = (vc.float() * vs[..., None]).bfloat16()
    got = k1.attention_block(qkv, c, s, kc, vc, off, **kw)
    torch.cuda.synchronize()
    ref = k1.attention_block_plain(qkv, c, s, kc, vc, off, **kw)
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        return None
    ms = graph_ms(lambda: k1.attention_block(qkv, c, s, kc, vc, off, **kw))
    vis = []
    for o in offs:
        p_abs, written = ring_k_positions(*ring, o, device=dev, slots=S)
        vis.append(torch.nonzero(written & (o - p_abs <= win)).flatten())
    sdpa_ms = sdpa_visible_ms(qkv, kb, vb, vis, nh)
    seen = sum(len(v) for v in vis)
    per_slot = hd * (1 if int8 else 2) + (4 if int8 else 0)
    b_ms, b_by = bound(2 * nkv * seen * per_slot + nbytes(qkv, c, s)
                       + nbytes(*got), 4 * nh * seen * hd,
                       INT8_OPS if int8 else BF16_FLOPS)
    return ms, sdpa_ms, b_ms, b_by, seen


# The attention yardstick's streams, every window full: one stream, and
# four at the pools' ring phases.
YARD_OFFS = {1: [16000], 4: [8246, 12006, 16000, 16318]}


def attention_yardstick(model, dev, card):
    """The attention block alone (``ops.decode_step.attention_block``, the
    launch K1 and K4 make per layer), one layer at full width under mode
    (d) with the window full, at one and four streams: bit-equal to its
    plain version, its device time (CUDA graph) beside its bound (the
    visible K / V once) and beside torch's scaled_dot_product_attention
    over the same visible bf16 K / V (GQA expanded to the query heads, a
    boolean mask, the gather done before the timing).  SDPA is a yardstick
    only: the port never calls it.  Also prints the library's plan
    (``kernel_attn_plan``) at every geometry of this script's attention
    checks, and fails where it finds none.
    -> {streams: (ms, sdpa ms, bound ms, bound by)}."""
    import torch

    from voxtral_tpu_torch.models.layers import ring_k_positions
    from voxtral_tpu_torch.ops import decode_step as k1

    cfg = model.config.language_model
    nh, nkv, hd, win = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.sliding_window)
    ring, S = ring_geometry(cfg)
    for streams, heads, kvh, spec, span, int8 in (
            (1, nh, nkv, 1, S, False), (1, nh, nkv, SPEC_K, S, False),
            (4, nh, nkv, 1, S, False), (4, nh, nkv, 1, S, True),
            (4, nh, nkv, SPEC_K, S, True), (1, nh, nkv, 1, 240, False),
            (8, nh, nkv, SPEC_K, 247, False), (4, nh // 2, nkv // 2, 1, S,
                                                False),
            (4, nh // 2, nkv // 2, SPEC_K, S, True),
            (1, nh // 2, nkv // 2, 1, 151, False)):
        plan = k1.kernel_attn_plan(streams, heads, kvh, spec, hd, span, int8)
        if plan[0] == 0:
            fail(f"no cluster plan fits streams={streams} heads={heads}/"
                 f"{kvh} spec={spec} span={span} int8={int8}")
        print(f"attention plan streams={streams} heads={heads}/{kvh} "
              f"spec={spec} span={span} int8={int8}: cluster {plan[0]}, "
              f"{plan[1]} query vectors a cluster, {plan[2]} cluster(s) a "
              f"kv head, {plan[3]} slots a block, {plan[4]} bytes of shared "
              f"memory", flush=True)
    out = {}
    for streams, offs in YARD_OFFS.items():
        gen = torch.Generator(device=dev).manual_seed(90 + streams)
        qkv = torch.randn((streams, (nh + 2 * nkv) * hd), device=dev,
                          generator=gen)
        kc = (torch.randn((streams, nkv, S, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        vc = (torch.randn((streams, nkv, S, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        c, s = k1.rope_pair_vectors(off, hd, cfg.rope_theta)
        kw = dict(n_heads=nh, n_kv=nkv, head_dim=hd, window=win, ring=ring)
        tag = (f"attention block alone (d) window full, {streams} "
               f"stream(s), S={S} ring={ring} offsets={offs}")
        got = k1.attention_block(qkv, c, s, kc, vc, off, **kw)
        torch.cuda.synchronize()
        ref = k1.attention_block_plain(qkv, c, s, kc, vc, off, **kw)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            fail(f"{tag}: not bit-equal to the plain version")
        ms = graph_ms(lambda: k1.attention_block(qkv, c, s, kc, vc, off,
                                                 **kw))
        vis = []
        for o in offs:
            p_abs, written = ring_k_positions(*ring, o, device=dev, slots=S)
            vis.append(torch.nonzero(written & (o - p_abs <= win))
                       .flatten())
        sdpa_ms = sdpa_visible_ms(qkv, kc, vc, vis, nh)
        seen = sum(len(v) for v in vis)
        b_ms, b_by = bound(2 * nkv * seen * hd * 2 + nbytes(qkv, c, s)
                           + nbytes(*got), 4 * nh * seen * hd, BF16_FLOPS)
        out[streams] = (ms, sdpa_ms, b_ms, b_by)
        print(f"{tag}: bit-equal; kernel {ms:.4f} ms per layer on the "
              f"device (CUDA graph), torch scaled_dot_product_attention "
              f"{sdpa_ms:.4f} ms over the gathered visible K / V (GQA "
              f"expanded, bool mask; yardstick only), bound {b_ms:.4f} ms "
              f"({b_by}; {100 * b_ms / ms:.1f} % of it) [{card}]",
              flush=True)
        del kc, vc
        torch.cuda.empty_cache()
    return out


# The (f) attention block's cases on the grown ring: (offsets, int8).
YARD_F = {"bf16_1": ([16000], False), "bf16_2": ([100, 16000], False),
          "int8_2": ([100, 16000], True)}


def chunk_yardstick(lm, dev, card) -> dict:
    """The attention block alone in mode (f) (``chunk_block_case``) at
    YARD_F's cases -> {name: (ms, sdpa ms, bound ms, bound by)}."""
    out = {}
    for i, (name, (offs, int8)) in enumerate(YARD_F.items()):
        tag = (f"attention block alone (f) cache_chunk=512, ring grown to "
               f"8704 slots, {'int8' if int8 else 'bf16'}, offsets={offs}")
        r = chunk_block_case(lm, dev, offs, int8, seed=95 + i)
        if r is None:
            fail(f"{tag}: not bit-equal to the plain version")
        ms, sdpa_ms, b_ms, b_by, seen = r
        out[name] = (ms, sdpa_ms, b_ms, b_by)
        print(f"{tag}: bit-equal; kernel {ms:.4f} ms per layer on the "
              f"device (CUDA graph), torch scaled_dot_product_attention "
              f"{sdpa_ms:.4f} ms over the {seen} visible slots' K / V in "
              f"bf16 (yardstick only), bound {b_ms:.4f} ms ({b_by}; "
              f"{100 * b_ms / ms:.1f} % of it) [{card}]", flush=True)
    return out


def check_k1_pool_modes(model, dev, card):
    """K1 alone in this slice's modes at full width -> {name: case},
    "err" and "held" (the geometries covered)."""
    ring, S = ring_geometry(model.config.language_model)
    grown = (ring[0], 8704 - ring[0])  # the ring grown to 17 chunks of 512
    dead = slice(1024, 1536)           # the third chunk of 1536 slots
    cases = {
        "cd": ("(c) x (d) bf16", S, POOL_OFFS, 1, ring, False, None),
        "e": ("(e) int8 KV", S, POOL_OFFS, 1, ring, True, None),
        "e_spec": ("(e) x (b) int8 KV", S, [100, 8234, 8241, 16000], SPEC_K,
                   ring, True, None),
        "f_bounded": ("(f) bf16", 1536, [7, 700], 1, None, False, 512, dead),
        "f_bounded_int8": ("(f) x (e)", 1536, [7, 700], 1, None, True, 512,
                           dead),
        "f_ring": ("(f) bf16", 8704, [100, 16000], 1, grown, False, 512),
        "f_ring_int8": ("(f) x (e)", 8704, [100, 16000], 1, grown, True, 512),
    }
    out = {name: kv_step_case(model, dev, card, *case)
           for name, case in cases.items()}
    out["err"] = max(v[0] for v in out.values())
    out["yard"] = attention_yardstick(model, dev, card)
    out["yard_f"] = chunk_yardstick(model.config.language_model, dev, card)
    # (streams, S, ring, chunk, int8, spec) of each, as POOL_GEOMETRIES
    # keys them.
    out["held"] = {(len(c[2]), c[1], c[4], c[6], c[5], c[3])
                   for c in cases.values()}
    return out


def check_k1_pool_geometries(model, dev, card, held=()) -> float:
    """K1 alone against its plain version at every geometry the pools of
    this model handed it (POOL_GEOMETRIES: streams, slots, ring, chunk,
    cache type and spec rows read off the pools' own tensors), but those
    in ``held`` (streams, S, ring, chunk, int8, spec), which a timed case
    covered.  Offsets: on a ring, the last slot before the wrap (spec
    rows straddling it), far past it, before any wrap and just wrapped;
    bounded, a stream's first and last reachable positions.  A chunked
    geometry is held with both cache types.  -> the worst abs error."""
    worst, done = 0.0, set(held)
    for geom in sorted(POOL_GEOMETRIES.get(model.decode_route, ()), key=str):
        bc, S, ring, chunk, int8, spec, reach = geom
        if ring is None:
            hi = reach - spec
            offs = [7, hi, hi // 2, 100]
        else:
            end = sum(ring)
            offs = [end - 1 - (3 if spec > 1 else 0), 16000, 100, end + 3]
        offs = (offs * bc)[:bc]
        for i8 in ((int8, not int8) if chunk else (int8,)):
            key = (bc, S, ring, chunk, i8, spec)
            if key in done:
                continue
            done.add(key)
            tag = (f"pool geometry {'int8' if i8 else 'bf16'} cache, "
                   f"{bc} streams x {spec}")
            worst = max(worst, kv_step_case(
                model, dev, card, tag, S, offs, spec, ring, i8, chunk,
                timed=False)[0])
    return worst


def pool_counters_reset(dev):
    import torch

    counters = stream_counters()
    release()  # an earlier run's pool and unfinished sessions are a cycle
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    return counters


def pool_run(model, dev, signals, replace=None, max_ticks=None,
             together=False, **pool_kw) -> dict:
    """One StreamPool run: stream i starts at tick i (at tick 0 with
    ``together``; a tick is one steady step of audio, fed in two uneven
    pieces) and the pool is pumped once per tick, timed to a synchronize.  ``replace`` = (i, tick, signal):
    stream i is finished (and detached) at that tick and a fresh session
    with ``signal`` takes its slot.  ``max_ticks`` stops the run there,
    its live streams unfinished: their tokens are a prefix of the full
    run's.  Launch counters are set to 0 just before and read just after.
    -> tokens per session (in order of attachment), pump times by ready
    rows, launches, memory."""
    import torch

    from voxtral_tpu_torch.streaming import StreamingSession

    counters = pool_counters_reset(dev)
    t_start = time.perf_counter()
    pool = make_pool(model, len(signals), **pool_kw)
    rng = np.random.default_rng(8)
    live, done = [], []      # [session, signal, samples fed]
    queue = [(0 if together else i, sig) for i, sig in enumerate(signals)]
    steps: dict = {}         # ready rows -> [pump ms]
    first_ms = None          # the pump that ran the pool's first init
    tick = 0

    def attach(signal):
        entry = [StreamingSession(model, pool=pool), signal, 0]
        done.append(entry[0])  # every session, in order of attachment
        return entry

    while (queue or live) and tick != max_ticks:
        while queue and queue[0][0] <= tick:
            live.append(attach(queue.pop(0)[1]))
        if replace is not None and tick == replace[1]:
            live[replace[0]][0].finish()
            live[replace[0]] = attach(replace[2])
            replace = None
        before = [e[0].positions_done for e in live]
        for e in live:
            cut = int(rng.integers(1, TICK))
            for lo, hi in ((0, cut), (cut, TICK)):
                e[0].feed(e[1][e[2] + lo:e[2] + hi], pump=False)
            e[2] += TICK
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.pump()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        moved = [e[0].positions_done - b for e, b in zip(live, before)]
        if first_ms is None and any(b == 0 and e[0].positions_done
                                    for e, b in zip(live, before)):
            first_ms = dt
        if moved and all(m in (0, P_STEP) for m in moved) and any(moved):
            steps.setdefault(sum(m > 0 for m in moved), []).append(dt)
        for e in [e for e in live if e[2] >= len(e[1])]:
            e[0].finish()
            live.remove(e)
        tick += 1
    if queue or replace is not None:
        fail(f"a pool run of {tick} ticks attached only {len(done)} sessions")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    for ses in done:
        if len(ses.tokens) != ses.positions_done - 38 or ses.overrun:
            fail(f"pooled session: {len(ses.tokens)} tokens for "
                 f"{ses.positions_done} positions (overrun {ses.overrun})")
        if ses.margins and not np.isfinite(ses.margins).all():
            fail("non-finite logits in a pooled session")
    # The fused pools' decoder caches are shard grids (one tensor each on
    # one device).
    tensors = [pool.enc_k, pool.enc_v] + (
        pool._kv.tensors() if pool._kv is not None
        else [pool.dec_k, pool.dec_v])
    if pool._init_dec_zero is not None:
        tensors += [pool._init_dec_zero.k, pool._init_dec_zero.v]
    return dict(
        tokens=[np.asarray(s.tokens) for s in done],
        margins=[np.asarray(s.margins) for s in done],
        positions=[s.positions_done for s in done], steps=steps, wall=wall,
        first_ms=first_ms,
        launches={n: fn.launches for n, fn in counters.items()},
        spec=pool.spec_metrics(), cache_bytes=pool.cache_bytes,
        allocated=nbytes(*tensors), int8=pool.cache_int8,
        chunk=pool._cache_chunk, slots=tensors[2].shape[3],
        ring=pool._dec_ring, fused=pool._fused is not None,
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def margin_gap(run, ref) -> float:
    """Largest difference of the top-2 logit margins of two runs, stream
    by stream, up to each stream's first differing token: 0 when the
    logits' two largest values agree bit for bit.  Random weights emit
    few distinct tokens, so this says more than equal tokens do."""
    gap = 0.0
    for g, r, mg, mr in zip(run["tokens"], ref["tokens"], run["margins"],
                            ref["margins"]):
        n = min(len(g), len(r))
        differ = np.nonzero(g[:n] != r[:n])[0]
        n = int(differ[0]) if len(differ) else n
        if n:
            gap = max(gap, float(np.abs(mg[:n] - mr[:n]).max()))
    return gap


def held_to(tag, run, ref, margins, tie) -> bool:
    """Fail unless each session's tokens in ``run`` agree with ``ref``'s
    (near-tie rule on ``margins``) over the shorter of the two, which
    must have taken its first step; -> tokens identical."""
    if len(run["tokens"]) != len(ref["tokens"]):
        fail(f"{tag}: {len(run['tokens'])} sessions against "
             f"{len(ref['tokens'])}")
    same = []
    for i, (g, r, m) in enumerate(zip(run["tokens"], ref["tokens"], margins)):
        n = min(len(g), len(r))
        if n < P_STEP:
            fail(f"{tag} stream {i}: only {n} tokens to compare")
        same.append(first_divergence(f"{tag} stream {i}", g[:n], r[:n], m,
                                     tie))
    return all(same)


def pool_pair(tag, model, plain, dev, card, signals, tie=MARGIN_TIE,
              plain_ticks=None, **kw):
    """The same pool run through the kernels and through their plain
    versions (those for ``plain_ticks`` ticks), both keeping top-2
    margins: tokens equal, slot by slot, up to a near-tie of the plain
    path, and the margins within ``tie``."""
    model.record_margins = plain.record_margins = True
    try:
        run = pool_run(model, dev, signals, **kw)
        ref = pool_run(plain, dev, signals, max_ticks=plain_ticks, **kw)
    finally:
        model.record_margins = plain.record_margins = False
    same = held_to(f"{tag} kernel vs plain", run, ref, ref["margins"], tie)
    gap = margin_gap(run, ref)
    if not gap <= tie:
        fail(f"{tag}: top-2 margins of the kernel and plain paths differ by "
             f"{gap:.3e} > {tie}")
    if run["cache_bytes"] != run["allocated"]:
        fail(f"{tag}: the pool allocated {run['allocated']} bytes of caches, "
             f"its admission counted {run['cache_bytes']}")
    fused_n = (run["launches"]["decode_stack_step"]
               + run["launches"]["attn_half_step"])
    if run["fused"] and fused_n < 1:
        fail(f"{tag}: a fused pool launched K1 or K4 no time")
    distinct = len(set(np.concatenate(run["tokens"]).tolist()))
    print(f"{tag}: {len(run['tokens'])} sessions, positions "
          f"{run['positions']}, decoder cache {run['slots']} slots "
          f"(int8 {run['int8']}, chunk {run['chunk']}, ring {run['ring']}); "
          f"tokens kernel == plain: {same} ({distinct} distinct; top-2 "
          f"margins differ by at most {gap:.3e}); launches "
          f"{run['launches']}; caches {run['cache_bytes'] / 1e9:.4f} GB "
          f"(allocated == counted), peak GPU memory {run['peak_gb']:.3f} GB; "
          f"kernel path {run['wall']:.1f} s, plain path {ref['wall']:.1f} s "
          f"(positions {ref['positions']}) [{card}]", flush=True)
    return dict(run=run, plain=ref, same=same)


def pool_step_bound(model, ready: int, int8: bool, window_full: bool):
    """(GB, ms) a pooled step must move at least: the encoder and adapter
    weights once, K1's weights P times, and with the window full P reads
    of each ready row's 8192 cached positions (codes + scales if int8)."""
    gb, _ = stream_step_bound(model, False)
    nb = gb * 1e9
    if window_full:
        cfg = model.config.language_model
        per_slot = cfg.head_dim * (1 if int8 else 2) + (4 if int8 else 0)
        nb += ready * P_STEP * 2 * cfg.n_layers * cfg.n_kv_heads \
            * cfg.sliding_window * per_slot
    return nb / 1e9, nb / HBM_BPS * 1e3


def report_pool(tag, run, card, model):
    """Pool step ms by ready rows, the aggregate step RTF (step ms over
    ready x 1280 ms of audio) and the step's bound."""
    for ready in sorted(run["steps"]):
        ms = np.asarray(run["steps"][ready])
        gb, b_ms = pool_step_bound(model, ready, run["int8"], False)
        gbf, b_full = pool_step_bound(model, ready, run["int8"], True)
        print(f"{tag}: pool step at {ready} ready rows: {len(ms)} steps, "
              f"median {np.median(ms):.2f} ms, max {ms.max():.2f} ms, "
              f"aggregate step RTF "
              f"{np.median(ms) / (ready * P_STEP * 160):.5f} (median / "
              f"({ready} x 1280 ms)); step bound {b_ms:.3f} ms ({gb:.2f} GB), "
              f"{b_full:.3f} ms with every window full ({gbf:.2f} GB) "
              f"[{card}]", flush=True)


def expected_pool_bytes(cfg, B: int, int8: bool, s_dec: int, s_enc: int):
    """The pool's cache bytes from the configuration: encoder K and V of
    B slots, the head-major decoder caches (bf16, or int8 codes + f32
    scales) and the shared bf16 init slot."""
    enc, lm = cfg.audio_encoder, cfg.language_model
    e = 2 * enc.n_layers * B * s_enc * enc.n_kv_heads * enc.head_dim * 2
    per = 2 * lm.n_layers * lm.n_kv_heads * s_dec
    d = per * B * (lm.head_dim * (1 if int8 else 2) + (4 if int8 else 0))
    return e + d + per * lm.head_dim * 2


def force_chunked():
    """Replace streaming._fused_plan so that the pools' resident rungs
    are refused (as the JAX package's own test forces the chunked rung);
    -> the function that restores it."""
    import voxtral_tpu_torch.streaming as streaming

    orig = streaming._fused_plan

    def chunk_only(model, batch, cache_s, itemsize=None, chunk=None, **kw):
        if chunk is None:
            return None
        return orig(model, batch, cache_s, itemsize=itemsize, chunk=chunk,
                    **kw)

    streaming._fused_plan = chunk_only

    def restore():
        streaming._fused_plan = orig

    return restore


def pool_vs_solo(model, dev, card, noise):
    """A pooled stream against a solo session on the same audio, under
    the layout rule (two layouts of one stream are held to a control,
    not to equal tokens): slot 0 of a 4-slot unbounded pool, its encoder
    pass batched over 4 rows, may move audio embeds and logits at most
    LAYOUT_NOISE_FACTOR times what a cache-length change alone does
    (``noise`` = that control's (embeds, logits), from the session
    phase)."""
    import torch

    import voxtral_tpu_torch.streaming as streaming
    from voxtral_tpu_torch.streaming import StreamingSession

    sig = pool_signal(POOL_SHORT_SECS, 0)
    pieces = ragged_pieces(sig, seed=9)
    solo = stream_run(model, pieces, dev, keep=True, unbounded=True)
    s_log, s_emb = solo.pop("kept")
    counters = pool_counters_reset(dev)
    pool = make_pool(model, 4, unbounded=True, kv_dtype="model")
    ses = StreamingSession(model, pool=pool)
    logits, embeds = [], []
    encode, decode = streaming._encode, pool._decode

    def kept_encode(m, x, cache, rope, ring):
        audio, cache = encode(m, x, cache, rope, ring)
        embeds.append(audio[0].float().clone())
        return audio, cache

    def kept_step(*a, **kw):  # (tokens, logits, k_new, v_new)
        out = decode(*a, **kw)
        logits.append(out[1][:1].float().clone())
        return out

    streaming._encode, pool._decode = kept_encode, kept_step
    try:
        for piece in pieces:
            ses.feed(piece)
        ses.finish()
    finally:
        streaming._encode = encode
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    p_tok, s_tok = np.asarray(ses.tokens), solo["tokens"]
    p_emb, p_log = torch.cat(embeds), torch.cat(logits)
    if p_emb.shape != s_emb.shape or len(p_tok) != len(s_tok):
        fail(f"pool vs solo: {tuple(p_emb.shape)} embeds, {len(p_tok)} "
             f"tokens against {tuple(s_emb.shape)}, {len(s_tok)}")
    # The pool's K1 logits start after the first step's P tokens.
    s_log = s_log[P_STEP:]
    parted = np.nonzero(p_tok != s_tok)[0]
    n = (max(int(parted[0]) + 1 - P_STEP, 0) if len(parted)
         else len(p_log))
    rel = float(((p_emb - s_emb).norm(dim=-1) / s_emb.norm(dim=-1)).max())
    d_log = (float((p_log[:n] - s_log[:n]).abs().max()) if n else 0.0)
    print(f"pooled stream (slot 0 of 4, unbounded bf16) vs solo session, "
          f"{len(p_tok)} tokens: audio embeds relative L2 difference max "
          f"{rel:.3e} (control {noise[0]:.3e}), logits over {n} K1 steps "
          f"largest difference {d_log:.3e} (control {noise[1]:.3e}); tokens "
          + (f"part at token {int(parted[0])}" if len(parted)
             else "identical")
          + f"; bound {LAYOUT_NOISE_FACTOR} x the control [{card}]",
          flush=True)
    if not (rel <= LAYOUT_NOISE_FACTOR * noise[0]
            and d_log <= LAYOUT_NOISE_FACTOR * noise[1]):
        fail("the pooled stream moved embeds or logits by more than "
             f"{LAYOUT_NOISE_FACTOR} x what a cache-length change alone does")
    return launches


def pool_checkpoint_chain(model, plain, dev, card):
    """slot_state -> solo session -> another (int8) pool, a few steps
    each, with the kernels and through the plain versions: the chains'
    tokens agree (near-tie rule on the plain path's margins)."""
    import torch

    from voxtral_tpu_torch.streaming import StreamingSession

    sig = pool_signal(POOL_SHORT_SECS, 1)
    cuts = [3 * TICK, 5 * TICK]  # of the stream's 7 ticks
    out = {}
    for name, m in (("kernel", model), ("plain", plain)):
        m.record_margins = name == "plain"
        counters = pool_counters_reset(dev)
        first = StreamingSession(m, pool=make_pool(
            m, 2, unbounded=True, kv_dtype="model"))
        first.feed(sig[:cuts[0]])
        solo = StreamingSession.restore(m, first.state_dict())
        solo.feed(sig[cuts[0]:cuts[1]])
        margins = list(solo.margins)
        last = StreamingSession.restore(
            m, solo.state_dict(), pool=make_pool(m, 2, unbounded=True,
                                                 kv_dtype="int8"))
        if not last._pool.cache_int8:
            fail("checkpoint chain: the second pool is not int8")
        last.feed(sig[cuts[1]:])
        last.finish()
        torch.cuda.synchronize()
        m.record_margins = False
        hops = (first.positions_done, solo.positions_done,
                last.positions_done)
        if not hops[0] < hops[1] < hops[2] or \
                len(last.tokens) != hops[2] - 38:
            fail(f"checkpoint chain: positions {hops}, {len(last.tokens)} "
                 "tokens")
        out[name] = (np.asarray(last.tokens), hops, first.margins + margins
                     + last.margins,
                     {n: fn.launches for n, fn in counters.items()})
    toks, hops, _, launches = out["kernel"]
    ptoks, _, margins, _ = out["plain"]
    same = first_divergence("checkpoint chain kernel vs plain", toks, ptoks,
                            np.asarray(margins), MARGIN_TIE)
    print(f"checkpoint chain bf16 pool -> solo session -> int8 pool: "
          f"positions {hops[0]} -> {hops[1]} -> {hops[2]}, {len(toks)} "
          f"tokens; kernel == plain: {same}; launches {launches} [{card}]",
          flush=True)
    return launches


def pool_ring_phases(model, plain, dev, card):
    """Four pooled streams at four ring phases with their windows (all
    but) full, without the audio that leads there: slots restored from
    synthetic checkpoints (random bf16 caches) 2P positions short of the
    decoder ring's wrap, just past it, far past it and near the RoPE
    table's end, then 4 steps together through the kernels and the first
    first of them through the plain versions, with bf16 and with int8
    caches.
    The pool's own path to K1 (c) x (d) and (e) at full windows, and the
    pooled step's time there.  -> {kv_dtype: (launches, step ms)}."""
    import torch

    from voxtral_tpu_torch.streaming import StreamingSession

    _, S = ring_geometry(model.config.language_model)
    n_steps, plain_steps = 4, 1
    # On the streams' grid of 38 + 8 k positions (the encoder ring's
    # writes are aligned to it).
    starts = [S - 2 * P_STEP, S + P_STEP, 38 + 8 * 1496, 38 + 8 * 2035]
    gen = torch.Generator(device=dev).manual_seed(23)
    states = [restored_state(model.config, dev, p0, n_steps, gen,
                             lambda secs, i=i: pool_signal(secs, i))
              for i, p0 in enumerate(starts)]
    out = {}
    for kv in ("model", "int8"):
        res = {}
        for name, m, n in (("kernel", model, n_steps),
                           ("plain", plain, plain_steps)):
            m.record_margins = True
            counters = pool_counters_reset(dev)
            pool = make_pool(m, 4, unbounded=True, kv_dtype=kv)
            cut = [restored_samples(p0, n)[1] for p0 in starts]
            sessions = [StreamingSession.restore(
                m, dict(st, samples=st["samples"][:c]), pool=pool)
                for st, c in zip(states, cut)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.pump()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / n
            m.record_margins = False
            for ses, p0 in zip(sessions, starts):
                if ses.positions_done != p0 + n * P_STEP:
                    fail(f"ring phases: a slot at {ses.positions_done}, "
                         f"expected {p0 + n * P_STEP}")
            res[name] = dict(
                tokens=[np.asarray(s.tokens[p0 - 38:])
                        for s, p0 in zip(sessions, starts)],
                margins=[np.asarray(s.margins) for s in sessions],
                launches={n: fn.launches for n, fn in counters.items()},
                step_ms=step_ms)
            del pool, sessions
            release()
        run, ref = res["kernel"], res["plain"]
        same = held_to(f"ring phases kv_dtype={kv} kernel vs plain", run, ref,
                       ref["margins"], MARGIN_TIE)
        gap = margin_gap(run, ref)
        k1n = run["launches"]["decode_stack_step"]
        if k1n != n_steps * P_STEP:
            fail(f"ring phases kv_dtype={kv}: K1 launches {k1n} != "
                 f"{n_steps * P_STEP}")
        if not gap <= MARGIN_TIE:
            fail(f"ring phases kv_dtype={kv}: top-2 margins differ by "
                 f"{gap:.3e}")
        distinct = len(set(np.concatenate(run["tokens"]).tolist()))
        gb, b_ms = pool_step_bound(model, 4, kv == "int8", True)
        print(f"w8 pool B=4 at ring phases {starts} (windows full), "
              f"kv_dtype={kv}: {n_steps} steps of 4 ready rows, "
              f"{run['step_ms']:.2f} ms per step (plain path, "
              f"{plain_steps} steps: {ref['step_ms']:.1f} ms), aggregate "
              f"step RTF "
              f"{run['step_ms'] / (4 * P_STEP * 160):.5f}; step bound "
              f"{b_ms:.3f} ms ({gb:.2f} GB); tokens kernel == plain: {same} "
              f"over the plain path's {4 * plain_steps * P_STEP} ({distinct} "
              f"distinct of {4 * n_steps * P_STEP}; top-2 margins differ by "
              f"at most {gap:.3e}); K1 launches {k1n} [{card}]",
              flush=True)
        out[kv] = (run["launches"], run["step_ms"])
    return out


def pool_all_live(model, dev, card, signals):
    """Pooled speculative decode with every slot live: four chirps
    started in the same tick, none detached, B4_SPEC_TICKS ticks of a
    bf16-cache ngram pool, held to the sequential kernel pool with the
    same start -> the speculative run."""
    tag = f"w8 pool B=4 speculative={SPEC_K} ngram, every slot live"
    model.record_margins = True
    try:
        seq = pool_run(model, dev, signals, max_ticks=B4_SPEC_TICKS,
                       together=True, unbounded=True, kv_dtype="model")
    finally:
        model.record_margins = False
    run = pool_run(model, dev, signals, max_ticks=B4_SPEC_TICKS,
                   together=True, unbounded=True, kv_dtype="model",
                   speculative=SPEC_K, draft="ngram")
    m = run["spec"]
    same = held_to(f"{tag} vs sequential", run, seq, seq["margins"],
                   SPEC_MARGIN_TIE)
    if run["launches"]["decode_stack_step"] != m["passes"]:
        fail(f"{tag}: K1 launches {run['launches']['decode_stack_step']} "
             f"!= passes {m['passes']}")
    print(f"{tag}: {B4_SPEC_TICKS} ticks, positions {run['positions']}: "
          f"{m} (predicted 20-28 tokens per pass); tokens == sequential "
          f"pool with the same start: {same}; sequential {seq['wall']:.1f} "
          f"s, speculative {run['wall']:.1f} s [{card}]", flush=True)
    return run


def run_pools_w8(model, plain, dev, card, layout_noise):
    """Phase 10a: K1 in this slice's modes, then the w8 pools."""
    import torch

    k1 = check_k1_pool_modes(model, dev, card)
    cfg = model.config
    signals = [pool_signal(POOL_SECS, i) for i in range(4)]
    replace = (1, B4_REPLACE_TICK, pool_signal(POOL_SECS / 2, 4))
    runs, paths = {}, {}
    for kv in ("model", "int8"):
        tag = f"w8 pool B=4 unbounded kv_dtype={kv}"
        pair = pool_pair(tag, model, plain, dev, card, signals,
                         plain_ticks=B4_PLAIN_TICKS, replace=replace,
                         unbounded=True, kv_dtype=kv)
        run = pair["run"]
        if run["int8"] != (kv == "int8") or run["chunk"] is not None:
            fail(f"{tag}: the ladder picked int8 {run['int8']}, chunk "
                 f"{run['chunk']}")
        want = expected_pool_bytes(cfg, 4, run["int8"], run["slots"],
                                   sum(enc_ring_geometry(cfg.audio_encoder)))
        if run["cache_bytes"] != want:
            fail(f"{tag}: caches {run['cache_bytes']} bytes, the formula "
                 f"gives {want}")
        report_pool(tag, run, card, model)
        runs[kv] = pair
        paths[f"w8_pool_unbounded_{kv}"] = run["launches"]
    # The int8 pool against the bf16 pool: no token rule across cache
    # types; how far the streams sit apart.
    agree, first = [], []
    for a, b in zip(runs["int8"]["run"]["tokens"],
                    runs["model"]["run"]["tokens"]):
        n = min(len(a), len(b))
        differ = np.nonzero(a[:n] != b[:n])[0]
        agree.append(round(float((a[:n] == b[:n]).mean()), 4))
        first.append(int(differ[0]) if len(differ) else -1)
    gap = margin_gap(runs["int8"]["run"], runs["model"]["run"])
    print(f"w8 pool int8 vs bf16 caches: token agreement per stream "
          f"{agree}, first parting at token {first} (-1: none); top-2 "
          f"margins up to there differ by at most {gap:.3e} [{card}]",
          flush=True)

    spec = {}
    for kv in ("model", "int8"):
        seq = runs[kv]
        for draft in ("pad", "ngram"):
            tag = f"w8 pool B=4 speculative={SPEC_K} {draft} kv_dtype={kv}"
            run = pool_run(model, dev, signals, replace=replace,
                           max_ticks=B4_SPEC_TICKS, unbounded=True,
                           kv_dtype=kv, speculative=SPEC_K, draft=draft)
            m = run["spec"]
            # The sequential kernel pool's own margins judge a flip: it
            # ran to the end (its plain twin stops earlier).
            same = held_to(f"{tag} vs sequential", run, seq["run"],
                           seq["run"]["margins"], SPEC_MARGIN_TIE)
            if run["launches"]["decode_stack_step"] != m["passes"]:
                fail(f"{tag}: K1 launches "
                     f"{run['launches']['decode_stack_step']} != passes "
                     f"{m['passes']}")
            print(f"{tag}: {B4_SPEC_TICKS} ticks, positions "
                  f"{run['positions']}: {m}; tokens == sequential pool: "
                  f"{same}; launches {run['launches']}; {run['wall']:.1f} s "
                  f"[{card}]", flush=True)
            spec[(draft, kv)] = dict(run=run, same=same)
            paths[f"w8_pool_speculative_{draft}_{kv}"] = run["launches"]

    spec["all_live"] = pool_all_live(model, dev, card, signals)
    paths["w8_pool_speculative_ngram_all_live"] = spec["all_live"]["launches"]

    restore = force_chunked()
    try:
        short = [pool_signal(POOL_SHORT_SECS, i) for i in (5, 6)]
        for name, kw in (("bounded", dict(max_duration_s=120)),
                         ("unbounded", dict(unbounded=True))):
            tag = f"w8 pool B=2 chunked {name}"
            pair = pool_pair(tag, model, plain, dev, card, short,
                             plain_ticks=SHORT_PLAIN_TICKS, **kw)
            run = pair["run"]
            if run["chunk"] != 512 or not run["int8"] or run["slots"] % 512:
                fail(f"{tag}: the forced rung gave chunk {run['chunk']}, "
                     f"int8 {run['int8']}, {run['slots']} slots")
            report_pool(tag, run, card, model)
            paths[f"w8_pool_chunked_{name}"] = run["launches"]
    finally:
        restore()
    phases = pool_ring_phases(model, plain, dev, card)
    for kv, (launches, _) in phases.items():
        paths[f"w8_pool_ring_phases_{kv}"] = launches
    paths["w8_pool_vs_solo"] = pool_vs_solo(model, dev, card, layout_noise)
    paths["w8_pool_checkpoint_chain"] = pool_checkpoint_chain(model, plain,
                                                              dev, card)
    release()
    k1["err"] = max(k1["err"], check_k1_pool_geometries(model, dev, card,
                                                        k1["held"]))
    return dict(k1=k1, runs=runs, spec=spec, paths=paths, phases=phases)


def run_pools_q4g(model, plain, dev, card):
    """Phase 10b: K1 (e) on g32 weights, and a short q4g pool, B = 2."""
    ring, S = ring_geometry(model.config.language_model)
    e_g32 = kv_step_case(model, dev, card, "(e) x (h) int8 KV", S, POOL_OFFS,
                         1, ring, True, None)
    short = [pool_signal(POOL_SHORT_SECS, i) for i in (2, 3)]
    pair = pool_pair("q4g pool B=2 unbounded kv_dtype=int8", model, plain,
                     dev, card, short, plain_ticks=SHORT_PLAIN_TICKS,
                     unbounded=True, kv_dtype="int8")
    report_pool("q4g pool B=2", pair["run"], card, model)
    release()
    err = max(e_g32[0], check_k1_pool_geometries(model, dev, card))
    return dict(e_g32=e_g32, err=err, launches=pair["run"]["launches"])


def run_pools_q4(model, plain, dev, card):
    """Phase 10c: the generic pool (packed q4, per-op, K3), B = 2, very
    short: each ready slot takes the solo step on its cache views."""
    short = [pool_signal(POOL_Q4_SECS, i) for i in (2, 3)]
    pair = pool_pair("q4 generic pool B=2 bounded", model, plain, dev, card,
                     short, plain_ticks=3, max_duration_s=POOL_Q4_SECS + 4)
    run = pair["run"]
    if run["fused"] or run["launches"]["decode_stack_step"] or \
            run["launches"]["q4_matmul"] < 1:
        fail(f"q4 generic pool: launches {run['launches']}")
    return dict(launches=run["launches"])


# ---------------------------------------------------------------------------
# GGUF entry
# ---------------------------------------------------------------------------


def small_gguf(directory: Path):
    """A small-config Q4_0 GGUF (decoder widths % 256, so K3 and mode (h)
    take it), its params.json and a synthetic tekken.json, written with
    the port's write_gguf -> (gguf, tokenizer, params, wav) paths."""
    import base64

    from voxtral_tpu_torch.audio import AudioBuffer, save_wav
    from voxtral_tpu_torch.config import (
        AdapterConfig,
        AudioEncoderConfig,
        AudioInputConfig,
        LanguageModelConfig,
        VoxtralConfig,
    )
    from voxtral_tpu_torch.loaders import names as N
    from voxtral_tpu_torch.loaders.gguf import GGML_F32, GGML_Q4_0, write_gguf
    from voxtral_tpu_torch.ops.q4 import quantize_q4_0

    cfg = VoxtralConfig(
        audio_encoder=AudioEncoderConfig(
            dim=64, n_layers=2, n_heads=2, n_kv_heads=2, head_dim=32,
            hidden_dim=128, sliding_window=64),
        language_model=LanguageModelConfig(
            dim=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
            hidden_dim=512, vocab_size=4096, sliding_window=64),
        adapter=AdapterConfig(input_dim=256, hidden_dim=256, output_dim=256),
        audio=AudioInputConfig(), ada_rms_norm_t_cond_dim=32,
        downsample_factor=4)
    e, l = cfg.audio_encoder, cfg.language_model
    rng = np.random.default_rng(5)

    def w(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(2.0 / np.sqrt(shape[-1])))

    def v(n):
        return rng.standard_normal(n, dtype=np.float32)

    t = {}
    cv = N.conv_names()
    t.update({cv["conv1_weight"]: w(e.dim, 128, 3), cv["conv1_bias"]: v(e.dim),
              cv["conv2_weight"]: w(e.dim, e.dim, 3),
              cv["conv2_bias"]: v(e.dim), N.ENCODER_FINAL_NORM: v(e.dim)})
    qd = e.n_heads * e.head_dim
    for i in range(e.n_layers):
        nm = N.encoder_layer_names(i)
        t.update({nm["attention_norm"]: v(e.dim), nm["wq_weight"]: w(qd, e.dim),
                  nm["wq_bias"]: v(qd), nm["wk_weight"]: w(qd, e.dim),
                  nm["wv_weight"]: w(qd, e.dim), nm["wv_bias"]: v(qd),
                  nm["wo_weight"]: w(e.dim, qd), nm["wo_bias"]: v(e.dim),
                  nm["ffn_norm"]: v(e.dim), nm["w1_weight"]: w(e.hidden_dim, e.dim),
                  nm["w2_weight"]: w(e.dim, e.hidden_dim),
                  nm["w2_bias"]: v(e.dim),
                  nm["w3_weight"]: w(e.hidden_dim, e.dim)})
    t[N.TOK_EMBEDDINGS] = w(l.vocab_size, l.dim)
    t[N.FINAL_NORM] = np.abs(v(l.dim)) * np.float32(4.0) + np.float32(1.0)
    qd, kvd = l.n_heads * l.head_dim, l.n_kv_heads * l.head_dim
    for i in range(l.n_layers):
        nm = N.decoder_layer_names(i)
        t.update({nm["ada_norm_down"]: w(cfg.ada_rms_norm_t_cond_dim, l.dim),
                  nm["ada_norm_up"]: w(l.dim, cfg.ada_rms_norm_t_cond_dim),
                  nm["attention_norm"]: v(l.dim), nm["wq_weight"]: w(qd, l.dim),
                  nm["wk_weight"]: w(kvd, l.dim), nm["wv_weight"]: w(kvd, l.dim),
                  nm["wo_weight"]: w(l.dim, qd), nm["ffn_norm"]: v(l.dim),
                  nm["w1_weight"]: w(l.hidden_dim, l.dim),
                  nm["w2_weight"]: w(l.dim, l.hidden_dim),
                  nm["w3_weight"]: w(l.hidden_dim, l.dim)})
    an = N.adapter_names()
    t[an["linear1_weight"]] = w(cfg.adapter.output_dim, cfg.adapter.input_dim)
    t[an["linear2_weight"]] = w(cfg.adapter.output_dim,
                                cfg.adapter.output_dim)
    tensors = {}
    for name, arr in t.items():
        if arr.ndim == 2 and arr.shape[-1] % 32 == 0:
            tensors[name] = (arr.shape, GGML_Q4_0, quantize_q4_0(arr))
        else:
            tensors[name] = (arr.shape, GGML_F32, arr.tobytes())
    gguf = directory / "small_q4.gguf"
    with open(gguf, "wb") as f:
        write_gguf(f, tensors)
    params = directory / "params.json"
    params.write_text(cfg.to_params_json())
    vocab = [{"rank": r, "token_str": s, "is_control": True}
             for r, s in [(0, "<unk>"), (1, "<s>"), (32, "[STREAMING_PAD]"),
                          (33, "[STREAMING_WORD]")]]
    vocab += [{"rank": 1000 + len(vocab),
               "token_bytes": base64.b64encode(f"w{i} ".encode()).decode(),
               "is_control": False} for i in range(l.vocab_size - 1000)]
    tokenizer = directory / "tekken.json"
    tokenizer.write_text(json.dumps({
        "config": {"default_vocab_size": 131072,
                   "default_num_special_tokens": 1000}, "vocab": vocab}))
    tt = np.arange(int(1.5 * 22050)) / 22050
    wav = directory / "tone.wav"
    save_wav(AudioBuffer((0.4 * np.sin(2 * np.pi * 440 * tt)
                          + 0.2 * np.sin(2 * np.pi * 1320 * tt)).astype(
        np.float32), 22050), wav)
    return gguf, tokenizer, params, wav


def run_gguf_cli(dev, card):
    """Phase 7: the CLI on a GGUF for each weight format, and with
    ``--model`` on a SafeTensors directory of the same small model for
    ``--dtype bfloat16`` and ``w8`` (phase 11b), and ``--audio-list`` with
    ``--batch-files 4`` and ``--timestamps`` there (phase 12), each
    against the library path on the same files."""
    import torch

    from voxtral_tpu_torch.audio import AudioBuffer, save_wav
    from voxtral_tpu_torch.config import VoxtralConfig
    from voxtral_tpu_torch.loaders.safetensors_loader import (
        checkpoint_tensors,
        save_safetensors,
    )
    from voxtral_tpu_torch.pipeline import TranscribePipeline
    from voxtral_tpu_torch.utils.quantize import random_dense_params

    with tempfile.TemporaryDirectory() as tmp:
        gguf, tokenizer, params, wav = small_gguf(Path(tmp))
        cfg = VoxtralConfig.from_file(params)
        # The model directory: params.json and tekken.json beside the
        # GGUF, and a dense f32 checkpoint of random weights.
        save_safetensors(checkpoint_tensors(
            random_dense_params(cfg, 5, torch.float32, "cpu", scale=0.1),
            cfg), Path(tmp) / "consolidated.safetensors")
        cli = [sys.executable, "-m", "voxtral_tpu_torch.cli"]
        argvs = {("--weight-format", fmt): [
            *cli, "--gguf", str(gguf), "--tokenizer", str(tokenizer),
            "--params", str(params), "--weight-format", fmt, "--audio",
            str(wav)] for fmt in ("q4", "q4g", "w8")}
        argvs.update({("--model --dtype", dt): [
            *cli, "--model", tmp, "--dtype", dt, "--audio", str(wav)]
            for dt in ("bfloat16", "w8")})
        # The batched one-shot flags (phase 12) on the same directory: a
        # list of three files, two of one length (one batch), and the
        # word timestamps of one.
        wavs = [wav, Path(tmp) / "tone2.wav", Path(tmp) / "tone3.wav"]
        for path, secs, hz in ((wavs[1], 2.5, 330.0), (wavs[2], 1.5, 550.0)):
            tt = np.arange(int(secs * SR)) / SR
            save_wav(AudioBuffer((0.5 * np.sin(2 * np.pi * hz * tt)).astype(
                np.float32), SR), path)
        listing = Path(tmp) / "files.txt"
        listing.write_text("".join(f"{w}\n" for w in wavs))
        argvs[("--audio-list --batch-files 4", "w8")] = [
            *cli, "--model", tmp, "--dtype", "w8", "--audio-list",
            str(listing), "--batch-files", "4"]
        argvs[("--timestamps", "w8")] = [
            *cli, "--model", tmp, "--dtype", "w8", "--timestamps", "--audio",
            str(wav)]
        # The seven processes side by side (most of each is the
        # interpreter's start and the CUDA context).
        t0 = time.perf_counter()
        procs = {key: subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=Path(__file__).resolve().parent)
            for key, argv in argvs.items()}
        try:
            outs = {key: (*p.communicate(timeout=300), p.returncode,
                          time.perf_counter() - t0)
                    for key, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for (flag, fmt), (stdout, stderr, returncode, secs) in outs.items():
            if returncode != 0:
                fail(f"CLI {flag} {fmt} exited {returncode}: "
                     f"{stderr[-2000:]}")
            if flag == "--weight-format":
                pipe = TranscribePipeline.from_gguf(
                    gguf, tokenizer, config=cfg, weight_format=fmt,
                    device=dev)
            else:
                pipe = TranscribePipeline.from_model_dir(tmp, fmt,
                                                         device=dev)
            if flag == "--audio-list --batch-files 4":
                lines = pipe.transcribe_files_batched(wavs, batch_size=4)
            elif flag == "--timestamps":
                lines = [json.dumps({"file": str(wav),
                                     **pipe.transcribe_file_words(wav)})]
            else:
                lines = [pipe.transcribe_file(wav)]
            lib = "".join(f"{line}\n" for line in lines)
            if stdout != lib:
                fail(f"CLI {flag} {fmt} printed {stdout!r}, the library "
                     f"path {lib!r}")
            print(f"CLI {flag} {fmt}: exit 0 within {secs:.1f} s of the "
                  f"{len(procs)} starting together, {len(lines)} line(s) == "
                  f"library path ({len(lib.split())} words; route "
                  f"{pipe.model.decode_route}) [{card}]", flush=True)


# ---------------------------------------------------------------------------
# Dense weights (bf16 on K1 mode (g), f32 on the per-op step)
# ---------------------------------------------------------------------------

# The dense random tree draws its weights with this standard deviation
# (JAX's init_random: 0.02, whose streams emit two or three distinct
# tokens on this run's chirps): at 0.03 each pooled stream emits more
# than five, which the int8-against-bf16 cache check needs to say
# anything (ROADMAP §3).
DENSE_SCALE = 0.03
DENSE_PLAIN_SECS = 4.0         # the bf16 plain one-shot, held as a prefix
DENSE_STREAM_SECS = 10.0       # the bf16 unbounded session
DENSE_PLAIN_STREAM_SECS = 6.0  # ... and its plain twin, held as a prefix
F32_SECS = 4.0                 # the f32 one-shot (per-op, host-bound)
MIN_DISTINCT = 5               # tokens per stream of the int8 / bf16 pools


def check_dense_linear(dev, card) -> dict:
    """The dense bf16 linear (``models.layers.dense_matmul``): cuBLAS's
    bf16 GEMM, f32 sums rounded once to bf16, against the same product on
    f32 copies of both operands, at the one-shot's encoder and adapter
    shapes -> {shape: (bf16 GEMM ms, f32-copy ms)}."""
    import torch

    from voxtral_tpu_torch.models.layers import dense_matmul

    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for m, k, n in ((608, 1280, 5120), (608, 5120, 1280), (152, 5120, 3072),
                    (32, 1280, 5120)):
        x = torch.randn((m, k), device=dev, generator=gen).bfloat16()
        w = (torch.randn((k, n), device=dev, generator=gen) * 0.03).bfloat16()
        got = dense_matmul(x, w)
        ref = (x.float() @ w.float()).bfloat16()
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        if not rel <= KV_RTOL:
            fail(f"dense bf16 linear {m}x{k}x{n}: {rel:.3e} of max from the "
                 "f32 product > one bf16 ulp")
        ms, f32_ms = in_turns(lambda: dense_matmul(x, w),
                              lambda: (x.float() @ w.float()).bfloat16(),
                              20, 20)
        out[(m, k, n)] = (ms, f32_ms)
        print(f"dense bf16 linear M={m} K={k} N={n}: bf16 GEMM (f32 sums) "
              f"{ms:.4f} ms, on f32 copies {f32_ms:.4f} ms; outputs within "
              f"{rel:.2e} of max (bit-equal {torch.equal(got, ref)}) "
              f"[{card}]", flush=True)
    return out


def int8_against_bf16(runs, card, tag="dense pools",
                      held_streams=None) -> dict:
    """The int8-cache pool held against the bf16-cache pool on the dense
    tree: each stream emits at least MIN_DISTINCT distinct tokens; the
    two agree over each slot's first step (its per-op init, bf16 in
    both); up to their first parting their top-2 margins differ by some
    amount g, and they part only where the bf16 pool's margin is below
    2 g (the int8 cache moves the logits by about g; a parting at a
    larger margin would be a fault, not a tie).  ``held_streams``: a
    stream that parts at its first cache read has no agreeing decoded
    token to measure its g on and is reported, not held; at least that
    many streams must agree past their first step (None: every one)."""
    out = {"agree": [], "first": [], "gap": [], "distinct": [], "held": 0}
    for a, b, ma, mb in zip(runs["int8"]["tokens"], runs["model"]["tokens"],
                            runs["int8"]["margins"], runs["model"]["margins"]):
        n = min(len(a), len(b))
        distinct = len(set(b.tolist()))
        if distinct < MIN_DISTINCT or len(set(a.tolist())) < MIN_DISTINCT:
            fail(f"{tag}: a stream emits {distinct} distinct tokens "
                 f"(int8: {len(set(a.tolist()))}) < {MIN_DISTINCT}")
        differ = np.nonzero(a[:n] != b[:n])[0]
        first = int(differ[0]) if len(differ) else n
        if first < P_STEP:
            fail(f"{tag}: int8 and bf16 caches part at token {first}, "
                 "inside the first step (no cache read there)")
        gap = float(np.abs(ma[:first] - mb[:first]).max())
        if first > P_STEP or held_streams is None:
            out["held"] += 1
            if first < n and not float(mb[first]) < 2 * gap:
                fail(f"{tag}: int8 and bf16 caches part at token {first} "
                     f"at a bf16 margin {float(mb[first]):.3e} >= 2 x the "
                     f"margin gap before it ({gap:.3e})")
        out["agree"].append(round(float((a[:n] == b[:n]).mean()), 4))
        out["first"].append(first if first < n else -1)
        out["gap"].append(gap)
        out["distinct"].append(distinct)
    if held_streams is not None and out["held"] < held_streams:
        fail(f"{tag}: {out['held']} streams agree past their first step, "
             f"fewer than {held_streams} (first partings {out['first']})")
    print(f"{tag}, int8 vs bf16 caches (weight scale {DENSE_SCALE}): "
          f"distinct tokens per stream {out['distinct']}; token agreement "
          f"{out['agree']}, first parting {out['first']} (-1: none); "
          f"{out['held']} streams agree past their first step, each "
          f"parting at a bf16 margin below twice the top-2 margin gap "
          f"before it ({[f'{g:.3e}' for g in out['gap']]}) [{card}]",
          flush=True)
    return out


def run_dense(cfg, dev, card, sig, tok):
    """Phase 11: dense weights.  11a: bf16 on K1 mode (g) (memory-neutral
    fuse, K1 (g) alone, one-shot, an unbounded session, B = 2 pools on
    both cache types); 11c: f32 on the per-op step.  (11b, ``--model``
    through the CLI, runs beside the GGUF CLI in phase 7.)"""
    import torch

    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline
    from voxtral_tpu_torch.utils.hbm import model_hbm_bytes, tree_unique_bytes
    from voxtral_tpu_torch.utils.quantize import random_dense_params

    release()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = random_dense_params(cfg, 0, torch.bfloat16, dev,
                                 scale=DENSE_SCALE)
    tree_b = tree_unique_bytes(params)
    model = VoxtralModel(params, cfg, dev)
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated(dev) - base
    if model.decode_route != "bf16":
        fail(f"dense bf16 weights route to {model.decode_route}")
    if not abs(built - tree_b) <= 0.01 * tree_b:
        fail(f"the bf16 fuse is not memory-neutral: {built} bytes allocated "
             f"for a {tree_b}-byte tree")
    # Admission counts the tree and the fused dict's f32 norm stacks.
    if not 0 <= model_hbm_bytes(model) - tree_b <= 0.01 * tree_b:
        fail(f"admission counts {model_hbm_bytes(model)} bytes of weights, "
             f"the tree holds {tree_b}")
    print(f"random bf16 dense weights (seed 0, scale {DENSE_SCALE}) built on "
          f"the card and fused: {time.perf_counter() - t0:.1f} s; tree "
          f"{tree_b / 1e9:.4f} GB, memory_allocated after the build "
          f"{built / 1e9:.4f} GB ({100 * (built - tree_b) / tree_b:+.3f} %),"
          f" admission counts {model_hbm_bytes(model) / 1e9:.4f} GB [{card}]",
          flush=True)
    plain = VoxtralModel(params, cfg, dev, kernels=False)
    plain.fused_decode = model.fused_decode
    linear = check_dense_linear(dev, card)

    k1g = check_k1_modes(model, dev, card)
    ring, S = ring_geometry(cfg.language_model)
    k1g["d"] = kv_step_case(model, dev, card, "(g) x (d)", S, [16000], 1,
                            ring, False, None)
    k1g["e"] = kv_step_case(model, dev, card, "(g) x (e) x (c)", S,
                            POOL_OFFS, 1, ring, True, None)
    k1g["f"] = kv_step_case(model, dev, card, "(g) x (f)", 1536, [7, 700],
                            1, None, False, 512, slice(1024, 1536))
    k1g["err"] = max(k1g["err"], *(k1g[m][0] for m in "def"))

    pipe = TranscribePipeline(model, tok)
    wall, launches, peak, chunks = counted_run(pipe, sig, dev)
    tokens = chunks[0]
    n_tok = len(tokens)
    n_steps = n_tok - 1
    if launches["decode_stack_step"] != n_steps or launches["w8_matmul"]:
        fail(f"bf16 one-shot: launches {launches}, {n_steps} decode steps")
    model.record_margins = True
    pipe._chunk_tokens(sig, SR)
    margins = model.last_margins[0].copy()
    model.record_margins = False
    pcfg = PipelineConfig(speculative=SPEC_K, draft="ngram")
    spipe = TranscribePipeline(model, tok, pcfg)
    s_wall, s_launch, s_peak, s_chunks = counted_run(spipe, sig, dev)
    passes = model.last_spec_passes
    if s_launch["decode_stack_step"] != passes or passes < 1:
        fail(f"bf16 speculative: K1 launches {s_launch['decode_stack_step']} "
             f"!= passes {passes}")
    same_seq = first_divergence("bf16 speculative vs sequential",
                                s_chunks[0], tokens, margins,
                                SPEC_MARGIN_TIE)
    part = sig[:int(DENSE_PLAIN_SECS * SR)]
    k_part = pipe._chunk_tokens(part, SR)[0]
    p_part, p_margins = plain_tokens(plain, tok, part)
    same_plain = first_divergence("bf16 sequential kernel vs plain", k_part,
                                  p_part, p_margins, MARGIN_TIE)
    print(f"bf16 main path: launch counts {launches}; {n_tok} tokens "
          f"({len(set(tokens.tolist()))} distinct); speculative K={SPEC_K} "
          f"ngram: {passes} passes, tokens == sequential {same_seq}; "
          f"sequential kernel == plain over {DENSE_PLAIN_SECS:.0f} s "
          f"({len(k_part)} tokens): {same_plain} [{card}]", flush=True)
    padded = pipe.padded_chunks(sig, SR)[0].samples
    enc_s = encode_seconds(pipe, model, padded)
    report("bf16", wall, enc_s, n_tok, peak, card)
    report(f"bf16 speculative K={SPEC_K} draft=ngram", s_wall, enc_s, n_tok,
           s_peak, card, passes, n_steps, k1g["spec8"][1])
    step_bytes = step_weight_bytes(model)
    print(f"bf16 decode step weight stream: {step_bytes / 1e9:.4f} GB/step / "
          f"{k1g['one'][1]:.3f} ms = {step_bytes / k1g['one'][1] / 1e6:.1f} "
          f"GB/s; bound {step_bytes / HBM_BPS * 1e3:.4f} ms [{card}]",
          flush=True)

    pieces = ragged_pieces(stream_signal(DENSE_STREAM_SECS))
    st = stream_run(model, pieces, dev, unbounded=True)
    check_stream_launches("bf16 unbounded session", st, "bf16")
    st_ref = plain_stream(plain, pieces, dev, secs=DENSE_PLAIN_STREAM_SECS,
                          unbounded=True)
    n = len(st_ref["tokens"])
    if n < P_STEP:
        fail(f"bf16 plain session: only {n} tokens")
    st_same = first_divergence("bf16 session kernel vs plain",
                               st["tokens"][:n], st_ref["tokens"],
                               st_ref["margins"], MARGIN_TIE)
    print(f"bf16 unbounded session: tokens kernel == plain over "
          f"{DENSE_PLAIN_STREAM_SECS:.0f} s ({n} tokens): {st_same} [{card}]",
          flush=True)
    report_stream("bf16 session unbounded", st, card, model)

    short = [pool_signal(POOL_SHORT_SECS, i) for i in (5, 6)]
    pools, paths = {}, {}
    for kv in ("model", "int8"):
        tag = f"bf16 pool B=2 unbounded kv_dtype={kv}"
        pair = pool_pair(tag, model, plain, dev, card, short,
                         plain_ticks=SHORT_PLAIN_TICKS, unbounded=True,
                         kv_dtype=kv)
        if pair["run"]["int8"] != (kv == "int8"):
            fail(f"{tag}: the ladder picked int8 {pair['run']['int8']}")
        report_pool(tag, pair["run"], card, model)
        pools[kv] = pair["run"]
        paths[f"bf16_pool_unbounded_{kv}"] = pair["run"]["launches"]
    kv_check = int8_against_bf16(pools, card)
    release()
    k1g["err"] = max(k1g["err"], check_k1_pool_geometries(model, dev, card))
    del pipe, spipe
    release()
    mesh = run_dense_mesh(model, plain, dev, card, sig, tok)
    del model, plain, params
    release()

    base = torch.cuda.memory_allocated(dev)
    params = random_dense_params(cfg, 0, torch.float32, dev,
                                 scale=DENSE_SCALE)
    f32_b = tree_unique_bytes(params)
    model = VoxtralModel(params, cfg, dev)
    if model.decode_route != "per_op" or model.cache_dtype != torch.float32:
        fail(f"f32 weights route to {model.decode_route}, cache "
             f"{model.cache_dtype}")
    clip = sig[:int(F32_SECS * SR)]
    pipe = TranscribePipeline(model, tok)
    f_wall, f_launch, f_peak, f_chunks = counted_run(pipe, clip, dev)
    if any(f_launch.values()):
        fail(f"f32 one-shot launched a kernel: {f_launch}")
    padded = pipe.padded_chunks(clip, SR)[0].samples
    f_tok = model.decoder_seq_len(pipe.mel.num_frames(len(padded))) - 38
    if len(f_chunks[0]) != f_tok:
        fail(f"f32: {len(f_chunks[0])} tokens != {f_tok}")
    print(f"f32 dense weights: tree {f32_b / 1e9:.4f} GB, allocated "
          f"{(torch.cuda.memory_allocated(dev) - base) / 1e9:.4f} GB; "
          f"{f_tok} tokens ({len(set(f_chunks[0].tolist()))} distinct) "
          f"[{card}]", flush=True)
    report("f32 (per-op)", f_wall, encode_seconds(pipe, model, padded), f_tok,
           f_peak, card, secs=F32_SECS)
    del model, params, pipe
    release()
    runs = {"bf16_sequential": launches,
            "bf16_speculative_ngram": s_launch,
            "bf16_stream_unbounded": st["launches"], **paths,
            **mesh["launches"], "f32_sequential": f_launch}
    return dict(k1=k1g, runs=runs, linear=linear, kv_check=kv_check,
                tree_bytes=tree_b, built_bytes=built, mesh=mesh)


# Phase 11d: bf16 on a data-parallel mesh, K1 mode (i) over the bf16 table.
DENSE_MESH_ROWS = (1, SPEC_K, 12)  # 12 rows: two table passes, two ties
DENSE_MESH_STREAM_SECS = 8.0       # the dp = 2 session
DENSE_MESH_POOL_SECS = 6.0         # each stream of the B = 4 dp = 2 pools
DENSE_MESH_PLAIN_TICKS = 2         # the plain side of each pool, a prefix


def run_dense_mesh(model, plain, dev, card, sig, tok):
    """Phase 11d, on phase 11a's bf16 model (``plain`` its plain twin):
    K1 mode (i) over the bf16 table alone (check_k1_argmax at 1, SPEC_K
    and 12 rows); a dp = 2 mesh whose data groups share the card and the
    stacks (no copy); two chirps sequential and speculative=SPEC_K ngram
    (== the single card's batch exactly, K1 (i) twice a position); an
    unbounded session on the mesh (data group 0: == the single card's);
    B = 4 dp = 2 pools of four chirps started together on the bf16 and
    the int8 cache, each == the single card's pool exactly and held to
    the plain versions over its first ticks; a dp pool slot restored on
    one device.  With two cards or more, the dp = 2 mesh over cards of
    their own (phase 13b) -> times and launches."""
    import torch

    from voxtral_tpu_torch.pipeline import TranscribePipeline
    from voxtral_tpu_torch.utils.hbm import shard_weight_bytes, tree_unique_bytes

    t0 = time.perf_counter()
    cfg, params = model.config, model.params
    k1i_err, k1i_times = check_k1_argmax(model, dev, card, DENSE_MESH_ROWS)
    release()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    dp = mesh_model(params, cfg, dev, 2, 1)
    dp_plain = mesh_model(params, cfg, dev, 2, 1, kernels=False)
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated(dev) - before
    tree_b = tree_unique_bytes(params)
    if dp.decode_route != "bf16" or dp.fused_tp is not None:
        fail(f"bf16 dp=2: route {dp.decode_route}")
    if not added <= 0.01 * tree_b:
        fail(f"bf16 dp=2 on one card copied its stacks: {added} bytes "
             f"allocated beside a {tree_b}-byte tree")
    print(f"bf16 dp=2 on one card: two models built beside the tree with "
          f"{added / 1e6:.3f} MB allocated (the groups share the stacks); "
          f"admission holds data group 1 to "
          f"{shard_weight_bytes(dp, 1, 0) / 1e9:.4f} GB of its own stacks "
          f"[{card}]", flush=True)

    pipe = TranscribePipeline(model, tok)
    mel2 = np.concatenate([
        pipe.mel.compute_log_batch(pipe.padded_chunks(s, SR)[0].samples)
        for s in (sig, pool_signal(AUDIO_SECS, 3))])
    model.record_margins = True
    try:
        ref2 = model.transcribe_streaming_batch(mel2)
        ref2_margins = model.last_margins
    finally:
        model.record_margins = False
    run = mesh_runs("bf16 dp=2 (one card)", dp, mel2, dev, card,
                    ref2_margins)
    if run["seq"].tolist() != ref2.tolist():
        fail("bf16 dp=2 tokens != the single card's batch")
    k1i = 2 * run["steps"]
    for key in ("decode_stack_step_lm_argmax",
                "decode_stack_step_lm_argmax_bf16"):
        if run["launches"][key] != k1i:
            fail(f"bf16 dp=2: {key} launches {run['launches'][key]} != "
                 f"{k1i} (two a position)")
        if run["spec_launches"][key] != 2 * run["passes"]:
            fail(f"bf16 dp=2 speculative: {key} launches "
                 f"{run['spec_launches'][key]} != 2 x {run['passes']} "
                 "passes")
    print(f"bf16 dp=2 == the single card's batch of two chirps exactly; "
          f"K1 (i) bf16 launches {k1i} ({run['steps']} positions x 2 data "
          f"groups), {run['spec_launches']['decode_stack_step_lm_argmax']} "
          f"in the speculative run ({run['passes']} passes) [{card}]",
          flush=True)
    launches = {"bf16_dp2_sequential": run["launches"],
                "bf16_dp2_speculative_ngram": run["spec_launches"]}
    del pipe
    release()

    pieces = ragged_pieces(sig[:int(DENSE_MESH_STREAM_SECS * SR)])
    ses = stream_run(dp, pieces, dev, unbounded=True)
    one = stream_run(model, pieces, dev, unbounded=True)
    if ses["tokens"].tolist() != one["tokens"].tolist():
        fail("bf16 dp=2 session != the single card's session")
    check_stream_launches("bf16 dp=2 unbounded session", ses, "bf16")
    print(f"bf16 dp=2 unbounded session on {DENSE_MESH_STREAM_SECS:.0f} s "
          f"(data group 0): {len(ses['tokens'])} tokens == the single "
          f"card's [{card}]", flush=True)
    report_stream("bf16 dp=2 session unbounded (one card)", ses, card, model)
    launches["bf16_dp2_stream_unbounded"] = ses["launches"]
    del ses, one
    release()

    signals = [pool_signal(DENSE_MESH_POOL_SECS, i) for i in range(4)]
    for kv in ("model", "int8"):
        tag = f"bf16 pool B=4 dp=2 kv_dtype={kv} (one card)"
        kw = dict(together=True, unbounded=True, kv_dtype=kv)
        got = pool_run(dp, dev, signals, **kw)
        dp_plain.record_margins = True
        try:
            ref = pool_run(dp_plain, dev, signals,
                           max_ticks=DENSE_MESH_PLAIN_TICKS, **kw)
        finally:
            dp_plain.record_margins = False
        same = held_to(f"{tag} kernel vs plain", got, ref, ref["margins"],
                       MARGIN_TIE)
        single = pool_run(model, dev, signals, **kw)
        if got["int8"] != (kv == "int8"):
            fail(f"{tag}: the ladder picked int8 {got['int8']}")
        if any(a.tolist() != b.tolist() for a, b in zip(got["tokens"],
                                                        single["tokens"])):
            fail(f"{tag}: tokens != the single card's pool")
        n_i = got["launches"]["decode_stack_step_lm_argmax_bf16"]
        if n_i < 1 or n_i != got["launches"]["decode_stack_step"]:
            fail(f"{tag}: launches {got['launches']}: every K1 step a mode "
                 "(i) one over the bf16 table")
        print(f"{tag}: tokens == the single card's pool exactly, == plain "
              f"over {DENSE_MESH_PLAIN_TICKS} ticks: {same}; launches "
              f"{got['launches']}; caches {got['cache_bytes'] / 1e9:.4f} "
              f"GB, peak GPU memory {got['peak_gb']:.3f} GB (single card "
              f"{single['peak_gb']:.3f}) [{card}]", flush=True)
        report_pool(tag, got, card, model)
        launches[f"bf16_dp2_pool_{kv}"] = got["launches"]
        del got, ref, single
        release()
    launches["bf16_dp2_checkpoint"] = mesh_checkpoint(model, plain, dp, dev,
                                                      card)
    del dp, dp_plain
    release()
    if torch.cuda.device_count() >= 2:
        run_mesh_cards(params, cfg, dev, card, tok, sig)
    print(f"phase 11d (bf16 dp=2 mesh): {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    return dict(k1i_err=k1i_err, k1i_times=k1i_times, launches=launches,
                ms_pos=run["ms_pos"], peak=run["peak"])


# ---------------------------------------------------------------------------
# Batched one-shot (w8): K7, the per-layer route, the merge cost
# ---------------------------------------------------------------------------
# Phase 13: the meshed one-shot path (tp = 2, dp = 2, 2 x 2 on one card)
# ---------------------------------------------------------------------------

MESH_PLAIN_SECS = 6.0  # the plain TP side, held as a prefix
MESH_LAYER = 25
# K4 at tp = 2 local shapes: (streams, rows a stream, S, offset of the
# first stream; the others 30 slots apart).  S = 194 at offset 187 is the
# largest one-shot cache; four streams of a row, a B = 4 pool's step.
K4_CASES = [(1, 1, 151, 150), (1, SPEC_K, 158, 143), (1, 1, 194, 187),
            (4, 1, 151, 150)]
K5_ROWS = (1, 4, SPEC_K)
MESH_ROWS = (1, SPEC_K)
K6_TIES = {"inside shard 0": ((0, 1000), (0, 5000)),
           "across the shards": ((0, 60000), (1, 10))}


def counted(fn, dev):
    """``fn()`` with every kernel's launch counter set to 0 just before
    and read just after -> (its result, wall s, {kernel: launches},
    peak GB).  ``decode_stack_step_lm_argmax`` counts K1's mode (i)
    launches, the ``_g32`` entries the g32 ones (stream_counters)."""
    import torch

    counters = stream_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in counters.items()}
    return out, wall, launches, torch.cuda.max_memory_allocated(dev) / 1e9


def mesh_model(params, cfg, dev, n_data, n_model, kernels=True):
    """A w8 model on a (data, model) mesh whose shards share the card."""
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data, n_model, [dev] * (n_data * n_model))
    return VoxtralModel(params, cfg, dev, kernels=kernels, mesh=mesh)


def timed_kernel(tag, kernel, plain, moved, ops, card):
    """Bit-equality of ``kernel()`` and ``plain()``, the device ms (CUDA
    graph), the host-called and plain ms, the bound -> (err, (device ms,
    plain ms, bound ms, bound by, host-called ms))."""
    import torch

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = max((g.float() - r.float()).abs().max().item()
              for g, r in zip(got, ref))
    if not err == 0.0:
        fail(f"{tag}: max_abs_err {err:.3e}: not bit-equal to the plain "
             "version")
    host_ms, plain_ms = in_turns(kernel, plain, 50, 2)
    ms = graph_ms(kernel)
    b_ms, b_by = bound(moved, ops, INT8_OPS)
    print(f"{tag}: max_abs_err {err:.3e} (bit-equal); kernel {ms:.4f} ms on "
          f"the device (CUDA graph), {host_ms:.4f} ms called from the host, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{100 * b_ms / ms:.1f} % of it) [{card}]", flush=True)
    return err, (ms, plain_ms, b_ms, b_by, host_ms)


def fmt_tag(model) -> str:
    """The weight format of the model's halves and folds in a tag: " g32"
    (q4g), " bf16" (K1 (i) over the bf16 table), or "" (w8)."""
    return {"q4g": " g32", "bf16": " bf16"}.get(model.decode_route, "")


def check_k4_k5(tp, dev, card):
    """K4 and K5 alone at tp = 2 local shapes (shard 0 of the model's TP
    stacks, layer MESH_LAYER; w8 or, on a q4g model, g32), bit for bit
    -> (err, {case: times})."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.ops import decode_tp as ktp

    cfg = tp.config.language_model
    w = {k: v[0][0] for k, v in tp.fused_tp.items()}
    nh, nkv = cfg.n_heads // 2, cfg.n_kv_heads // 2
    D, hd, layer = cfg.dim, cfg.head_dim, MESH_LAYER
    vecs = (w["sqkv"][layer], w["so"][layer])
    worst, times = 0.0, {}
    for streams, spec, S, off in K4_CASES:
        rows = streams * spec
        gen = torch.Generator(device=dev).manual_seed(31 + rows + S)
        kc = (torch.randn((streams, nkv, S, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        vc = (torch.randn((streams, nkv, S, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        x = torch.randn((rows, D), device=dev, generator=gen)
        if rows == 1:
            offs = off
            c, s = k1.rope_pair_vectors(off, hd, cfg.rope_theta, device=dev)
        else:
            offs = off - 30 * torch.arange(streams, dtype=torch.int32,
                                           device=dev)
            c, s = k1.rope_pair_vectors(
                (offs[:, None] + torch.arange(spec, device=dev)).reshape(-1),
                hd, cfg.rope_theta)
        args = (x, layer, offs, tp._tp_norms[0][layer], *vecs, c, s, kc, vc,
                w["wqkv"], w["wo"])
        kw = dict(n_heads_l=nh, n_kv_l=nkv, head_dim=hd, eps=cfg.norm_eps,
                  window=cfg.sliding_window, spec=spec)
        wl = (w["wqkv"][layer], w["wo"][layer])
        seen = sum(off - 30 * i for i in range(streams))
        moved = (nbytes(*wl, *vecs, tp._tp_norms[0][layer], c, s)
                 + 2 * nbytes(x) + 2 * seen * nkv * hd * 2
                 + 2 * rows * nkv * hd * 2)
        err, t = timed_kernel(
            f"K4 attn_half_step{fmt_tag(tp)} tp=2 rows={rows} "
            f"({streams} stream(s) x {spec}) S={S} offset={off}",
            lambda: ktp.attn_half_step(*args, **kw),
            lambda: ktp.attn_half_step_plain(*args, **kw), moved,
            2 * rows * sum(t.numel() for t in wl), card)
        worst, times[("K4", rows, S)] = max(worst, err), t
    ada = k1.ada_vectors(tp.params["decoder"], tp.t_embed(6.0))
    for rows in K5_ROWS:
        gen = torch.Generator(device=dev).manual_seed(41 + rows)
        x = torch.randn((rows, D), device=dev, generator=gen)
        args = (x, layer, tp._tp_norms[1][layer], ada[layer],
                w["s13"][layer], w["s2"][layer], w["w13"], w["w2"])
        wl = (w["w13"][layer], w["w2"][layer])
        moved = nbytes(*wl, *args[2:6]) + 2 * nbytes(x)
        err, t = timed_kernel(
            f"K5 ffn_half_step{fmt_tag(tp)} tp=2 rows={rows}",
            lambda: (ktp.ffn_half_step(*args, eps=cfg.norm_eps),),
            lambda: (ktp.ffn_half_step_plain(*args, eps=cfg.norm_eps),),
            moved, 2 * rows * sum(t.numel() for t in wl), card)
        worst, times[("K5", rows)] = max(worst, err), t
    return worst, times


def check_k6(tp, dev, card):
    """K6 alone on the model's two vocab shards at 1 and SPEC_K rows,
    bit for bit, timed on shard 0; then two copies of the table with a
    planted tie (K6_TIES: two equal dominant rows inside shard 0, and
    across the shards), every row's token the lowest global index of
    the tie, as tp_lm_head_token resolves it and as torch.argmax over
    the whole table's plain logits finds it -> (err, {rows: times}).
    On a q4g model the shards are g32 (f16 group scales [V_l, D/32]; a
    planted row takes the top scale in every group)."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.ops import decode_tp as ktp
    from voxtral_tpu_torch.ops.w8 import quantize_activations
    from voxtral_tpu_torch.ops.w8_kernel import w8_matmul_plain

    cfg = tp.config.language_model
    D, eps = cfg.dim, cfg.norm_eps
    # The model's two placed vocab shards [V_l, D] / [V_l].
    codes, scale = tp.fused_tp["lm_codes"][0], tp.fused_tp["lm_scale"][0]
    fnorm = tp.params["decoder"]["norm"].float().abs().contiguous()
    vl = codes[0].shape[0]
    top_scale = max(s.max() for s in scale) * 4
    worst, times = 0.0, {}
    for rows in MESH_ROWS:
        gen = torch.Generator(device=dev).manual_seed(51 + rows)
        x = torch.randn((rows, D), device=dev, generator=gen).abs()
        moved = nbytes(codes[0], scale[0], fnorm) + nbytes(x) + rows * 8
        err, t = timed_kernel(
            f"K6 lm_half_argmax{fmt_tag(tp)} tp=2 rows={rows} (vocab shard "
            f"of {vl})",
            lambda: ktp.lm_half_argmax(x, fnorm, scale[0], codes[0],
                                       eps=eps),
            lambda: ktp.lm_half_argmax_plain(x, fnorm, scale[0], codes[0],
                                             eps=eps),
            moved, 2 * rows * vl * D, card)
        worst, times[rows] = max(worst, err), t
        for name, tie in K6_TIES.items():
            c2 = [c.clone() for c in codes]
            s2 = [s.clone() for s in scale]
            top = torch.randint(1, 127, (D,), dtype=torch.int8, device=dev,
                                generator=gen)
            for shard, row in tie:
                c2[shard][row], s2[shard][row] = top, top_scale
            for shard in range(2):
                got = ktp.lm_half_argmax(x, fnorm, s2[shard], c2[shard],
                                         eps=eps)
                torch.cuda.synchronize()
                ref = ktp.lm_half_argmax_plain(x, fnorm, s2[shard],
                                               c2[shard], eps=eps)
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    fail(f"K6 with a tie {name}, shard {shard}: kernel != "
                         "plain")
            token = ktp.tp_lm_head_token(tp.parallel.mesh, x, fnorm, [c2],
                                         [s2], eps=eps).tolist()
            xq, sx = quantize_activations(k1._rms(x, fnorm, eps))
            matmul = (k1.g32_matmul_plain if fmt_tag(tp)
                      else w8_matmul_plain)
            full = matmul(xq, sx, torch.cat(c2), torch.cat(s2))
            want = min(shard * vl + row for shard, row in tie)
            if token != [want] * rows or full.argmax(-1).tolist() != token:
                fail(f"K6 tie {name}: tokens {token}, want {want} (plain "
                     f"argmax {full.argmax(-1).tolist()})")
            print(f"K6{fmt_tag(tp)} planted tie {name} at {rows} rows: "
                  f"token {want} on every row, == the plain argmax over the "
                  "whole table", flush=True)
            del c2, s2
    return worst, times


def plant_ties(table, tokens) -> dict:
    """Two ties planted in a dense table, in place: row 0's winner copied
    33 rows away (another 32-row tile of the fold), row 1's to its
    neighbour in its own tile -> {row: the token it must give, the lower
    index of the pair}."""
    want = {}
    for row, t in enumerate(tokens[:2]):
        dst = (t - 33 if t >= 33 else t + 33) if row == 0 else t ^ 1
        table[dst] = table[t]
        want[row] = min(t, dst)
    return want


def check_k1_argmax(model, dev, card, row_counts=MESH_ROWS):
    """K1 mode (i) alone at 1 row (offset 235) and SPEC_K rows (one
    stream), bit for bit against its plain version and equal to the
    argmax of mode (a)'s logits (on a q4g model: over the g32 table,
    mode (h)'s logits; on a bf16 model over the bf16 table, mode (g)'s).
    More than 8 rows take two table passes; there, on a bf16 model, two
    ties are planted in a copy of the table (plant_ties), each of which
    must give its lower index -> (err, {rows: times})."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    cfg = model.config.language_model
    fused = model.fused_decode
    L, D, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    ada = k1.ada_vectors(model.params["decoder"], model.t_embed(6.0))
    worst, times = 0.0, {}
    for rows in row_counts:
        S, off = 240 + rows - 1, 235
        gen = torch.Generator(device=dev).manual_seed(61 + rows)
        shape = (L, 1, cfg.n_kv_heads, S, hd)
        kc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
        vc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
        x = torch.randn((rows, D), device=dev, generator=gen)
        offs = torch.tensor([off], dtype=torch.int32, device=dev)
        c, s = k1.rope_pair_vectors(off + torch.arange(rows, device=dev),
                                    hd, cfg.rope_theta)
        args = (x, offs, fused["attn_norm"], fused["ffn_norm"], ada,
                fused["sqkv"], fused["so"], fused["s13"], fused["s2"], c, s,
                kc, vc, fused["wqkv"], fused["wo"], fused["w13"],
                fused["w2"], *lm_fold(model))
        kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
                  eps=cfg.norm_eps, window=cfg.sliding_window, spec=rows)
        tag = (f"K1 decode_stack_step mode (i) lm_argmax{fmt_tag(model)} "
               f"rows={rows}")
        planted = {}
        if rows > 8 and model.decode_route == "bf16":
            tokens = k1.decode_stack_step(*args, lm_argmax=True, **kw)[3]
            table = args[18].clone()
            planted = plant_ties(table, tokens[:, 0].tolist())
            args = (*args[:18], table, args[19])
        got = k1.decode_stack_step(*args, lm_argmax=True, **kw)
        logits = k1.decode_stack_step(*args, **kw)[3]
        torch.cuda.synchronize()
        ref = k1.decode_stack_step_plain(*args, lm_argmax=True, **kw)
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got, ref))
        if not err == 0.0 or got[3][:, 0].tolist() != logits.argmax(
                -1).tolist():
            fail(f"{tag}: max_abs_err {err:.3e}, tokens {got[3].tolist()} "
                 f"against the logits' argmax {logits.argmax(-1).tolist()}")
        if any(got[3][r, 0].item() != t for r, t in planted.items()):
            fail(f"{tag}: planted ties {planted}, tokens {got[3].tolist()}")
        ms, plain_ms = in_turns(
            lambda: k1.decode_stack_step(*args, lm_argmax=True, **kw),
            lambda: k1.decode_stack_step_plain(*args, lm_argmax=True, **kw),
            20, 1)
        dev_ms = graph_ms(
            lambda: k1.decode_stack_step(*args, lm_argmax=True, **kw), reps=5,
            iters=4)
        kv_read = 2 * L * cfg.n_kv_heads * off * hd * 2
        moved = (step_weight_bytes(model) + kv_read + 2 * nbytes(x)
                 + 2 * nbytes(got[1]) + rows * 4)
        b_ms, b_by = bound(moved, 2 * rows * (
            n_stack_weights(model) + lm_fold(model)[1].numel()),
            weight_ops_peak(model))
        times[rows] = (ms, plain_ms, b_ms, b_by, dev_ms)
        worst = max(worst, err)
        ties = (f", planted ties {planted} give their lower index"
                if planted else "")
        print(f"{tag}: bit-equal, tokens == the logits' argmax{ties}; kernel "
              f"{ms:.3f} ms called from the host, {dev_ms:.3f} ms on the "
              f"device (CUDA graph), plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {100 * b_ms / dev_ms:.1f} % of it) "
              f"[{card}]", flush=True)
    return worst, times


def mesh_runs(tag, model, mel2, dev, card, spec_tie_margins=None):
    """The model's two-row batch sequentially (decode log on) and with
    speculative=SPEC_K ngram drafts, each counted; speculative held to
    sequential row by row by the spec near-tie rule (first_divergence;
    spec_held on a q4g mesh) -> dict."""
    model.measure_decode, model.decode_log = True, []
    try:
        seq, wall, launches, peak = counted(
            lambda: model.transcribe_streaming_batch(mel2), dev)
        rec = model.decode_log[-1]
    finally:
        model.measure_decode = False
    spec, s_wall, s_launches, _ = counted(
        lambda: model.transcribe_streaming_batch(mel2, speculative=SPEC_K),
        dev)
    passes = model.last_spec_passes
    ms_pos = rec["seconds"] * 1e3 / rec["steps"]
    print(f"{tag}, two 16 s chirps: sequential {wall:.3f} s (aggregate RTF "
          f"{wall / (2 * AUDIO_SECS):.5f}, decode {ms_pos:.3f} ms per "
          f"position), speculative K={SPEC_K} ngram {s_wall:.3f} s "
          f"({passes} passes); peak {peak:.3f} GB; launches {launches} "
          f"[{card}]", flush=True)
    if spec_tie_margins is not None and model.decode_route != "q4g":
        for r in range(len(seq)):
            first_divergence(f"{tag} speculative row {r} vs sequential",
                             spec[r], seq[r], spec_tie_margins[r],
                             SPEC_MARGIN_TIE)
    elif spec_tie_margins is not None:
        kept = []

        def spec_margins(r):
            # The speculative batch again with its top-2 margins (the
            # same tokens: the margins add the logits beside the folds).
            if not kept:
                model.record_margins = True
                try:
                    again = model.transcribe_streaming_batch(
                        mel2, speculative=SPEC_K)
                finally:
                    model.record_margins = False
                if again.tolist() != spec.tolist():
                    fail(f"{tag}: speculative tokens with margins kept "
                         "differ from the run without")
                kept.append(model.last_margins)
            return kept[0][r]

        for r in range(len(seq)):
            spec_held(f"{tag} speculative row {r} vs sequential", spec[r],
                      seq[r], spec_tie_margins[r],
                      lambda r=r: spec_margins(r))
    return dict(seq=seq, spec=spec, wall=wall, spec_wall=s_wall,
                launches=launches, spec_launches=s_launches, peak=peak,
                passes=passes, ms_pos=ms_pos, steps=rec["steps"])


def tp_against_single(tokens, margins, ref, ref_margins,
                      what="tp=2 parts from the single card"):
    """The TP tokens against the single-card w8 tokens (ROADMAP §3): up to
    their first parting the two runs' top-2 margins differ by some g (the
    shards' local quantization); they may part only where the single
    card's margin is below 2 g.  -> (agreeing positions, g, margin).
    The same rule holds a speculative run to the sequential one on a
    tree whose streams emit many tokens (``what`` names the pair)."""
    n = min(len(tokens), len(ref))
    same = np.asarray(tokens[:n]) == np.asarray(ref[:n])
    if same.all():
        gap = float(np.abs(margins[:n - 1] - ref_margins[:n - 1]).max())
        return n, gap, None
    i = int(np.argmin(same))
    gap = float(np.abs(margins[:i] - ref_margins[:i]).max()) if i else 0.0
    margin = float(ref_margins[i])
    if not margin < 2 * gap:
        fail(f"{what} at position {i} where the reference's top-2 margin "
             f"{margin:.4e} is not below twice the margin gap {gap:.4e} "
             "before it")
    return i, gap, margin


def spec_witness(fmt, plain, tok, head, spipe, p_head, p_margins, card):
    """On the plain prefix ``head`` of a tp = 2 mesh: the kernel
    speculative run held to the plain one by the kernel near-tie rule;
    then the witness for speculative parting from sequential: the plain
    speculative run with fresh_through_cache (each pass's rows one at a
    time, the earlier rows read back through the bf16 cache) held to the
    plain sequential run (``p_head`` / ``p_margins``) by the same rule,
    beside where the plain speculative run as it is parts from it."""
    from voxtral_tpu_torch.ops import decode_tp as tpk
    from voxtral_tpu_torch.pipeline import PipelineConfig

    pcfg = PipelineConfig(speculative=SPEC_K, draft="ngram")
    ks_head = spipe._chunk_tokens(head, SR)[0]
    ps_head, ps_margins = plain_tokens(plain, tok, head, pcfg)
    same_k = first_divergence(f"{fmt} tp=2 speculative kernel vs plain",
                              ks_head, ps_head, ps_margins, MARGIN_TIE)
    attn = tpk._attention_plain
    tpk._attention_plain = fresh_through_cache(attn)
    try:
        pw_head, pw_margins = plain_tokens(plain, tok, head, pcfg)
    finally:
        tpk._attention_plain = attn
    same_w = first_divergence(
        f"{fmt} tp=2 plain speculative with fresh rows through the bf16 "
        "cache vs plain sequential", pw_head, p_head, p_margins, MARGIN_TIE)
    n = min(len(pw_head), len(p_head))
    differ = np.nonzero(pw_head[:n] != p_head[:n])[0]
    n = int(differ[0]) if len(differ) else n
    gap = float(np.abs(pw_margins[:n] - p_margins[:n]).max())
    n = min(len(ps_head), len(p_head))
    differ = np.nonzero(ps_head[:n] != p_head[:n])[0]
    part = (f"parts from plain sequential at position {int(differ[0])}, "
            f"sequential margin {float(p_margins[differ[0]]):.4e}"
            if len(differ) else "== plain sequential")
    print(f"{fmt} tp=2 speculative on the plain prefix ({len(p_head)} "
          f"tokens): kernel == plain: {same_k}; plain speculative {part}; "
          f"with fresh rows through the bf16 cache == plain sequential: "
          f"{same_w}, top-2 margins differ by at most {gap:.3e} [{card}]",
          flush=True)


def mesh_oneshot(model, tp, dev, card, sig, tok, single, plain_secs,
                 single_plain=None):
    """The one-shot path on meshes whose shards share the card, for the
    model's weights (``model.decode_route``: w8, or q4g with the g32
    halves and folds): ``tp`` (tp = 2) on the 16 s chirp, sequential
    with the top-2 margins and speculative=SPEC_K ngram (held to
    sequential by the spec near-tie rule; on q4g after spec_witness, by
    spec_held), through the plain versions over its first
    ``plain_secs`` (the kernel near-tie rule), held to
    the single card (``single``: its tokens and margins) by ROADMAP §3's
    TP rule or, when the two part before any decoded token agrees, to
    ``single_plain`` with TP's quantization groups over the plain
    prefix; then two chirps at dp = 2 (== the single card's batch
    exactly, K1 mode (i) once per position and data group) and 2 x 2
    (== tp = 2 exactly) -> the phase's launches and runs."""
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline

    cfg, params = model.config, model.params
    fmt = model.decode_route
    g32 = fmt == "q4g"
    pipe = TranscribePipeline(tp, tok)
    tp.record_margins = True
    try:
        wall, launches, peak, chunks = counted_run(pipe, sig, dev)
        tp_margins = tp.last_margins[0].copy()
    finally:
        tp.record_margins = False
    tokens = chunks[0]
    steps = len(tokens) - 1
    if tp.last_decode_route != "tp":
        fail(f"{fmt} tp=2 route {tp.last_decode_route}")
    want = {"attn_half_step": 2 * 26 * steps, "ffn_half_step": 2 * 26 * steps,
            "lm_half_argmax": 2 * steps, "decode_stack_step": 0}
    # Every launch of a q4g mesh is a g32 one; a w8 mesh launches none.
    want.update({f"{k}_g32": n if g32 else 0 for k, n in want.items()
                 if k != "decode_stack_step"})
    if any(launches[k] != n for k, n in want.items()):
        fail(f"{fmt} tp=2 launches {launches}, want {want}")
    spipe = TranscribePipeline(tp, tok, PipelineConfig(speculative=SPEC_K,
                                                       draft="ngram"))
    s_wall, s_launches, _, s_chunks = counted_run(spipe, sig, dev)
    passes = tp.last_spec_passes
    if s_launches["attn_half_step"] != 2 * 26 * passes:
        fail(f"{fmt} tp=2 speculative: K4 launches "
             f"{s_launches['attn_half_step']} != 52 x {passes} passes")
    if not g32:
        same_spec = first_divergence(f"{fmt} tp=2 speculative vs sequential",
                                     s_chunks[0], tokens, tp_margins,
                                     SPEC_MARGIN_TIE)
    plain = mesh_model(params, cfg, dev, 1, 2, kernels=False)
    plain.fused_tp = tp.fused_tp
    release()
    head = sig[:int(plain_secs * SR)]
    k_head = pipe._chunk_tokens(head, SR)[0]
    p_head, p_margins = plain_tokens(plain, tok, head)
    same_plain = first_divergence(f"{fmt} tp=2 kernel vs plain", k_head,
                                  p_head, p_margins, MARGIN_TIE)
    if g32:
        def spec_margins():
            tp.record_margins = True
            try:
                again = spipe._chunk_tokens(sig, SR)[0]
            finally:
                tp.record_margins = False
            if again.tolist() != s_chunks[0].tolist():
                fail(f"{fmt} tp=2 speculative tokens with margins kept "
                     "differ from the run without")
            return tp.last_margins[0].copy()

        spec_witness(fmt, plain, tok, head, spipe, p_head, p_margins, card)
        same_spec = spec_held(f"{fmt} tp=2 speculative vs sequential",
                              s_chunks[0], tokens, tp_margins, spec_margins)
    n = min(len(tokens), len(single["tokens"]))
    same = np.asarray(tokens[:n]) == np.asarray(single["tokens"][:n])
    if same.all() or int(np.argmin(same)) > 1:
        agree, gap, part = tp_against_single(
            tokens, tp_margins, single["tokens"], single["margins"])
        rule = (f"against the single card: the first {agree} of "
                f"{len(tokens)} tokens agree, top-2 margin gap over them "
                f"{gap:.4e}, " + ("no parting" if part is None else
                                  f"single-card margin at the parting "
                                  f"{part:.4e}"))
    else:
        # No decoded token agrees to measure the margin gap on: hold
        # tp = 2 to the single card with TP's quantization groups.
        if single_plain is None:
            fail(f"{fmt} tp=2 parts from the single card at its first "
                 "decoded token")
        restore = tp_quant_groups(single_plain, 2)
        try:
            g_head, g_margins = plain_tokens(single_plain, tok, head)
        finally:
            restore()
        same_g = first_divergence(
            f"{fmt} tp=2 vs the single card with TP's quantization groups",
            k_head, g_head, g_margins, MARGIN_TIE)
        rule = (f"it parts from the single card at position "
                f"{int(np.argmin(same))}; == the plain single card with TP's "
                f"quantization groups over {plain_secs:.0f} s: {same_g}")
    enc_s = encode_seconds(pipe, tp, pipe.padded_chunks(sig, SR)[0].samples)
    print(f"{fmt} tp=2 on one card: tokens == plain over {plain_secs:.0f} s "
          f"({len(k_head)} tokens): {same_plain}; speculative == "
          f"sequential: {same_spec} ({passes} passes); {rule} [{card}]",
          flush=True)
    report(f"{fmt} tp=2 (one card)", wall, enc_s, len(tokens), peak, card)
    print(f"{fmt} tp=2 decode: {(wall - enc_s) * 1e3 / steps:.3f} ms per "
          f"position; speculative K={SPEC_K} ngram {s_wall:.3f} s, RTF "
          f"{s_wall / AUDIO_SECS:.5f} [{card}]", flush=True)
    del plain, spipe
    release()

    # Two chirps: dp = 2 (== the single card's batch exactly), tp = 2
    # and 2 x 2 (== tp = 2: a data axis adds no numerics).
    mels = [pipe.mel.compute_log_batch(pipe.padded_chunks(s, SR)[0].samples)
            for s in (sig, pool_signal(AUDIO_SECS, 3))]
    mel2 = np.concatenate(mels)
    model.record_margins = True
    ref2 = model.transcribe_streaming_batch(mel2)
    ref2_margins = model.last_margins
    model.record_margins = False
    tp.record_margins = True
    tp2 = tp.transcribe_streaming_batch(mel2)
    tp2_margins = tp.last_margins
    tp.record_margins = False
    runs = {}
    dp = mesh_model(params, cfg, dev, 2, 1)
    runs["dp2"] = mesh_runs(f"{fmt} dp=2 (one card)", dp, mel2, dev, card,
                            ref2_margins)
    if runs["dp2"]["seq"].tolist() != ref2.tolist():
        fail(f"{fmt} dp=2 tokens != the single card's batch")
    k1i = 2 * runs["dp2"]["steps"]
    if (runs["dp2"]["launches"]["decode_stack_step_lm_argmax"] != k1i
            or runs["dp2"]["launches"]["decode_stack_step_lm_argmax_g32"]
            != (k1i if g32 else 0)):
        fail(f"{fmt} dp=2: K1 (i) launches {runs['dp2']['launches']}")
    del dp
    release()
    dptp = mesh_model(params, cfg, dev, 2, 2)
    runs["dp2tp2"] = mesh_runs(f"{fmt} dp=2 x tp=2 (one card)", dptp, mel2,
                               dev, card, tp2_margins)
    if runs["dp2tp2"]["seq"].tolist() != tp2.tolist():
        fail(f"{fmt} 2 x 2 tokens != tp=2 on the same batch")
    k4n = 4 * 26 * runs["dp2tp2"]["steps"]
    if (runs["dp2tp2"]["launches"]["attn_half_step"] != k4n
            or runs["dp2tp2"]["launches"]["attn_half_step_g32"]
            != (k4n if g32 else 0)):
        fail(f"{fmt} 2 x 2: K4 launches {runs['dp2tp2']['launches']}")
    del dptp
    launches_all = {f"{fmt}_tp2_sequential": launches,
                    f"{fmt}_tp2_speculative_ngram": s_launches,
                    **{f"{fmt}_{k}_sequential": r["launches"]
                       for k, r in runs.items()},
                    **{f"{fmt}_{k}_speculative_ngram": r["spec_launches"]
                       for k, r in runs.items()}}
    release()
    return dict(launches=launches_all, tp_wall=wall, tp_peak=peak,
                runs=runs)


def run_mesh_w8(model, dev, card, sig, tok, single):
    """Phase 13: the four kernels alone, then the one-shot path on a
    tp = 2, a dp = 2 and a 2 x 2 mesh whose shards share the card."""
    cli = subprocess.Popen(
        [sys.executable, "-m", "voxtral_tpu_torch.cli", "--tp", "2",
         "--random-weights", "--dtype", "w8", "--audio", "unused.wav"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cfg, params = model.config, model.params
    k1i_err, k1i_times = check_k1_argmax(model, dev, card)
    tp = mesh_model(params, cfg, dev, 1, 2)
    k45_err, k45_times = check_k4_k5(tp, dev, card)
    k6_err, k6_times = check_k6(tp, dev, card)
    out = mesh_oneshot(model, tp, dev, card, sig, tok, single,
                       MESH_PLAIN_SECS)
    del tp
    _, err = cli.communicate(timeout=300)
    if cli.returncode != 2 or "needs 2 devices, found 1" not in err:
        fail(f"--tp 2 on one card: exit {cli.returncode}, {err[-300:]!r}")
    print(f"python -m voxtral_tpu_torch.cli --tp 2 on one card: exit 2, "
          f"{err.strip().splitlines()[-1]!r}", flush=True)
    release()
    return dict(k1i_err=k1i_err, k1i_times=k1i_times, k45_err=k45_err,
                k45_times=k45_times, k6_err=k6_err, k6_times=k6_times,
                **out)


def run_mesh_cards(params, cfg, dev, card, tok, sig):
    """Phase 13b, on a host with two cards or more, for the tree's weight
    format (w8, q4g: tp = 2, dp = 2, 2 x 2; bf16: dp = 2): each mesh
    that fits with every shard on a card of its own (``make_mesh`` over
    the cards), then the same shape with its shards sharing card 0, each
    model built alone beside its tree.  Two chirps, sequential and
    speculative=SPEC_K ngram: over the cards == shared, dp == the single
    card's batch.  Per card, the peak memory of the model's build, what
    it holds after, and the peak of the speculative run.  Live streams
    (an unbounded tp = 2 session; a B = 4 int8 pool on 2 x 2, or on
    dp = 2 for bf16) over the cards == on card 0.  Then, for w8 on four
    cards, ``python -m voxtral_tpu_torch.cli --tp 2 --dp 2`` on a wav of
    the chirp exits 0."""
    import torch

    from voxtral_tpu_torch.audio import AudioBuffer, save_wav
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.parallel import make_mesh
    from voxtral_tpu_torch.pipeline import TranscribePipeline
    from voxtral_tpu_torch.utils.hbm import model_hbm_bytes

    cards = range(torch.cuda.device_count())

    def sync_all():
        for i in cards:
            torch.cuda.synchronize(i)

    single = VoxtralModel(params, cfg, dev)
    fmt = single.decode_route
    dense = fmt == "bf16"  # the data axis only (ROADMAP item 12.3b)
    pipe = TranscribePipeline(single, tok)
    mel2 = np.concatenate([
        pipe.mel.compute_log_batch(pipe.padded_chunks(s, SR)[0].samples)
        for s in (sig, pool_signal(AUDIO_SECS, 3))])
    ref2 = single.transcribe_streaming_batch(mel2)
    del single, pipe
    release()
    for nd, nm in ((2, 1),) if dense else ((1, 2), (2, 1), (2, 2)):
        n = nd * nm
        if n > len(cards):
            print(f"mesh {nd} x {nm} over cards of their own: not run "
                  f"({len(cards)} cards)", flush=True)
            continue
        got = {}
        for where, devices in (("own cards", None), ("card 0", [dev] * n)):
            sync_all()
            for i in cards:
                torch.cuda.reset_peak_memory_stats(i)
            model = VoxtralModel(params, cfg, dev,
                                 mesh=make_mesh(nd, nm, devices))
            sync_all()

            def per_card(read):
                return ", ".join(f"cuda:{i} {read(i) / 1e9:.3f}"
                                 for i in cards)

            built = per_card(torch.cuda.max_memory_allocated)
            held = per_card(torch.cuda.memory_allocated)
            # The decode log resets card 0's peak at its loop's start: the
            # run's peak is read around the speculative run (the larger
            # cache) without it.
            model.measure_decode, model.decode_log = True, []
            t0 = time.perf_counter()
            seq = model.transcribe_streaming_batch(mel2)
            sync_all()
            wall = time.perf_counter() - t0
            rec = model.decode_log[-1]
            model.measure_decode = False
            for i in cards:
                torch.cuda.reset_peak_memory_stats(i)
            spec = model.transcribe_streaming_batch(mel2,
                                                    speculative=SPEC_K)
            sync_all()
            peaks = per_card(torch.cuda.max_memory_allocated)
            print(f"{fmt} dp={nd} x tp={nm}, shards on {where} "
                  f"({model.parallel.mesh.devices}), two 16 s chirps: "
                  f"sequential {wall:.3f} s, decode "
                  f"{rec['seconds'] * 1e3 / rec['steps']:.3f} ms per "
                  f"position; speculative == sequential: "
                  f"{spec.tolist() == seq.tolist()}; weights held "
                  f"{model_hbm_bytes(model) / 1e9:.3f} GB over all cards; "
                  f"GB per card: peak of the build {built}, held after it "
                  f"{held}, peak of the speculative run {peaks} [{card}]",
                  flush=True)
            got[where] = (seq.tolist(), spec.tolist())
            del model
            release()
        if got["own cards"] != got["card 0"]:
            fail(f"{fmt} {nd} x {nm}: tokens over cards of their own != "
                 "the same mesh on card 0")
        if nm == 1 and got["own cards"][0] != ref2.tolist():
            fail(f"{fmt} dp={nd} over cards of their own != the single "
                 "card")
        print(f"{fmt} dp={nd} x tp={nm}: tokens over cards of their own == "
              "the mesh on card 0, sequential and speculative"
              + (", == the single card's batch" if nm == 1 else ""),
              flush=True)
    # Live streams over cards of their own against card 0.
    pieces = ragged_pieces(sig)
    signals = [pool_signal(POOL_SHORT_SECS, i) for i in range(4)]
    for nd, nm in ((2, 1),) if dense else ((1, 2), (2, 2)):
        if nd * nm > len(cards):
            continue
        got = {}
        for where, devices in (("own cards", None), ("card 0",
                                                     [dev] * nd * nm)):
            model = VoxtralModel(params, cfg, dev,
                                 mesh=make_mesh(nd, nm, devices))
            if nd == 1:
                run = stream_run(model, pieces, dev, unbounded=True)
                got[where] = run["tokens"].tolist()
            else:
                run = pool_run(model, dev, signals, unbounded=True,
                               kv_dtype="int8")
                got[where] = [t.tolist() for t in run["tokens"]]
            sync_all()
            del model, run
            release()
        what = (f"the {fmt} unbounded tp=2 session" if nd == 1
                else f"the {fmt} {nd} x {nm} B=4 int8 pool")
        if got["own cards"] != got["card 0"]:
            fail(f"{what} over cards of their own != on card 0")
        print(f"{what} over cards of their own == on card 0 [{card}]",
              flush=True)
    if len(cards) < 4 or fmt != "w8":
        return
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "chirp.wav"
        save_wav(AudioBuffer(sig, SR), wav)
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "voxtral_tpu_torch.cli", "--tp", "2",
             "--dp", "2", "--random-weights", "--dtype", "w8", "--audio",
             str(wav)], capture_output=True, text=True, timeout=600)
    if cli.returncode != 0:
        fail(f"--tp 2 --dp 2 on {len(cards)} cards: exit {cli.returncode}, "
             f"{cli.stderr[-500:]!r}")
    print(f"python -m voxtral_tpu_torch.cli --tp 2 --dp 2 on "
          f"{len(cards)} cards: exit 0 in {time.perf_counter() - t0:.1f} s, "
          f"{len(cli.stdout.splitlines())} line(s) of text [{card}]",
          flush=True)


def mesh_cards_main() -> int:
    """Phase 13b alone, on a host with two cards or more:

        python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.mesh_cards_main())'

    The build and the trees of the full run, one after the other: w8
    (seed 0), q4g (random_q4_tree, seed 0), bf16 (seed 0, DENSE_SCALE);
    the same last line."""
    import torch

    from voxtral_tpu_torch import VoxtralConfig, VoxtralTokenizer
    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.ops import _build
    from voxtral_tpu_torch.utils.quantize import (
        random_dense_params,
        random_w8_params,
    )

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        fail("phase 13b needs two NVIDIA GPUs or more")
    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)
    lib, build_s = _build.build()
    _build.library()
    print(f"build: {build_s:.2f} s ({lib.name})", flush=True)
    cfg = VoxtralConfig.voxtral()
    tok = VoxtralTokenizer([None] * 131072, {}, 131072)
    t0 = time.perf_counter()
    for build in (lambda: params_from_numpy(random_w8_params(cfg, seed=0),
                                            dev),
                  lambda: params_from_numpy(random_q4_tree(cfg, seed=0), dev),
                  lambda: random_dense_params(cfg, 0, torch.bfloat16, dev,
                                              scale=DENSE_SCALE)):
        params = build()
        run_mesh_cards(params, cfg, dev, card, tok, chirp())
        del params
        release()
    print(f"phase 13b: {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 13c: live streaming on a mesh (tp = 2, dp = 2, 2 x 2 on one card)
# ---------------------------------------------------------------------------

MESH_STREAM_PLAIN_SECS = 4.0  # the plain TP session, held as a prefix
MESH_CHUNK_PLAIN_TICKS = 3    # the plain chunked TP pool, of its 7
MESH_CKPT_TICKS = 4           # a pooled stream's ticks before its snapshot
MESH_POOL_SECS = 6.0          # each stream of the meshed B = 4 pools
MESH_GROUPED_TICKS = 5        # the plain grouped single-card pool, of 8
# Streams of four whose int8 and bf16 pools must agree past the first
# step (their own margin gap then holds the parting).
MESH_INT8_HELD = 2
# K4 alone at tp = 2 in its cache modes: (tag, S, offsets, spec,
# ring, int8, chunk, dead slots).  The session's ring is (38, 8200); the
# chunked pools grow it to 17 chunks of 512; a bounded chunked cache of
# 1536 slots has its third chunk dead (NaN, never read).
K4_MODE_CASES = {
    "d": ("(d) head+ring", 8238, POOL_OFFS, 1, (38, 8200), False, None,
          None),
    "e": ("(e) int8", 8238, POOL_OFFS, 1, (38, 8200), True, None, None),
    "e_spec": ("(e) x (b) int8", 8238, [100, 8234, 8241, 16000], SPEC_K,
               (38, 8200), True, None, None),
    "f_bounded": ("(f) chunked", 1536, [7, 700], 1, None, False, 512,
                  slice(1024, 1536)),
    "f_ring": ("(f) chunked", 8704, [100, 16000], 1, (38, 8666), False, 512,
               None),
    "f_ring_int8": ("(f) x (e)", 8704, [100, 16000], 1, (38, 8666), True,
                    512, None),
}


def check_k4_modes(tp, dev, card, cases=None):
    """K4 alone in its cache modes (``cases``, K4_MODE_CASES by default)
    at tp = 2 local shapes (shard 0, layer MESH_LAYER; g32 on a q4g
    model): bit for bit with its plain version, timed from a CUDA graph
    and from the host, beside its bound: the layer's local weights once
    and, of the local cache, the slots some row sees (int8: codes and
    scales) -> (err, {name: times})."""
    import torch

    from voxtral_tpu_torch.models.layers import ring_k_positions
    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.ops import decode_tp as ktp

    cfg = tp.config.language_model
    w = {k: v[0][0] for k, v in tp.fused_tp.items()}
    nh, nkv = cfg.n_heads // 2, cfg.n_kv_heads // 2
    D, hd, layer, win = cfg.dim, cfg.head_dim, MESH_LAYER, cfg.sliding_window
    vecs = (tp._tp_norms[0][layer], w["sqkv"][layer], w["so"][layer])
    wl = (w["wqkv"][layer], w["wo"][layer])
    worst, times = 0.0, {}
    for name, (tag, S, offs, spec, ring, int8, chunk, dead) in \
            (cases or K4_MODE_CASES).items():
        bc = len(offs)
        gen = torch.Generator(device=dev).manual_seed(71 + bc * spec + S)
        kc = (torch.randn((bc, nkv, S, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        vc = (torch.randn((bc, nkv, S, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        scales = (None, None)
        if int8:
            (kc, ks), (vc, vs) = k1.quantize_kv(kc), k1.quantize_kv(vc)
            scales = (ks, vs)
        for t in (scales if int8 else (kc, vc)):
            if dead is not None:
                t[:, :, dead] = float("nan")
        x = torch.randn((bc * spec, D), device=dev, generator=gen)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        c, s = k1.rope_pair_vectors(
            (off[:, None] + torch.arange(spec, device=dev)).reshape(-1), hd,
            cfg.rope_theta)
        args = (x, layer, off, vecs[0], vecs[1], vecs[2], c, s, kc, vc,
                w["wqkv"], w["wo"], *scales)
        kw = dict(n_heads_l=nh, n_kv_l=nkv, head_dim=hd, eps=cfg.norm_eps,
                  window=win, spec=spec, ring=ring, cache_chunk=chunk)
        if not all(torch.isfinite(r.float()).all()
                   for r in ktp.attn_half_step_plain(*args, **kw)):
            fail(f"K4 {tag}: the plain version read a dead slot")
        seen = 0  # slots the first row of each stream sees
        for o in offs:
            if ring is None:
                seen += min(o, S) - max(0, o - win)
            else:
                p_abs, written = ring_k_positions(*ring, o, device=dev,
                                                  slots=S)
                seen += int((written & (o - p_abs <= win)).sum())
        per_slot = hd * (1 if int8 else 2) + (4 if int8 else 0)
        kv_read = 2 * nkv * seen * per_slot
        moved = (nbytes(*wl, *vecs, c, s) + 2 * nbytes(x) + kv_read
                 + 2 * bc * spec * nkv * hd * 2)
        err, t = timed_kernel(
            f"K4 attn_half_step{fmt_tag(tp)} {tag} tp=2 S={S} ring={ring} "
            f"offsets={offs} "
            f"spec={spec} cache_chunk={chunk} ({seen} cache slots read, "
            f"{kv_read / 1e6:.2f} MB)",
            lambda: ktp.attn_half_step(*args, **kw),
            lambda: ktp.attn_half_step_plain(*args, **kw), moved,
            2 * bc * spec * sum(t.numel() for t in wl), card)
        worst, times[name] = max(worst, err), t
        del kc, vc, scales, args
        torch.cuda.empty_cache()
    return worst, times


def tp_quant_groups(model, tp: int):
    """Give the single card's plain K1 step TP's quantization groups: the
    WO input (the attention output, n_heads x head_dim) and the W2 input
    (the SwiGLU row, hidden) quantized per model shard with that shard's
    own absmax, the shards' partial products summed in shard order as
    ``collectives.psum`` sums them; every other linear as it was.  A tp
    run and the single card's differ in those groups and nothing else,
    so the plain TP step and the grouped single card agree bit for bit:
    the second witness that a tp = 2 stream parts from the single card
    through the local absmax alone.  -> the function that restores
    ``ops.decode_step._linear_plain``."""
    from voxtral_tpu_torch.ops import decode_step as k1

    dim = model.config.language_model.dim
    orig = k1._linear_plain

    def grouped(h, w, scales, fmt):
        # WO and W2 are the step's only linears onto the residual width.
        if fmt not in ("w8", "g32") or w.shape[0] != dim:
            return orig(h, w, scales, fmt)
        n = h.shape[-1] // tp
        # w8 row scales are the shards' alike; a g32 shard takes its own
        # group columns.
        parts = [orig(h[:, i * n:(i + 1) * n], w[:, i * n:(i + 1) * n],
                      scales if fmt == "w8"
                      else scales[:, i * n // 32:(i + 1) * n // 32], fmt)
                 for i in range(tp)]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    k1._linear_plain = grouped

    def restore():
        k1._linear_plain = orig

    return restore


def tp_launches_ok(tag, launches, steps, n_layers):
    """A tp = 2 path's launches: K4 and K5 once per layer and shard per
    step, K6 once per shard, no K1."""
    want = {"attn_half_step": 2 * n_layers * steps,
            "ffn_half_step": 2 * n_layers * steps,
            "lm_half_argmax": 2 * steps, "decode_stack_step": 0}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"{tag}: launches {launches}, want {want}")


def apart(tokens, ref) -> tuple:
    """(share of equal tokens, first differing index or -1) of two runs
    over the shorter."""
    n = min(len(tokens), len(ref))
    differ = np.nonzero(np.asarray(tokens[:n]) != np.asarray(ref[:n]))[0]
    return (round(float((np.asarray(tokens[:n]) == np.asarray(ref[:n]))
                        .mean()), 4), int(differ[0]) if len(differ) else -1)


def tp_rule_runs(single, tp, dev, card, sig):
    """ROADMAP §3's TP rule for live streams, on the random w8 tree of
    phase 13: the unbounded tp = 2 session on the 16 s chirp and a B = 4
    tp = 2 pool against the single card's, stream by stream; the
    speculative tp = 2 session against the sequential one by the spec
    near-tie rule.  (On the dense-derived tree a tp = 2 stream parts
    from the single card at its first steady token already, with no
    agreeing decoded token to measure g on: there it is held to the
    single card with TP's quantization groups, ``tp_quant_groups``.)"""
    pieces = ragged_pieces(sig)
    signals = [pool_signal(MESH_POOL_SECS, i) for i in range(4)]
    single.record_margins = tp.record_margins = True
    try:
        ses = {n: stream_run(m, pieces, dev, unbounded=True)
               for n, m in (("single", single), ("tp", tp))}
        spec = stream_run(tp, pieces, dev, unbounded=True,
                          speculative=SPEC_K, draft="ngram")
        pools = {n: pool_run(m, dev, signals, unbounded=True,
                             kv_dtype="model")
                 for n, m in (("single", single), ("tp", tp))}
    finally:
        single.record_margins = tp.record_margins = False
    # Speculative against sequential on this tree: the spec near-tie
    # rule (ROADMAP §3).
    same_spec = first_divergence(
        "w8 tp=2 unbounded session speculative vs sequential (random tree)",
        spec["tokens"], ses["tp"]["tokens"], ses["tp"]["margins"],
        SPEC_MARGIN_TIE)
    tp_launches_ok("w8 tp=2 session speculative (random tree)",
                   spec["launches"], spec["spec"]["passes"],
                   tp.config.language_model.n_layers)
    held = [tp_against_single(ses["tp"]["tokens"], ses["tp"]["margins"],
                              ses["single"]["tokens"],
                              ses["single"]["margins"])]
    held += [tp_against_single(t, m, r, rm) for t, m, r, rm in zip(
        pools["tp"]["tokens"], pools["tp"]["margins"],
        pools["single"]["tokens"], pools["single"]["margins"])]
    print(f"TP rule on the random w8 tree: the unbounded tp=2 session and "
          f"the four streams of a B=4 tp=2 pool against the single card "
          f"(agreeing tokens, margin gap, single-card margin at a parting): "
          f"{[(a, round(g, 4), p) for a, g, p in held]}; the speculative="
          f"{SPEC_K} ngram tp=2 session == sequential: {same_spec} "
          f"({spec['spec']}) [{card}]", flush=True)
    return {"w8_mesh_stream_tp2_random_tree": ses["tp"]["launches"],
            "w8_mesh_stream_tp2_speculative_random_tree": spec["launches"],
            "w8_mesh_pool_tp2_random_tree": pools["tp"]["launches"]}


def mesh_session(single, single_plain, tp, plain, dev, card, sig):
    """The 16 s chirp in ragged pieces through an unbounded session on
    the tp = 2 mesh, sequential and speculative=SPEC_K ngram, beside the
    plain TP session's first MESH_STREAM_PLAIN_SECS; the single card's
    sessions (sequential and speculative) and, over the same first
    seconds, the plain single card with TP's quantization groups
    (``tp_quant_groups``), to which the kernel and plain TP sessions are
    held -> {name: run} (``single``: also the step's bound)."""
    pieces = ragged_pieces(sig)
    tp.record_margins = single.record_margins = True
    try:
        run = stream_run(tp, pieces, dev, unbounded=True)
        spec = stream_run(tp, pieces, dev, unbounded=True,
                          speculative=SPEC_K, draft="ngram")
        one = stream_run(single, pieces, dev, unbounded=True)
        one_spec = stream_run(single, pieces, dev, unbounded=True,
                              speculative=SPEC_K, draft="ngram")
    finally:
        tp.record_margins = single.record_margins = False
    pl = plain_stream(plain, pieces, dev, secs=MESH_STREAM_PLAIN_SECS,
                      unbounded=True)
    restore = tp_quant_groups(single_plain, 2)
    try:
        grouped = plain_stream(single_plain, pieces, dev,
                               secs=MESH_STREAM_PLAIN_SECS, unbounded=True)
    finally:
        restore()
    tag = "w8 tp=2 unbounded session (one card)"
    n_layers = tp.config.language_model.n_layers
    tp_launches_ok(tag, run["launches"], run["positions"] - 38 - P_STEP,
                   n_layers)
    tp_launches_ok(f"{tag} speculative", spec["launches"],
                   spec["spec"]["passes"], n_layers)
    n = len(pl["tokens"])
    if len(grouped["tokens"]) != n:
        fail(f"{tag}: the plain TP session took {n} tokens, the grouped "
             f"single card {len(grouped['tokens'])}")
    same_plain = first_divergence(f"{tag} kernel vs plain",
                                  run["tokens"][:n], pl["tokens"],
                                  pl["margins"], MARGIN_TIE)
    # TP against the single card: the second witness.  With TP's
    # quantization groups the single card's plain step is the plain TP
    # step's arithmetic, so both TP sessions are held to it by the kernel
    # near-tie rule; the single card as it is parts from them.
    same_grouped = [first_divergence(f"{tag} {name} vs the single card "
                                     "with TP's quantization groups",
                                     toks[:n], grouped["tokens"],
                                     grouped["margins"], MARGIN_TIE)
                    for name, toks in (("kernel", run["tokens"]),
                                       ("plain", pl["tokens"]))]
    grouped_gap = float(np.abs(pl["margins"] - grouped["margins"]).max())
    agree, part = apart(run["tokens"], one["tokens"])
    part_margin = float(one["margins"][part]) if part >= 0 else None
    # Speculative against sequential: the fresh rows' f32 (against the
    # cache's bf16) flips int8 activation codes, which 26 layers amplify
    # beyond SPEC_MARGIN_TIE on this tree, on the single card as on the
    # mesh (the single card's pair below); the pair is held by the
    # margin-gap rule here and by the spec near-tie rule on the random
    # tree (``tp_rule_runs``).
    spec_agree, spec_gap, spec_part = tp_against_single(
        spec["tokens"], spec["margins"], run["tokens"], run["margins"],
        f"{tag} speculative parts from sequential")
    one_agree, one_part = apart(one_spec["tokens"], one["tokens"])
    print(f"{tag}: {len(run['tokens'])} tokens "
          f"({len(set(run['tokens'].tolist()))} distinct); kernel == plain "
          f"over {n}: {same_plain}; kernel, plain == the single card with "
          f"TP's quantization groups over {n}: {same_grouped} (plain "
          f"margins differ by at most {grouped_gap:.3e}); against the "
          f"single card as it is: agreement {agree}, first parting {part} "
          f"(single-card margin there {part_margin}); speculative == "
          f"sequential: {spec_part is None} (the first {spec_agree} agree, "
          f"margin gap {spec_gap:.4e}; {spec['spec']}); the single card's "
          f"speculative against its sequential: agreement {one_agree}, "
          f"first parting {one_part} (margin there "
          f"{float(one['margins'][one_part]) if one_part >= 0 else None}) "
          f"[{card}]", flush=True)
    report_stream(tag, run, card, single)
    report_stream(f"{tag} speculative", spec, card, single)
    return dict(tp=run, spec=spec, plain=pl, grouped=grouped)


def mesh_pools(single, single_plain, tp, plain, dp, dptp, dev, card):
    """B = 4 pools of four MESH_POOL_SECS chirps started a tick apart:
    the single card's, tp = 2 with bf16 and int8 caches, dp = 2, 2 x 2,
    and over MESH_GROUPED_TICKS the plain single card's with TP's
    quantization groups, to which the tp = 2 pool is held; the chunked
    rung forced on a tp = 2 B = 2 pool, through the kernels and the plain
    versions -> ({name: run}, the int8 check)."""
    signals = [pool_signal(MESH_POOL_SECS, i) for i in range(4)]
    runs = {}
    for name, m, kv in (("single", single, "model"), ("tp2", tp, "model"),
                        ("tp2_int8", tp, "int8"), ("dp2", dp, "model"),
                        ("dp2tp2", dptp, "model")):
        m.record_margins = True
        try:
            runs[name] = pool_run(m, dev, signals, unbounded=True,
                                  kv_dtype=kv)
        finally:
            m.record_margins = False
        tag = f"w8 pool B=4 {name} kv_dtype={kv} (one card)"
        report_pool(tag, runs[name], card, single)
        print(f"{tag}: time to first text {runs[name]['first_ms']:.1f} ms "
              f"(the pump that ran the first slot's init), caches "
              f"{runs[name]['cache_bytes'] / 1e9:.4f} GB, peak GPU memory "
              f"{runs[name]['peak_gb']:.3f} GB, {runs[name]['wall']:.1f} s "
              f"[{card}]", flush=True)
    steps = sum(len(v) for v in runs["tp2"]["steps"].values())
    for name in ("tp2", "tp2_int8", "dp2tp2"):
        if runs[name]["launches"]["attn_half_step"] < 1 or \
                runs[name]["launches"]["decode_stack_step"]:
            fail(f"pool {name}: launches {runs[name]['launches']}")
    if runs["dp2"]["launches"]["decode_stack_step"] < 1 or \
            runs["dp2"]["launches"]["attn_half_step"]:
        fail(f"pool dp2: launches {runs['dp2']['launches']}")
    if any(a.tolist() != b.tolist() for a, b in zip(
            runs["dp2"]["tokens"], runs["single"]["tokens"])):
        fail("dp=2 pool tokens != the single card's pool")
    if any(a.tolist() != b.tolist() for a, b in zip(
            runs["dp2tp2"]["tokens"], runs["tp2"]["tokens"])):
        fail("2 x 2 pool tokens != the tp=2 pool")
    restore = tp_quant_groups(single_plain, 2)
    single_plain.record_margins = True
    try:
        grouped = pool_run(single_plain, dev, signals,
                           max_ticks=MESH_GROUPED_TICKS, unbounded=True,
                           kv_dtype="model")
    finally:
        single_plain.record_margins = False
        restore()
    same_grouped = held_to("w8 pool B=4 tp=2 vs the single card with TP's "
                           "quantization groups", runs["tp2"], grouped,
                           grouped["margins"], MARGIN_TIE)
    parts = [apart(t, r) for t, r in zip(runs["tp2"]["tokens"],
                                         runs["single"]["tokens"])]
    int8 = int8_against_bf16({"int8": runs["tp2_int8"],
                              "model": runs["tp2"]}, card,
                             "w8 tp=2 pools (dense-derived tree)",
                             held_streams=MESH_INT8_HELD)
    print(f"w8 pools on one card: dp=2 == the single card's, 2 x 2 == "
          f"tp=2, token for token; tp=2 == the plain single card with "
          f"TP's quantization groups over its first {MESH_GROUPED_TICKS} "
          f"ticks (kernel near-tie rule): {same_grouped}; tp=2 against "
          f"the single card as it is, per stream (token agreement, first "
          f"parting): {parts}; {steps} tp=2 pool steps [{card}]",
          flush=True)
    restore = force_chunked()
    try:
        short = [pool_signal(POOL_SHORT_SECS, i) for i in (5, 6)]
        pair = pool_pair("w8 tp=2 pool B=2 chunked", tp, plain, dev, card,
                         short, plain_ticks=MESH_CHUNK_PLAIN_TICKS,
                         unbounded=True)
    finally:
        restore()
    run = pair["run"]
    if run["chunk"] != 512 or not run["int8"]:
        fail(f"tp=2 chunked pool: chunk {run['chunk']}, int8 {run['int8']}")
    report_pool("w8 tp=2 pool B=2 chunked", run, card, single)
    runs["tp2_chunked"] = run
    return runs, int8


def mesh_checkpoint(single, single_plain, dptp, dev, card):
    """A slot of a meshed pool (2 x 2, or dp = 2) snapshotted after
    MESH_CKPT_TICKS ticks (its caches gathered from the shards) and
    restored as a solo
    session on one device, through the kernels and through the plain
    versions, each run to the stream's end: the tokens equal (the
    kernel near-tie rule on the plain margins) -> launches."""
    import torch

    from voxtral_tpu_torch.streaming import StreamingSession

    sig = pool_signal(POOL_SHORT_SECS, 1)
    cut = MESH_CKPT_TICKS * TICK
    counters = pool_counters_reset(dev)
    pool = make_pool(dptp, 2, unbounded=True, kv_dtype="model")
    a = StreamingSession(dptp, pool=pool)
    StreamingSession(dptp, pool=pool).feed(
        pool_signal(POOL_SHORT_SECS, 2)[:cut])
    a.feed(sig[:cut])
    state = a.state_dict()
    if state["dec_k"].shape[3] != dptp.config.language_model.n_kv_heads:
        fail(f"meshed checkpoint: decoder cache {state['dec_k'].shape}")
    out = {}
    for name, m in (("kernel", single), ("plain", single_plain)):
        m.record_margins = True
        try:
            solo = StreamingSession.restore(m, state)
            solo.feed(sig[cut:])
            solo.finish()
            torch.cuda.synchronize()
        finally:
            m.record_margins = False
        out[name] = (np.asarray(solo.tokens), np.asarray(solo.margins))
    launches = {n: fn.launches for n, fn in counters.items()}
    (tok, _), (ptok, pmarg) = out["kernel"], out["plain"]
    p0 = len(state["tokens"])
    same = first_divergence("meshed checkpoint restored, kernel vs plain",
                            tok[p0:], ptok[p0:], pmarg, MARGIN_TIE)
    plan = dptp.parallel
    print(f"{single.decode_route} {plan.dp} x {plan.tp} pool slot -> "
          f"state_dict at position {a.positions_done} (caches gathered from "
          f"its {plan.dp * plan.tp} shards) -> solo session on one "
          f"device, to the stream's end ({len(tok)} tokens): kernel == "
          f"plain: {same}; launches {launches} [{card}]", flush=True)
    del pool, a
    return launches


def run_mesh_streams(w8_model, dev, card, sig):
    """Phase 13c: K4 in its cache modes alone, then live streaming on
    tp = 2, dp = 2 and 2 x 2 meshes whose shards share the card, on a w8
    tree quantized from the dense DENSE_SCALE tree; the TP rule on the
    random w8 tree (``w8_model``'s)."""
    import torch

    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.utils.quantize import (
        quantize_params_w8,
        random_dense_params,
    )

    cfg = w8_model.config
    rnd_tp = mesh_model(w8_model.params, cfg, dev, 1, 2)
    rule = tp_rule_runs(w8_model, rnd_tp, dev, card, sig)
    del rnd_tp
    release()
    t0 = time.perf_counter()
    # A random w8 tree emits one distinct token per pooled stream; one
    # quantized (on the card) from the dense DENSE_SCALE tree emits many,
    # which the TP and int8 rules below need.
    tree = quantize_params_w8(random_dense_params(
        cfg, 0, torch.bfloat16, dev, scale=DENSE_SCALE))
    release()
    single = VoxtralModel(tree, cfg, dev)
    tp = mesh_model(tree, cfg, dev, 1, 2)
    plain = mesh_model(tree, cfg, dev, 1, 2, kernels=False)
    plain.fused_tp = tp.fused_tp
    release()
    print(f"w8 tree quantized on the card from the dense tree (scale "
          f"{DENSE_SCALE}), single-card and tp=2 models: "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    k4_err, k4_times = check_k4_modes(tp, dev, card)
    single_plain = VoxtralModel(tree, cfg, dev, kernels=False)
    single_plain.fused_decode = single.fused_decode
    sessions = mesh_session(single, single_plain, tp, plain, dev, card, sig)
    dp = mesh_model(tree, cfg, dev, 2, 1)
    dptp = mesh_model(tree, cfg, dev, 2, 2)
    pools, int8 = mesh_pools(single, single_plain, tp, plain, dp, dptp,
                             dev, card)
    ckpt = mesh_checkpoint(single, single_plain, dptp, dev, card)
    launches = {"w8_mesh_stream_tp2": sessions["tp"]["launches"],
                "w8_mesh_stream_tp2_speculative_ngram":
                    sessions["spec"]["launches"],
                **{f"w8_mesh_pool_{k}": r["launches"]
                   for k, r in pools.items() if k != "single"},
                "w8_mesh_checkpoint": ckpt, **rule}
    del single, single_plain, tp, plain, dp, dptp, tree
    release()
    return dict(k4_err=k4_err, k4_times=k4_times, sessions=sessions,
                pools=pools, int8=int8, launches=launches)


# Phase 13d: q4g (exact Q4_0) on a mesh, on phase 5's full-width random
# q4g tree.  K4 in g32 at four streams with their windows full: (d), (e)
# and (f) over a head+ring cache (K4_MODE_CASES' layout).
K4_G32_MODES = {
    "d": K4_MODE_CASES["d"],
    "e": K4_MODE_CASES["e"],
    "f": ("(f) chunked", 8704, POOL_OFFS, 1, (38, 8666), False, 512, None),
}
MESH_Q4G_PLAIN_SECS = 3.0    # the plain q4g TP one-shot, held as a prefix
MESH_Q4G_STREAM_SECS = 8.0   # the tp = 2 q4g session
MESH_Q4G_PLAIN_TICKS = 2     # the plain side of each q4g mesh pool
# (its four streams start together, so both ticks step all four)


def q4g_cli_start(directory: Path) -> tuple:
    """``--gguf ... --weight-format q4g`` on small_gguf with and without
    ``--tp 2``, started side by side: over the cards with two or more,
    else with ``--device cpu`` (on one card ``--tp 2`` exits 2, as the
    JAX CLI: phase 13) -> (the processes, small_gguf's files)."""
    import torch

    files = small_gguf(directory)
    gguf, tokenizer, params, wav = files
    where = [] if torch.cuda.device_count() >= 2 else ["--device", "cpu"]
    base = [sys.executable, "-m", "voxtral_tpu_torch.cli", "--gguf",
            str(gguf), "--tokenizer", str(tokenizer), "--params", str(params),
            "--weight-format", "q4g", "--audio", str(wav), *where]
    procs = {extra: subprocess.Popen(
        base + list(extra), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=Path(__file__).resolve().parent)
        for extra in ((), ("--tp", "2"))}
    return procs, files


def q4g_cli_finish(procs: dict, files: tuple, card: str) -> None:
    """Both CLI runs exit 0 with one line, the line of the library path
    on the same device or mesh (``TranscribePipeline.from_gguf(...,
    weight_format="q4g", mesh=)``); the tp = 2 tokens equal the one
    device's plain step with TP's quantization groups (the kernel
    near-tie rule on its margins; ROADMAP §3's second witness), and
    where the one device as it is parts from tp = 2 it is reported."""
    import torch

    from voxtral_tpu_torch.audio import load_wav
    from voxtral_tpu_torch.config import VoxtralConfig
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.parallel import make_mesh
    from voxtral_tpu_torch.pipeline import TranscribePipeline

    try:
        outs = {k: (*p.communicate(timeout=300), p.returncode)
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    cpu = torch.cuda.device_count() < 2
    where = "--device cpu" if cpu else "the cards"
    for extra, (out, err, code) in outs.items():
        if code != 0 or len(out.splitlines()) != 1:
            fail(f"CLI --gguf --weight-format q4g {' '.join(extra)} on "
                 f"{where}: exit {code}, {out!r}, {err[-1500:]}")
    gguf, tokenizer, params, wav = files
    cfg = VoxtralConfig.from_file(params)
    dev = torch.device("cpu" if cpu else "cuda:0")
    audio = load_wav(wav)
    runs = {}
    for extra, mesh in (((), None),
                        (("--tp", "2"), make_mesh(1, 2, [dev] * 2 if cpu
                                                  else None))):
        pipe = TranscribePipeline.from_gguf(
            gguf, tokenizer, config=cfg, weight_format="q4g",
            device=None if mesh is not None else dev, mesh=mesh)
        line = pipe.transcribe_file(wav)
        if outs[extra][0] != line + "\n":
            fail(f"CLI q4g {' '.join(extra)} printed {outs[extra][0]!r}, the "
                 f"library path {line!r}")
        runs[extra] = pipe._chunk_tokens(audio.samples, audio.sample_rate)[0]
        if extra == ():
            one = pipe
    plain = VoxtralModel(one.model.params, cfg, dev, kernels=False)
    restore = tp_quant_groups(plain, 2)
    plain.record_margins = True
    try:
        g_tokens = TranscribePipeline(plain, one.tokenizer)._chunk_tokens(
            audio.samples, audio.sample_rate)[0]
        g_margins = plain.last_margins[0].copy()
    finally:
        restore()
    tp_tokens = runs[("--tp", "2")]
    same = first_divergence("CLI q4g tp=2 vs one device with TP's "
                            "quantization groups", tp_tokens, g_tokens,
                            g_margins, MARGIN_TIE)
    print(f"CLI --gguf --weight-format q4g --tp 2 on {where}: exit 0, the "
          f"library path's line on the tp = 2 mesh ({len(tp_tokens)} "
          f"tokens); == one device with TP's quantization groups: {same}; "
          f"against one device as it is: {apart(tp_tokens, runs[()])} "
          f"(agreement, first parting) [{card}]", flush=True)


def mesh_q4g_streams(model, single_plain, tp, dev, card, sig):
    """Live q4g streams on meshes whose shards share the card, each run
    through the g32 kernels and held to the plain versions over a prefix
    (the kernel near-tie rule): an unbounded tp = 2 session on the
    chirp's first MESH_Q4G_STREAM_SECS, B = 4 tp = 2 pools of four
    MESH_POOL_SECS chirps started together on the bf16 and the int8
    cache, a dp = 2 pool; a 2 x 2 pool's slot restored on one device
    -> launches."""
    cfg, params = model.config, model.params
    n_layers = cfg.language_model.n_layers
    plain = mesh_model(params, cfg, dev, 1, 2, kernels=False)
    plain.fused_tp = tp.fused_tp
    release()
    pieces = ragged_pieces(sig[:int(MESH_Q4G_STREAM_SECS * SR)])
    tp.record_margins = True
    try:
        run = stream_run(tp, pieces, dev, unbounded=True)
    finally:
        tp.record_margins = False
    pl = plain_stream(plain, pieces, dev, secs=MESH_STREAM_PLAIN_SECS,
                      unbounded=True)
    tag = "q4g tp=2 unbounded session (one card)"
    n = len(pl["tokens"])
    same = first_divergence(f"{tag} kernel vs plain", run["tokens"][:n],
                            pl["tokens"], pl["margins"], MARGIN_TIE)
    tp_launches_ok(tag, run["launches"], run["positions"] - 38 - P_STEP,
                   n_layers)
    for name in ("attn_half_step", "ffn_half_step", "lm_half_argmax"):
        if run["launches"][f"{name}_g32"] != run["launches"][name]:
            fail(f"{tag}: {name} launches {run['launches']} not all g32")
    print(f"{tag}: {len(run['tokens'])} tokens "
          f"({len(set(run['tokens'].tolist()))} distinct); kernel == plain "
          f"over {n}: {same} [{card}]", flush=True)
    report_stream(tag, run, card, model)
    launches = {"q4g_mesh_stream_tp2": run["launches"]}
    signals = [pool_signal(MESH_POOL_SECS, i) for i in range(4)]
    dp = mesh_model(params, cfg, dev, 2, 1)
    dp_plain = mesh_model(params, cfg, dev, 2, 1, kernels=False)
    dp_plain._dp_stacks = dp._dp_stacks
    for name, m, ref, kv in (("tp2", tp, plain, "model"),
                             ("tp2_int8", tp, plain, "int8"),
                             ("dp2", dp, dp_plain, "model")):
        pair = pool_pair(f"q4g pool B=4 {name} kv_dtype={kv} (one card)", m,
                         ref, dev, card, signals,
                         plain_ticks=MESH_Q4G_PLAIN_TICKS, together=True,
                         unbounded=True, kv_dtype=kv)
        got = pair["run"]["launches"]
        key = "decode_stack_step" if name == "dp2" else "attn_half_step"
        if got[key] < 1 or (key == "attn_half_step"
                            and got["attn_half_step_g32"] != got[key]):
            fail(f"q4g pool {name}: launches {got}")
        launches[f"q4g_mesh_pool_{name}"] = got
    del dp, dp_plain, plain
    release()
    dptp = mesh_model(params, cfg, dev, 2, 2)
    launches["q4g_mesh_checkpoint"] = mesh_checkpoint(model, single_plain,
                                                      dptp, dev, card)
    del dptp
    release()
    return launches


def run_mesh_q4g(model, single_plain, dev, card, sig, tok, single):
    """Phase 13d: q4g on a mesh whose shards share the card, on phase 5's
    random q4g tree (``model``, ``single_plain`` its plain twin,
    ``single`` its tokens and margins on the chirp): K1 mode (i) over the
    g32 table, K4 (1 row, SPEC_K rows, (d) / (e) / (f)), K5 and K6 in g32
    alone, bit for bit; the one-shot path at tp = 2, dp = 2 and 2 x 2
    (mesh_oneshot); live streams (mesh_q4g_streams); the CLI."""
    with tempfile.TemporaryDirectory() as tmp:
        procs, files = q4g_cli_start(Path(tmp))
        try:
            cfg, params = model.config, model.params
            k1i_err, k1i_times = check_k1_argmax(model, dev, card)
            tp = mesh_model(params, cfg, dev, 1, 2)
            k45_err, k45_times = check_k4_k5(tp, dev, card)
            k4m_err, k4m_times = check_k4_modes(tp, dev, card, K4_G32_MODES)
            k6_err, k6_times = check_k6(tp, dev, card)
            out = mesh_oneshot(model, tp, dev, card, sig, tok, single,
                               MESH_Q4G_PLAIN_SECS, single_plain)
            out["launches"].update(mesh_q4g_streams(model, single_plain, tp,
                                                    dev, card, sig))
            del tp
            release()
        except BaseException:
            for p in procs.values():
                p.kill()
                p.wait()
            raise
        q4g_cli_finish(procs, files, card)
    return dict(k1i_err=k1i_err, k1i_times=k1i_times,
                k45_err=max(k45_err, k4m_err), k45_times=k45_times,
                k4m_times=k4m_times, k6_err=k6_err, k6_times=k6_times, **out)


# ---------------------------------------------------------------------------

# K7 alone at full width: (layer, rows, cache slots S, offset).  S = 151
# is a 16 s chunk's positions, S = 413 a 30 s chunk's (the longest
# one-shot chunk); the last case has the window full.
K7_CASES = ([(layer, rows, 151, off) for layer in (0, 25) for rows in (1, 8)
             for off in (40, 150)]
            + [(25, rows, 413, 412) for rows in (1, 8)]
            + [(25, 1, 8400, 8300)])
K7_TIMED = ((25, 1, 151, 150), (25, 8, 151, 150), (25, 1, 413, 412),
            (25, 1, 8400, 8300))
BATCH_SECS = (4.0, 6.0, 8.0, 8.0, 10.0, 12.0, 14.0, 16.0)
BATCH_PLAIN_SECS = 2.0   # the plain side: three buffers of this length
MERGE_SECS = 40.0        # chunks of 15 / 15 / 10 s at MERGE_MEL_FRAMES
MERGE_MEL_FRAMES = 1500
FIT_ROWS = (1, 2, 4, 8)  # the merge cost's decode fit
CHUNK_30S_SECS = 30.0    # the chunk whose rows the memory rungs are told in


def text_tokenizer():
    """Control ids 1 / 32 / 33 and "w<i> " for every text id, so a text
    says as much as its tokens."""
    from voxtral_tpu_torch.tokenizer import VoxtralTokenizer

    return VoxtralTokenizer(
        [f"w{i} ".encode() for i in range(131072 - 1000)],
        {1: "<s>", 32: "[STREAMING_PAD]", 33: "[STREAMING_WORD]"}, 131072)


def check_k7(model, dev, card):
    """K7 alone against its plain version at K7_CASES, bit for bit, timed
    at K7_TIMED beside its bound: called from the host (the wrapper's
    checks and allocations included) and replayed from a CUDA graph (the
    device alone) -> (max abs err, {(rows, S, offset): (device ms, plain
    ms, bound ms, bound by, host-called ms)})."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    cfg = model.config.language_model
    fused = model.fused_decode
    D, hd, n_kv = cfg.dim, cfg.head_dim, cfg.n_kv_heads
    ada = k1.ada_vectors(model.params["decoder"], model.t_embed(6.0))
    kw = dict(n_heads=cfg.n_heads, n_kv=n_kv, head_dim=hd, eps=cfg.norm_eps,
              window=cfg.sliding_window)
    stacks = [fused[k] for k in ("wqkv", "wo", "w13", "w2")]
    worst, times = 0.0, {}
    for case in K7_CASES:
        layer, rows, S, off = case
        gen = torch.Generator(device=dev).manual_seed(11 + layer + rows + off)
        kc = (torch.randn((rows, S, n_kv, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        vc = (torch.randn((rows, S, n_kv, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        x = torch.randn((rows, D), device=dev, generator=gen)
        c, s = k1.rope_pair_vectors(off, hd, cfg.rope_theta, device=dev)
        small = (fused["attn_norm"][layer], fused["ffn_norm"][layer],
                 ada[layer], fused["sqkv"][layer], fused["so"][layer],
                 fused["s13"][layer], fused["s2"][layer], c, s)
        args = (x, layer, off, *small, kc, vc, *stacks)
        got = k1.decode_layer_step(*args, **kw)
        torch.cuda.synchronize()
        ref = k1.decode_layer_step_plain(*args, **kw)
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got, ref))
        tag = (f"K7 decode_layer_step layer={layer} rows={rows} S={S} "
               f"offset={off}")
        if not err == 0.0:
            fail(f"{tag}: max_abs_err {err:.3e}: not bit-equal to the plain "
                 "version")
        line = f"{tag}: max_abs_err {err:.3e} (bit-equal)"
        if case in K7_TIMED:
            eager_ms, plain_ms = in_turns(
                lambda: k1.decode_layer_step(*args, **kw),
                lambda: k1.decode_layer_step_plain(*args, **kw), 50, 2)
            ms = graph_ms(lambda: k1.decode_layer_step(*args, **kw))
            wbytes = nbytes(*(w[layer] for w in stacks))
            visible = min(off, S) - max(0, off - cfg.sliding_window)
            moved = (wbytes + nbytes(*small) + 2 * nbytes(x)
                     + 2 * rows * visible * n_kv * hd * 2
                     + 2 * nbytes(got[1]))
            b_ms, b_by = bound(moved, 2 * rows * sum(
                w[layer].numel() for w in stacks), INT8_OPS)
            times[(rows, S, off)] = (ms, plain_ms, b_ms, b_by, eager_ms)
            line += (f"; kernel {ms:.4f} ms on the device (CUDA graph; "
                     f"{wbytes / ms / 1e6:.1f} GB/s of {wbytes / 1e6:.2f} MB "
                     f"weights), {eager_ms:.4f} ms called from the host, "
                     f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
                     f"{100 * b_ms / ms:.1f} % of it)")
        print(f"{line} [{card}]", flush=True)
    return worst, times


def measure_merge_cost(model, dev, card, tok):
    """The merge cost on this card: the one-shot decode loop's wall ms per
    position at FIT_ROWS rows of the 16 s chirp (the model's decode log),
    fitted to c0 + c1 B, and the host mel + encoder + adapter per decoder
    position of that chirp -> (MergeCost, {rows: ms per position})."""
    from voxtral_tpu_torch.pipeline import (
        DEFAULT_MERGE_COST,
        MergeCost,
        TranscribePipeline,
    )

    pipe = TranscribePipeline(model, tok)
    padded = pipe.padded_chunks(chirp(), SR)[0].samples
    mel = pipe.mel.compute_log_batch(padded)
    per_pos = {}
    model.measure_decode = True
    try:
        for rows in FIT_ROWS:
            model.transcribe_streaming_batch(np.repeat(mel, rows, axis=0))
            rec = model.decode_log[-1]
            if rec["route"] != "stack":
                fail(f"merge cost fit at {rows} rows: route {rec['route']}")
            per_pos[rows] = rec["seconds"] * 1e3 / rec["steps"]
    finally:
        model.measure_decode = False
    c1, c0 = np.polyfit(list(per_pos), list(per_pos.values()), 1)
    seq = model.decoder_seq_len(pipe.mel.num_frames(len(padded)))
    enc = encode_seconds(pipe, model, padded) * 1e3 / seq
    cost = MergeCost(c0_ms=float(c0), c1_ms=float(c1), enc_per_pos_ms=enc)
    print("merge cost: one-shot decode loop ms per position at rows "
          + ", ".join(f"{b}: {ms:.4f}" for b, ms in per_pos.items())
          + f"; fit c0 {c0:.4f} ms + c1 {c1:.4f} ms x rows; host mel + "
          f"encoder + adapter {enc:.4f} ms per decoder position ({seq} "
          f"positions); measured {cost} against the default "
          f"{DEFAULT_MERGE_COST} [{card}]", flush=True)
    return cost, per_pos


def forced_layer_route():
    """Replace ``models.voxtral.oneshot_plan`` with a plan that takes the
    per-layer route (K7) -> a function restoring it."""
    from voxtral_tpu_torch.models import voxtral as vx

    orig = vx.oneshot_plan
    vx.oneshot_plan = lambda model, batch, seq_len, spec=1: (
        "layer", "forced by chip_smoke.py")

    def restore():
        vx.oneshot_plan = orig

    return restore


def batched_run(pipe, bufs, dev):
    """pipe.transcribe_samples_batched(bufs, 8) once, the launch counters
    set to 0 just before and read just after, the model's decode log on
    -> (texts, per-buffer chunk tokens, wall s, launches, decode log)."""
    import torch

    counters = stream_counters()
    seen = []
    text_of = pipe._text
    pipe._text = lambda chunks: (seen.append(chunks), text_of(chunks))[1]
    pipe.model.measure_decode, pipe.model.decode_log = True, []
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    try:
        t0 = time.perf_counter()
        texts = pipe.transcribe_samples_batched(
            [(b, SR) for b in bufs], batch_size=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        del pipe._text
        pipe.model.measure_decode = False
    return texts, seen, wall, launches, pipe.model.decode_log


def run_batched_w8(model, plain, dev, card, layout_tie):
    """Phase 12: K7 at full width, the merge cost, the batched one-shot
    path on eight chirps (stack route, then the per-layer route forced),
    its plain side, the merge on a 40 s file."""
    import torch

    from voxtral_tpu_torch.models import voxtral as vx
    from voxtral_tpu_torch.pipeline import (
        MergeCost,
        PipelineConfig,
        TranscribePipeline,
    )
    from voxtral_tpu_torch.utils import hbm

    k7_err, k7_times = check_k7(model, dev, card)
    tok = text_tokenizer()
    cost, per_pos = measure_merge_cost(model, dev, card, tok)
    cfg = model.config.language_model
    pipe = TranscribePipeline(model, tok)
    bufs = [pool_signal(secs, i) for i, secs in enumerate(BATCH_SECS)]

    # Each buffer alone (transcribe_samples' own path), keeping margins.
    solo, margins, solo_wall = [], [], 0.0
    model.record_margins = True
    try:
        for b in bufs:
            t0 = time.perf_counter()
            solo.append(pipe._chunk_tokens(b, SR)[0])
            solo_wall += time.perf_counter() - t0
            margins.append(model.last_margins[0].copy())
    finally:
        model.record_margins = False
    n_tok = sum(len(t) for t in solo)

    texts, seen, wall, launches, log = batched_run(pipe, bufs, dev)
    tag = "w8 transcribe_samples_batched (8 chirps, batch_size=8)"
    steps = sum(r["steps"] for r in log)
    if launches["decode_stack_step"] != steps or any(
            r["route"] != "stack" for r in log):
        fail(f"{tag}: K1 launches {launches['decode_stack_step']} for "
             f"{steps} decode steps, routes {[r['route'] for r in log]}")
    # A buffer that shared its batch is held under the layout rule (the
    # batch changes the encoder's summation order, ROADMAP §3); one that
    # decoded alone under the kernel near-tie rule.
    lengths = [len(pipe.padded_chunks(b, SR)[0].samples) for b in bufs]
    same = []
    for i, (chunks, ref, m) in enumerate(zip(seen, solo, margins)):
        if len(chunks) != 1 or len(chunks[0]) != len(ref):
            fail(f"{tag} buffer {i}: {[len(c) for c in chunks]} tokens, "
                 f"alone {len(ref)}")
        tie = MARGIN_TIE if lengths.count(lengths[i]) == 1 else layout_tie
        same.append(first_divergence(f"{tag} buffer {i} vs alone",
                                     chunks[0], ref, m, tie))
        if same[-1] and texts[i] != pipe._text([ref]):
            fail(f"{tag} buffer {i}: text differs from the buffer alone")
    print(f"{tag}: {len(log)} dispatches of rows "
          f"{[r['rows'] for r in log]} ({steps} decode steps, K1 launches "
          f"{launches['decode_stack_step']}, K2 {launches['w8_matmul']}); "
          f"tokens and texts == each buffer alone: {same}; {n_tok} tokens, "
          f"aggregate {n_tok / wall:.1f} tok/s ({wall:.3f} s) against "
          f"{n_tok / solo_wall:.1f} tok/s one buffer at a time "
          f"({solo_wall:.3f} s), end to end [{card}]", flush=True)

    # The plain side, on three short buffers of one length (one batch).
    short = [(pool_signal(BATCH_PLAIN_SECS, 8 + i), SR) for i in range(3)]
    k_short = pipe.batched_chunk_tokens(short, batch_size=8)
    plain.record_margins = True
    try:
        p_short = TranscribePipeline(plain, tok).batched_chunk_tokens(
            short, batch_size=8)
        p_margins = plain.last_margins
    finally:
        plain.record_margins = False
    p_same = [first_divergence(f"{tag} plain side buffer {i}", k[0], p[0],
                               p_margins[i], MARGIN_TIE)
              for i, (k, p) in enumerate(zip(k_short, p_short))]
    print(f"{tag}: three {BATCH_PLAIN_SECS:.0f} s buffers in one batch, "
          f"tokens kernel == plain: {p_same} ({len(p_short[0][0])} tokens "
          f"each) [{card}]", flush=True)

    # The per-layer route forced on the same batch.
    restore = forced_layer_route()
    try:
        l_texts, l_seen, l_wall, l_launch, l_log = batched_run(pipe, bufs,
                                                               dev)
    finally:
        restore()
    ltag = f"{tag} on the per-layer route (forced)"
    l_steps = sum(r["steps"] for r in l_log)
    if (l_launch["decode_layer_step"] != cfg.n_layers * l_steps
            or l_launch["decode_stack_step"] != 0
            or any(r["route"] != "layer" for r in l_log)):
        fail(f"{ltag}: K7 launches {l_launch['decode_layer_step']} for "
             f"{l_steps} steps x {cfg.n_layers} layers, K1 "
             f"{l_launch['decode_stack_step']}")
    # K7 keeps the scaled q and the softmax weights in f32 where K1
    # rounds them to bf16: a rounding of the attention's operands, held
    # under the layout rule (2 x the control's logit noise).
    l_same = [first_divergence(f"{ltag} buffer {i} vs the stack route",
                               lc[0], c[0], m, layout_tie)
              for i, (lc, c, m) in enumerate(zip(l_seen, seen, margins))]
    extra = [(r["rows"], r.get("extra_bytes", 0), lr.get("extra_bytes", 0))
             for r, lr in zip(log, l_log)]
    if not all(le < se for _, se, le in extra):
        fail(f"{ltag}: decode memory above its start not below the stack "
             f"route's: {extra}")
    print(f"{ltag}: K7 launches {l_launch['decode_layer_step']} = "
          f"{cfg.n_layers} x {l_steps} steps, K1 0, K2 "
          f"{l_launch['w8_matmul']}; tokens == stack route: {l_same}; "
          f"texts == stack route: {l_texts == texts}; {l_wall:.3f} s "
          f"against {wall:.3f} s; decode memory above its start per "
          "dispatch (rows: stack / layer MB) "
          + ", ".join(f"{b}: {se / 1e6:.1f} / {le / 1e6:.1f}"
                      for b, se, le in extra) + f" [{card}]", flush=True)

    # The layer route's step: at 1 row from the dispatches above, at 8
    # rows on the 16 s chirp, beside the stack route's (the fit's runs).
    solo_l = [r for r in l_log if r["rows"] == 1]
    layer_ms = {1: sum(r["seconds"] for r in solo_l) * 1e3
                / sum(r["steps"] for r in solo_l)}
    chirp_mel = pipe.mel.compute_log_batch(
        pipe.padded_chunks(chirp(), SR)[0].samples)
    restore = forced_layer_route()
    model.measure_decode = True
    try:
        model.transcribe_streaming_batch(np.repeat(chirp_mel, 8, 0))
        rec = model.decode_log[-1]
        layer_ms[8] = rec["seconds"] * 1e3 / rec["steps"]
    finally:
        restore()
        model.measure_decode = False
    print("per-layer route: ms per decode step at 1 row (the eight chirps' "
          f"one-row batches) {layer_ms[1]:.3f}, at 8 rows (16 s chirp) "
          f"{layer_ms[8]:.3f}, against the stack route's {per_pos[1]:.3f} / "
          f"{per_pos[8]:.3f} (decode loop wall) [{card}]", flush=True)

    # The memory rungs in rows of 30 s chunks, check_hbm's own numbers.
    seq30 = model.decoder_seq_len(pipe.mel.num_frames(len(pipe.padded_chunks(
        pool_signal(CHUNK_30S_SECS, 0), SR)[0].samples)))
    room = (hbm.device_hbm_budget(dev) - hbm.model_hbm_bytes(model)
            - hbm.WORKSPACE_BYTES)
    row = vx.oneshot_cache_bytes(model, 1, seq30)
    rows_stack, rows_layer = room // (2 * row), room // row
    plan = vx.oneshot_plan(model, rows_stack + 1, seq30)
    if vx.oneshot_plan(model, rows_stack, seq30)[0] != "stack" \
            or plan[0] != "layer":
        fail(f"oneshot_plan at {rows_stack} / {rows_stack + 1} rows of "
             f"{seq30} positions: not stack / layer ({plan[1][:200]})")
    print(f"oneshot_plan on this card, 30 s chunks ({seq30} positions, "
          f"{row / 1e6:.2f} MB of bf16 cache per row and copy): the stack "
          f"route up to {rows_stack} rows, the per-layer route up to "
          f"{rows_layer} (budget {hbm.device_hbm_budget(dev) / 1e9:.3f} GB, "
          f"weights {hbm.model_hbm_bytes(model) / 1e9:.3f} GB, workspace "
          f"{hbm.WORKSPACE_BYTES / 1e9:.3f} GB) [{card}]", flush=True)

    # A 40 s file in chunks of 15 / 15 / 10 s, merged or not, held to each
    # chunk decoded alone (layout rule: padding and batch move the
    # encoder's summation order).
    sig = stream_signal(MERGE_SECS)
    runs = {}
    for name, mc in (("forced", MergeCost(1.0, 0.0, 0.0)), ("never", None)):
        mp = TranscribePipeline(model, tok, PipelineConfig(
            max_mel_frames=MERGE_MEL_FRAMES, merge_cost=mc))
        model.measure_decode, model.decode_log = True, []
        try:
            runs[name] = (mp._chunk_tokens(sig, SR),
                          [r["rows"] for r in model.decode_log])
        finally:
            model.measure_decode = False
    raw, padded = mp._chunks(sig, SR)
    alone, alone_margins = [], []
    model.record_margins = True
    try:
        for p in padded:
            alone.append(model.transcribe_streaming(
                mp.mel.compute_log_batch(p.samples))[:mp._token_count(p)])
            alone_margins.append(model.last_margins[0].copy())
    finally:
        model.record_margins = False
    if runs["forced"][1] != [len(padded)] or len(runs["never"][1]) < 2:
        fail(f"40 s file: dispatched rows {runs['forced'][1]} merged, "
             f"{runs['never'][1]} unmerged")
    counts = [mp._token_count(p) for p in padded]
    groups: dict = {}
    for i, p in enumerate(padded):
        groups.setdefault(len(p.samples), []).append(i)
    merges = TranscribePipeline(model, tok, PipelineConfig(
        max_mel_frames=MERGE_MEL_FRAMES, merge_cost=cost))._merge_wins(
            groups, counts)
    m_same = {}
    for name, (chunks, _) in runs.items():
        m_same[name] = [first_divergence(
            f"40 s file, merge {name}, chunk {i} vs alone", c, a, m,
            layout_tie) for i, (c, a, m) in enumerate(zip(chunks, alone,
                                                          alone_margins))]
    print(f"40 s file at max_mel_frames={MERGE_MEL_FRAMES}: chunks of "
          f"{[round(len(c.samples) / SR, 2) for c in raw]} s, "
          f"{[round(len(p.samples) / SR, 2) for p in padded]} s padded, "
          f"{[len(a) for a in alone]} tokens; the measured cost "
          f"{'merges them' if merges else 'keeps them apart'} (dispatched rows "
          f"merged {runs['forced'][1]}, apart {runs['never'][1]}); tokens "
          f"== each chunk alone: {m_same} [{card}]", flush=True)
    return dict(k7_err=k7_err, k7_times=k7_times, launches=launches,
                layer_launches=l_launch, cost=cost, per_pos=per_pos,
                layer_ms=layer_ms, rows_stack=rows_stack,
                rows_layer=rows_layer)


# ---------------------------------------------------------------------------
# Phase 14: the HTTP server (voxtral_tpu_torch.serving) on the w8 model


SERVE_PAIR_SECS = 4.0     # the two concurrent /transcribe uploads
SERVE_STREAM_SECS = 5.12  # each of the four /stream sessions (4 ticks)
SERVE_SSE_SECS = 3.0      # the SSE upload, fed by the server in 1 s slices
SERVE_DRAIN_TICK = 2      # feeds before the drained stream's snapshot


def serve_call(addr, method, path, body=None, headers=None, want=200):
    """One request; any status but ``want`` fails the run -> (body, s)."""
    import http.client

    conn = http.client.HTTPConnection(*addr[:2], timeout=600)
    t0 = time.perf_counter()
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    dt = time.perf_counter() - t0
    conn.close()
    if resp.status != want:
        fail(f"serving: {method} {path} answered {resp.status} (expected "
             f"{want}): {data[:300]!r}")
    return data, dt


def wav_body(sig: np.ndarray) -> bytes:
    import io

    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, SR, sig.astype(np.float32))
    return buf.getvalue()


def sse_request(addr, sig: np.ndarray) -> tuple:
    """POST the OpenAI route with stream=true -> (events, seconds to the
    first delta event, seconds to the end)."""
    import http.client

    boundary = "voxtralsmoke"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            "filename=\"a.wav\"\r\nContent-Type: application/octet-stream"
            "\r\n\r\n").encode() + wav_body(sig) + (
        f"\r\n--{boundary}\r\nContent-Disposition: form-data; "
        f"name=\"stream\"\r\n\r\ntrue\r\n--{boundary}--\r\n").encode()
    conn = http.client.HTTPConnection(*addr[:2], timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/audio/transcriptions", body=body, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    resp = conn.getresponse()
    if resp.status != 200:
        fail(f"serving: SSE answered {resp.status}: {resp.read()[:300]!r}")
    events, first = [], None
    for line in resp:
        if line.startswith(b"data: "):
            events.append(json.loads(line[6:]))
            if first is None and events[-1]["type"].endswith(".delta"):
                first = time.perf_counter() - t0
    conn.close()
    return events, first, time.perf_counter() - t0


def held_tokens(tag, got, ref, margins, tie) -> bool:
    """first_divergence on two sessions' token lists of one length."""
    if len(got) != len(ref):
        fail(f"{tag}: {len(got)} tokens against {len(ref)}")
    return first_divergence(tag, np.asarray(got), np.asarray(ref), margins,
                            tie)


def run_serving_w8(model, dev, card, layout_tie):
    """Phase 14: ``serving.make_server(pool_streams=4,
    pool_unbounded=True, state_dir=..., prewarm=True)`` on the full-width
    w8 model, driven over HTTP on 127.0.0.1: /transcribe_pcm of the 16 s
    chirp against transcribe_samples (kernel near-tie rule; K1 / K2
    launches equal), two concurrent /transcribe uploads coalesced into
    one batch (each held to its buffer alone by the batched-run rule),
    ?timestamps=1 words == transcribe_samples_words, four concurrent
    /stream sessions fed in 1.28 s pieces (each held to a direct
    StreamPool run of the same pieces; every slot free after), the SSE
    route (deltas join to the done text; held to a solo session of the
    same 1 s slices by the layout rule), a stream drained mid-way and
    resumed by a second server on the same state_dir (== the
    uninterrupted stream), and admission: with the pool's slots taken,
    503 through check_hbm under a budget that holds one solo session's
    caches beside the pool's.  Any other status, or an
    ERROR record on the server's logger (a swallowed pump failure),
    fails the run."""
    import logging
    import threading

    import torch

    from voxtral_tpu_torch.pipeline import TranscribePipeline
    from voxtral_tpu_torch.serving import server as srv
    from voxtral_tpu_torch.streaming import (
        StreamingSession,
        StreamPool,
        solo_cache_bytes,
    )
    from voxtral_tpu_torch.utils import hbm

    tag = "serving (w8, pool of 4 unbounded)"
    tok = text_tokenizer()
    pipe = TranscribePipeline(model, tok)
    errors = []

    class Errors(logging.Handler):
        def emit(self, record):
            errors.append(self.format(record))

    slog = logging.getLogger("voxtral_tpu_torch.serving")
    catch = Errors(logging.ERROR)
    slog.addHandler(catch)
    made = []  # every session the servers' routes made, in order
    new_session = srv._new_session

    def recorded(state):
        made.append(new_session(state))
        return made[-1]

    srv._new_session = recorded
    tmp = tempfile.TemporaryDirectory()
    servers = []

    def start(**kw):
        s = srv.make_server(pipe, "127.0.0.1", 0, pool_streams=4,
                            pool_unbounded=True, state_dir=tmp.name, **kw)
        servers.append(s)
        threading.Thread(target=s.serve_forever, daemon=True).start()
        return s

    def metrics(addr) -> dict:
        out = {}
        for line in serve_call(addr, "GET", "/metrics")[0].decode().split(
                "\n"):
            if line and not line.startswith("#"):
                name, _, val = line.rpartition(" ")
                out[name] = float(val)
        return out

    def reset():
        counters = stream_counters()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        return counters

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    try:
        t0 = time.perf_counter()
        server = start(prewarm=True)
        addr = server.server_address
        boot = time.perf_counter() - t0
        health = json.loads(serve_call(addr, "GET", "/healthz")[0])
        if health["backend"] != dev.type or set(health["prewarm"]) != {
                "full_chunk_s", "short_bucket_s", "session_s"}:
            fail(f"{tag}: /healthz {health}")
        # The prewarm's full chunk (30 s) runs K1 (a) over at most the
        # S = 240 slots check_k1 holds it at (phase 3).
        full = pipe.padded_chunks(np.zeros(
            pipe.pcfg.max_mel_frames * 160 + 1600, np.float32), SR)[0]
        s30 = model.decoder_seq_len(pipe.mel.num_frames(len(full.samples)))
        if s30 > 240:
            fail(f"{tag}: the prewarm's chunk takes K1 to S = {s30}, past "
                 "the S = 240 check_k1 holds")

        # /transcribe_pcm of the chirp against transcribe_samples.
        sig = chirp()
        model.record_margins = True
        try:
            ref = pipe._chunk_tokens(sig, SR)[0]
            ref_m = model.last_margins[0].copy()
        finally:
            model.record_margins = False
        counters = reset()
        t0 = time.perf_counter()
        lib_text = pipe.transcribe_samples(sig, SR)
        torch.cuda.synchronize()
        lib_wall = time.perf_counter() - t0
        lib_launch = {n: fn.launches for n, fn in counters.items()}
        seen, text_of = [], pipe._text
        pipe._text = lambda chunks: (seen.append(chunks), text_of(chunks))[1]
        counters = reset()
        try:
            data, wall = serve_call(addr, "POST", "/transcribe_pcm?rate=16000",
                                    sig.tobytes())
        finally:
            del pipe._text
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        reply = json.loads(data)
        same = first_divergence(f"{tag}: /transcribe_pcm vs "
                                "transcribe_samples", seen[0][0], ref, ref_m,
                                MARGIN_TIE)
        if same and reply["text"] != lib_text:
            fail(f"{tag}: /transcribe_pcm text differs from the library's")
        for k in ("decode_stack_step", "w8_matmul"):
            if launches[k] != lib_launch[k] or not launches[k]:
                fail(f"{tag}: /transcribe_pcm {k} launches {launches[k]}, "
                     f"the library run's {lib_launch[k]}")
        out["transcribe_launches"] = launches
        print(f"{tag}: boot with prewarm {boot:.2f} s (report "
              f"{health['prewarm']}; its 30 s chunk S={s30}); "
              f"/transcribe_pcm of the 16 s chirp: {wall:.3f} s round trip "
              f"against {lib_wall:.3f} s for transcribe_samples, tokens == "
              f"the library's: {same}, K1 {launches['decode_stack_step']} / "
              f"K2 {launches['w8_matmul']} launches as the library's "
              f"[{card}]", flush=True)

        # ?timestamps=1 words against transcribe_samples_words.
        data, _ = serve_call(addr, "POST", "/transcribe?timestamps=1",
                             wav_body(sig))
        words = pipe.transcribe_samples_words(sig, SR)
        if json.loads(data)["words"] != words["words"]:
            fail(f"{tag}: ?timestamps=1 words differ from "
                 "transcribe_samples_words")

        # Two concurrent /transcribe uploads: one batched decode.
        bufs = [pool_signal(SERVE_PAIR_SECS, i) for i in (0, 1)]
        alone, alone_m = [], []
        model.record_margins = True
        try:
            for b in bufs:
                alone.append(pipe._chunk_tokens(b, SR)[0])
                alone_m.append(model.last_margins[0].copy())
        finally:
            model.record_margins = False
        batched = pipe.batched_chunk_tokens
        for attempt in range(3):
            rows = []
            pipe.batched_chunk_tokens = lambda buffers, batch_size=8: (
                rows.append((buffers, batched(buffers, batch_size))),
                rows[-1][1])[1]
            before = metrics(addr).get("voxtral_transcribe_coalesced_total",
                                       0)
            replies = [None, None]

            def post(i):
                replies[i] = serve_call(addr, "POST", "/transcribe",
                                        wav_body(bufs[i]))

            threads = [threading.Thread(target=post, args=(i,))
                       for i in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            del pipe.batched_chunk_tokens
            grew = metrics(addr).get("voxtral_transcribe_coalesced_total",
                                     0) - before
            if grew >= 2:
                break
        else:
            fail(f"{tag}: two concurrent /transcribe uploads were never "
                 "coalesced into one batch")
        buffers, toks = next(r for r in rows if len(r[0]) == 2)
        pair_same = []
        for (samples, _), chunks in zip(buffers, toks):
            i = next(i for i, b in enumerate(bufs)
                     if np.array_equal(samples, b))
            pair_same.append(first_divergence(
                f"{tag}: coalesced /transcribe buffer {i} vs alone",
                chunks[0], alone[i], alone_m[i], layout_tie))
        pair_wall = max(r[1] for r in replies)

        # Four concurrent /stream sessions, 1.28 s pieces.
        sigs = [pool_signal(SERVE_STREAM_SECS, i) for i in range(4)]
        n_ticks = -(-len(sigs[0]) // TICK)
        model.record_margins = True
        counters = reset()
        sids = [json.loads(serve_call(addr, "POST", "/stream/start")[0])[
            "session"] for _ in sigs]
        stream_sessions = made[-4:]
        feeds, finals = [], [None] * 4

        def drive(i):
            for k in range(n_ticks):
                _, dt = serve_call(addr, "POST", f"/stream/{sids[i]}/feed",
                                   sigs[i][k * TICK:(k + 1) * TICK].tobytes())
                feeds.append(dt)
            finals[i] = json.loads(serve_call(
                addr, "POST", f"/stream/{sids[i]}/finish")[0])

        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        streams_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        out["stream_launches"] = {n: fn.launches
                                  for n, fn in counters.items()}
        if server.state.pool.free_slots != 4 or metrics(addr)[
                "voxtral_pool_free_slots"] != 4:
            fail(f"{tag}: pool slots not all free after the streams finished")
        # The same pieces through a StreamPool of the same arguments.
        pool = StreamPool(model, max_streams=4, step_positions=P_STEP,
                          unbounded=True)
        direct = [StreamingSession(model, tok, pool=pool) for _ in sigs]
        step_ms = []
        for k in range(n_ticks):
            for ses, s in zip(direct, sigs):
                ses.feed(s[k * TICK:(k + 1) * TICK], pump=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pool.pump()
            torch.cuda.synchronize()
            if k:  # the first tick runs the four slots' init steps
                step_ms.append((time.perf_counter() - t1) * 1e3)
        for ses in direct:
            ses.finish()
        model.record_margins = False
        exact = []
        for i, (got, ref_s) in enumerate(zip(stream_sessions, direct)):
            if got.tokens == ref_s.tokens:
                exact.append(True)
                if finals[i]["text"] != ref_s.text:
                    fail(f"{tag}: stream {i} text differs from the direct "
                         "pool's")
                continue
            exact.append(False)
            held_tokens(f"{tag}: /stream {i} vs a direct StreamPool",
                        got.tokens, ref_s.tokens, ref_s.margins, layout_tie)
        del pool, direct

        # The SSE route against a solo session of the same 1 s slices.
        sse_sig = pool_signal(SERVE_SSE_SECS, 5)
        model.record_margins = True
        try:
            events, first_s, sse_s = sse_request(addr, sse_sig)
            sse_ses = made[-1]
            solo = StreamingSession(model, tok, unbounded=True)
            for lo in range(0, len(sse_sig), SR):
                solo.feed(sse_sig[lo:lo + SR])
            solo.finish()
        finally:
            model.record_margins = False
        if (events[-1]["type"] != "transcript.text.done"
                or "".join(e["delta"] for e in events[:-1])
                != events[-1]["text"]):
            fail(f"{tag}: SSE deltas do not join to the done text")
        sse_same = held_tokens(f"{tag}: SSE (pooled) vs a solo session",
                               sse_ses.tokens, solo.tokens, solo.margins,
                               layout_tie)
        if sse_same and events[-1]["text"] != solo.text:
            fail(f"{tag}: SSE text differs from the solo session's")

        # A stream drained mid-way, resumed by a second server.
        sid = json.loads(serve_call(addr, "POST", "/stream/start")[0])[
            "session"]
        for k in range(SERVE_DRAIN_TICK):
            serve_call(addr, "POST", f"/stream/{sid}/feed",
                       sigs[0][k * TICK:(k + 1) * TICK].tobytes())
        server.shutdown()
        server.server_close()
        if server.drain() != 1:
            fail(f"{tag}: drain did not snapshot the live stream")
        server2 = start()
        addr2 = server2.server_address
        resumed = server2.state.sessions.get(sid)
        if resumed is None or resumed._pool is None:
            fail(f"{tag}: the drained stream was not resumed into the pool")
        for k in range(SERVE_DRAIN_TICK, n_ticks):
            serve_call(addr2, "POST", f"/stream/{sid}/feed",
                       sigs[0][k * TICK:(k + 1) * TICK].tobytes())
        done = json.loads(serve_call(addr2, "POST",
                                     f"/stream/{sid}/finish")[0])
        if resumed.tokens != stream_sessions[0].tokens or (
                done["text"] != finals[0]["text"]):
            fail(f"{tag}: the resumed stream's tokens differ from the "
                 "uninterrupted stream's")
        if metrics(addr2)["voxtral_sessions_restored_total"] != 1:
            fail(f"{tag}: voxtral_sessions_restored_total != 1")

        # Admission: with the pool's slots taken, 503 through check_hbm
        # under a budget with room for one solo session's caches beside
        # the pool's.
        state = server2.state
        for _ in range(4):
            serve_call(addr2, "POST", "/stream/start")
        one = solo_cache_bytes(model, state.step_positions)
        budget = (hbm.model_hbm_bytes(model) + state.pool.cache_bytes
                  + hbm.WORKSPACE_BYTES + one + one // 2)
        os.environ["VOXTRAL_HBM_BYTES"] = str(budget)
        try:
            serve_call(addr2, "POST", "/stream/start")
            refusal = json.loads(serve_call(addr2, "POST", "/stream/start",
                                            want=503)[0])["error"]
        finally:
            del os.environ["VOXTRAL_HBM_BYTES"]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        if errors:
            fail(f"{tag}: the server logged errors: {errors[:3]}")
    finally:
        srv._new_session = new_session
        slog.removeHandler(catch)
        model.record_margins = False
        for s in servers:
            s.shutdown()
            s.server_close()
        tmp.cleanup()
    feeds_ms = np.asarray(feeds) * 1e3
    print(f"{tag}: two concurrent /transcribe of {SERVE_PAIR_SECS:.0f} s in "
          f"one batch ({pair_wall:.3f} s), tokens == each alone: {pair_same}"
          f"; ?timestamps=1 words == transcribe_samples_words; four "
          f"concurrent /stream sessions of {SERVE_STREAM_SECS} s in "
          f"{len(feeds)} feeds of 1.28 s ({streams_wall:.2f} s): feed round "
          f"trip median {np.median(feeds_ms):.1f} ms, max "
          f"{feeds_ms.max():.1f} ms, against the direct pool's step at four "
          f"ready rows {np.median(step_ms):.1f} ms (median, max "
          f"{max(step_ms):.1f}); tokens == the direct StreamPool's exactly: "
          f"{exact}; K1 {out['stream_launches']['decode_stack_step']} / K2 "
          f"{out['stream_launches']['w8_matmul']} launches; SSE of "
          f"{SERVE_SSE_SECS:.0f} s: first delta after "
          + ("none (no text)" if first_s is None else f"{first_s:.3f} s")
          + f", done after {sse_s:.3f} s, tokens == a solo session's: "
          f"{sse_same}; "
          f"drained at feed {SERVE_DRAIN_TICK} and resumed by a second "
          f"server: tokens == the uninterrupted stream's; with four pooled "
          f"sessions and a budget of {budget / 1e9:.3f} GB (room for one "
          f"solo session's {one / 1e9:.3f} GB of caches) the second solo "
          f"session 503 ({refusal[:60]}...); peak {peak:.3f} GB [{card}]",
          flush=True)
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA GPU (there is no CPU fallback)")
    from voxtral_tpu_torch import VoxtralConfig, VoxtralTokenizer
    from voxtral_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ------------------------------------------------------------
    lib, build_s = _build.build()
    _build.library()
    print(f"build: {build_s:.2f} s ({lib.name})", flush=True)

    cfg = VoxtralConfig.voxtral()
    sig = chirp()
    tok = VoxtralTokenizer([None] * 131072, {}, 131072)
    t_run = t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase:.1f} s ({now - t_run:.1f} s "
              f"since the build) [{card}]", flush=True)
        t_phase = now

    # -- 3. w8, then its streaming sessions (8a) ---------------------------------
    w8 = run_w8(cfg, dev, card, sig, tok)
    w8_model, w8_plain = w8.pop("model"), w8.pop("plain")
    phase_done("w8 one-shot")
    st_w8 = run_stream_w8(w8_model, w8_plain, dev, card, tok)
    release()
    phase_done("w8 sessions")
    batched = run_batched_w8(w8_model, w8_plain, dev, card,
                             2 * st_w8["layout_noise"][1])
    release()
    phase_done("batched one-shot (w8)")
    mesh = run_mesh_w8(w8_model, dev, card, sig, tok,
                       {"tokens": w8["tokens"], "margins": w8["margins"]})
    release()
    phase_done("mesh (w8: tp=2, dp=2, 2 x 2 on one card)")
    mstream = run_mesh_streams(w8_model, dev, card, sig)
    release()
    phase_done("mesh streams (K4 cache modes, sessions and pools on "
               "tp=2, dp=2, 2 x 2)")
    if torch.cuda.device_count() >= 2:
        run_mesh_cards(w8_model.params, cfg, dev, card, tok, sig)
        phase_done("mesh over cards of their own")
    else:
        print("phase 13b (a mesh over cards of their own): not run, one "
              "card", flush=True)
    pl_w8 = run_pools_w8(w8_model, w8_plain, dev, card,
                         st_w8["layout_noise"])
    release()
    phase_done("w8 pools")
    serving = run_serving_w8(w8_model, dev, card,
                             2 * st_w8["layout_noise"][1])
    del w8_model, w8_plain
    release()
    phase_done("serving (w8)")

    # -- 11. dense weights (bf16 on K1 (g), the CLI's --model, f32) ---------
    dense = run_dense(cfg, dev, card, sig, tok)
    phase_done("dense")

    # -- 4. K3 ---------------------------------------------------------------
    k3_err, k3_times = check_k3(dev, card)
    phase_done("K3")

    # -- 5, 6. q4g and q4, each then its sessions (8b, 8c) -----------------
    check_pack_device(dev)
    t0 = time.perf_counter()
    tree = random_q4_tree(cfg, seed=0)
    print(f"random Q4_0 weights (seed 0, one layer tiled per stack) built: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    q4g = run_q4g(tree, cfg, dev, card, sig, tok, w8["n_tok"])
    q4g_model, q4g_plain = q4g.pop("model"), q4g.pop("plain")
    phase_done("q4g one-shot")
    mesh_q4g = run_mesh_q4g(q4g_model, q4g_plain, dev, card, sig, tok,
                            {k: q4g[k] for k in ("tokens", "margins")})
    release()
    phase_done("mesh q4g (g32 halves: tp=2, dp=2, 2 x 2 on one card)")
    if torch.cuda.device_count() >= 2:
        run_mesh_cards(q4g_model.params, cfg, dev, card, tok, sig)
        phase_done("q4g mesh over cards of their own")
    st_q4g = run_stream_q4g(q4g_model, q4g_plain, dev, card)
    phase_done("q4g sessions")
    pl_q4g = run_pools_q4g(q4g_model, q4g_plain, dev, card)
    del q4g_model, q4g_plain
    release()
    phase_done("q4g pool")
    q4 = run_q4(tree, cfg, dev, card, sig, tok)
    q4_model, q4_plain = q4.pop("model"), q4.pop("plain")
    phase_done("q4 one-shot")
    st_q4 = run_stream_q4(q4_model, q4_plain, dev, card)
    phase_done("q4 session")
    pl_q4 = run_pools_q4(q4_model, q4_plain, dev, card)
    phase_done("q4 pool")
    del tree, q4_model, q4_plain
    release()

    # -- 7. gguf -------------------------------------------------------------
    run_gguf_cli(dev, card)
    phase_done("gguf")

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "voxtral_tpu"))
    if loaded:
        fail(f"the run loaded jax or the JAX package: {loaded[:5]}")

    # -- 9. record -----------------------------------------------------------
    runs = {"w8_sequential": w8["launches"],
            **{f"w8_speculative_{d}": r["launches"]
               for d, r in w8["spec_runs"].items()},
            "q4g_sequential": q4g["launches"],
            "q4g_speculative_ngram": q4g["spec_launches"],
            "q4_sequential": q4["launches"],
            **{f"w8_stream_{n}": r["run"]["launches"]
               for n, r in st_w8["runs"].items()},
            **{f"w8_stream_speculative_{d}": r["run"]["launches"]
               for d, r in st_w8["spec"].items()},
            "w8_stream_ring_wrap": st_w8["wrap_launches"],
            "q4g_stream_unbounded": st_q4g["run"]["launches"],
            "q4g_stream_speculative_pad": st_q4g["spec"]["launches"],
            "q4_stream_bounded": st_q4["run"]["launches"],
            **pl_w8["paths"],
            "q4g_pool_unbounded_int8": pl_q4g["launches"],
            "q4_pool_generic": pl_q4["launches"], **dense["runs"],
            "w8_batched": batched["launches"],
            "w8_batched_layer_route": batched["layer_launches"],
            **mesh["launches"], **mstream["launches"],
            **mesh_q4g["launches"],
            "w8_serving_transcribe": serving["transcribe_launches"],
            "w8_serving_streams": serving["stream_launches"]}
    for path in ("w8_pool_unbounded_int8", "w8_pool_chunked_bounded",
                 "w8_pool_chunked_unbounded", "w8_pool_speculative_ngram_int8",
                 "q4g_pool_unbounded_int8", "bf16_sequential",
                 "bf16_speculative_ngram", "bf16_stream_unbounded",
                 "bf16_pool_unbounded_model", "bf16_pool_unbounded_int8"):
        if runs[path]["decode_stack_step"] < 1:
            fail(f"{path}: K1 (modes (e) / (f) / (g)) was launched no time")

    for path in ("w8_serving_transcribe", "w8_serving_streams"):
        if min(runs[path]["decode_stack_step"], runs[path]["w8_matmul"]) < 1:
            fail(f"{path}: K1 or K2 was launched no time")
    if runs["w8_batched_layer_route"]["decode_layer_step"] < 1:
        fail("w8_batched_layer_route: K7 was launched no time")
    for path, name in (("w8_tp2_sequential", "attn_half_step"),
                       ("w8_tp2_sequential", "ffn_half_step"),
                       ("w8_tp2_sequential", "lm_half_argmax"),
                       ("w8_dp2tp2_speculative_ngram", "attn_half_step"),
                       ("w8_dp2_sequential", "decode_stack_step_lm_argmax"),
                       ("w8_dp2_speculative_ngram",
                        "decode_stack_step_lm_argmax"),
                       ("w8_mesh_stream_tp2", "attn_half_step"),
                       ("w8_mesh_stream_tp2", "lm_half_argmax"),
                       ("w8_mesh_stream_tp2_speculative_ngram",
                        "attn_half_step"),
                       ("w8_mesh_stream_tp2_speculative_random_tree",
                        "attn_half_step"),
                       ("w8_mesh_pool_tp2_int8", "attn_half_step"),
                       ("w8_mesh_pool_tp2_chunked", "attn_half_step"),
                       ("w8_mesh_pool_dp2", "decode_stack_step"),
                       ("w8_mesh_pool_dp2tp2", "ffn_half_step"),
                       ("q4g_tp2_sequential", "attn_half_step_g32"),
                       ("q4g_tp2_sequential", "ffn_half_step_g32"),
                       ("q4g_tp2_sequential", "lm_half_argmax_g32"),
                       ("q4g_dp2tp2_speculative_ngram", "attn_half_step_g32"),
                       ("q4g_dp2_sequential",
                        "decode_stack_step_lm_argmax_g32"),
                       ("q4g_speculative_ngram",
                        "decode_stack_step_g32_stream"),
                       ("q4g_stream_speculative_pad",
                        "decode_stack_step_g32_stream"),
                       ("q4g_tp2_speculative_ngram",
                        "lm_half_argmax_g32_stream"),
                       ("q4g_mesh_stream_tp2", "lm_half_argmax_g32"),
                       ("q4g_mesh_pool_tp2_int8", "attn_half_step_g32"),
                       ("q4g_mesh_pool_dp2", "decode_stack_step"),
                       ("bf16_dp2_sequential",
                        "decode_stack_step_lm_argmax_bf16"),
                       ("bf16_dp2_speculative_ngram",
                        "decode_stack_step_lm_argmax_bf16"),
                       ("bf16_dp2_pool_model",
                        "decode_stack_step_lm_argmax_bf16"),
                       ("bf16_dp2_pool_int8",
                        "decode_stack_step_lm_argmax_bf16")):
        if runs[path].get(name, 0) < 1:
            fail(f"{path}: {name} was launched no time")

    def launches(name):
        by = {path: c[name] for path, c in runs.items() if c.get(name)}
        return sum(by.values()), by

    def w8_launches(name):
        # A wrapper's launches less its g32 and bf16 ones (their own
        # entries).
        def w8(c):
            return (c.get(name, 0) - c.get(f"{name}_g32", 0)
                    - c.get(f"{name}_bf16", 0))

        by = {path: w8(c) for path, c in runs.items() if w8(c)}
        return sum(by.values()), by

    lm_shape = (1, 3072, 131072)
    k2t = w8["k2_times"][lm_shape]
    k1a, k1h = w8["k1"], q4g["k1"]
    gs = k1h["stream"]
    d_t, hd_t = st_w8["k1_times"], st_q4g["k1_times"]
    k3t = k3_times[(1, 131072, 3072)]
    k7t413 = batched["k7_times"][(1, 413, 412)]
    pk = pl_w8["k1"]
    kg = dense["k1"]
    k7t = batched["k7_times"][(1, 151, 150)]
    k7t8 = batched["k7_times"][(8, 151, 150)]
    k7tw = batched["k7_times"][(1, 8400, 8300)]
    k1i, k1i8 = mesh["k1i_times"][1], mesh["k1i_times"][SPEC_K]
    k4 = mesh["k45_times"][("K4", 1, 151)]
    k4s = mesh["k45_times"][("K4", SPEC_K, 158)]
    k4l = mesh["k45_times"][("K4", 1, 194)]
    k5, k5s = mesh["k45_times"][("K5", 1)], mesh["k45_times"][("K5", SPEC_K)]
    k44, k54 = mesh["k45_times"][("K4", 4, 151)], mesh["k45_times"][("K5", 4)]
    k4m = mstream["k4_times"]
    k6, k6s = mesh["k6_times"][1], mesh["k6_times"][SPEC_K]
    gq = mesh_q4g
    g1i, g1i8 = gq["k1i_times"][1], gq["k1i_times"][SPEC_K]
    g4 = gq["k45_times"][("K4", 1, 151)]
    g4s = gq["k45_times"][("K4", SPEC_K, 158)]
    g5, g5s = gq["k45_times"][("K5", 1)], gq["k45_times"][("K5", SPEC_K)]
    g44, g54 = gq["k45_times"][("K4", 4, 151)], gq["k45_times"][("K5", 4)]
    g6, g6s = gq["k6_times"][1], gq["k6_times"][SPEC_K]
    dm = dense["mesh"]
    b1i, b1i8 = dm["k1i_times"][1], dm["k1i_times"][SPEC_K]
    b1i12 = dm["k1i_times"][12]
    record = {"kernels": [
        {"name": "w8_matmul", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/w8_matmul.cu",
         "replaces": "voxtral_tpu/ops/w8_pallas.py:51",
         "launches": launches("w8_matmul")[0],
         "launches_by_path": launches("w8_matmul")[1],
         "max_abs_err": w8["k2_err"], "ms": k2t[0], "plain_ms": k2t[1],
         "bound_ms": k2t[3], "bound_by": k2t[4], "library_ms": k2t[2],
         "library": "torch._int_mm + epilogue (refuses M <= 16)",
         "host_called_ms": k2t[7],
         "prefill_ms": w8["k2_times"][(38, 3072, 4096)][0],
         "prefill_library_ms": w8["k2_times"][(38, 3072, 4096)][2],
         # Every shape: (kernel ms, torch._int_mm + epilogue ms or None).
         "shapes_ms": {f"{m}x{k}x{n}": [round(t[0], 5),
                                         None if t[2] is None
                                         else round(t[2], 5)]
                       for (m, k, n), t in w8["k2_times"].items()}},
        {"name": "decode_stack_step", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_step.cu",
         "stream": "voxtral_tpu_torch/csrc/k1_stream.cuh",
         "replaces": "voxtral_tpu/ops/decode_step_pallas.py:1654",
         "modes": ["a", "b", "c", "d", "e", "f", "g", "h"],
         "launches": launches("decode_stack_step")[0],
         "launches_by_path": launches("decode_stack_step")[1],
         "max_abs_err": max(k1a["err"], k1h["err"], st_w8["k1_err"],
                            st_q4g["k1_err"], pk["err"], pl_q4g["err"],
                            kg["err"]),
         # K1 step ms on the device (a CUDA graph of the step); beside
         # them "host_called_ms", the same steps called from the host.
         "ms": k1a["one"][1], "plain_ms": k1a["one"][2],
         "bound_ms": k1a["one"][3], "bound_by": k1a["one"][4],
         "library_ms": None, "host_called_ms": k1a["one"][5],
         "spec_ms": k1a["spec8"][1], "spec_plain_ms": k1a["spec8"][2],
         "spec64_ms": k1a["spec64"][1], "spec64_plain_ms": k1a["spec64"][2],
         "h_ms": k1h["one"][1], "h_plain_ms": k1h["one"][2],
         "h_bound_ms": k1h["one"][3], "h_spec_ms": k1h["spec8"][1],
         "h_spec64_ms": k1h["spec64"][1], "h_rows4_ms": k1h["rows4"][1],
         "d_ms": d_t[(16000, 1)][0], "d_plain_ms": d_t[(16000, 1)][1],
         "d_bound_ms": d_t[(16000, 1)][2],
         "d_spec_ms": d_t[(16000, SPEC_K)][0],
         "d_short_ms": d_t[(100, 1)][0],
         "d_short_bound_ms": d_t[(100, 1)][2],
         "h_d_ms": hd_t[(16000, 1)][0], "h_d_plain_ms": hd_t[(16000, 1)][1],
         "h_d_bound_ms": hd_t[(16000, 1)][2],
         # This slice's modes, 4 streams at four ring phases (S = 8238)
         # unless said otherwise: kernel, plain, bound.
         "cd_ms": pk["cd"][1], "cd_plain_ms": pk["cd"][2],
         "cd_bound_ms": pk["cd"][3],
         "e_ms": pk["e"][1], "e_plain_ms": pk["e"][2],
         "e_bound_ms": pk["e"][3], "e_bound_by": pk["e"][4],
         "e_spec_ms": pk["e_spec"][1], "e_spec_plain_ms": pk["e_spec"][2],
         "e_spec_bound_ms": pk["e_spec"][3],
         "e_h_ms": pl_q4g["e_g32"][1], "e_h_plain_ms": pl_q4g["e_g32"][2],
         "e_h_bound_ms": pl_q4g["e_g32"][3],
         "f_ms": pk["f_ring"][1], "f_plain_ms": pk["f_ring"][2],
         "f_bound_ms": pk["f_ring"][3], "f_bound_by": pk["f_ring"][4],
         "f_int8_ms": pk["f_ring_int8"][1],
         "f_int8_plain_ms": pk["f_ring_int8"][2],
         "f_int8_bound_ms": pk["f_ring_int8"][3],
         "f_bounded_ms": pk["f_bounded"][1],
         "f_bounded_plain_ms": pk["f_bounded"][2],
         "f_bounded_bound_ms": pk["f_bounded"][3],
         "f_bounded_int8_ms": pk["f_bounded_int8"][1],
         "f_bounded_int8_bound_ms": pk["f_bounded_int8"][3],
         # The same four (f) steps on the device alone (CUDA graph); the
         # f_* above are called from the host.
         **{f"{name}_device_ms": pk[name][5]
            for name in ("f_ring", "f_ring_int8", "f_bounded",
                         "f_bounded_int8")},
         # The attention block alone in mode (f), one layer on the grown
         # ring (YARD_F): device ms, SDPA over the visible K / V, bound.
         **{f"attn_f_{n}_{key}": pk["yard_f"][n][i] for n in YARD_F
            for i, key in ((0, "ms"), (1, "library_ms"), (2, "bound_ms"))},
         # The attention block alone, one layer under (d), window full:
         # device ms, torch's scaled_dot_product_attention over the same
         # visible K / V (yardstick), bound ms; one and four streams.
         **{f"attn_d{n}_{key}": pk["yard"][n][i] for n in YARD_OFFS
            for i, key in ((0, "ms"), (1, "library_ms"), (2, "bound_ms"))},
         # Mode (g), bf16 weights: 1 row (a), spec=8 at 8 and 64 rows,
         # 4 rows (c); under (d) at offset 16000 (S = 8238), (e) at the
         # four ring phases, (f) bounded S = 1536.
         "g_ms": kg["one"][1], "g_plain_ms": kg["one"][2],
         "g_bound_ms": kg["one"][3], "g_bound_by": kg["one"][4],
         "g_spec_ms": kg["spec8"][1], "g_spec_plain_ms": kg["spec8"][2],
         "g_spec64_ms": kg["spec64"][1], "g_rows4_ms": kg["rows4"][1],
         "g_d_ms": kg["d"][1], "g_d_plain_ms": kg["d"][2],
         "g_d_bound_ms": kg["d"][3],
         "g_e_ms": kg["e"][1], "g_e_plain_ms": kg["e"][2],
         "g_e_bound_ms": kg["e"][3],
         "g_f_ms": kg["f"][1], "g_f_plain_ms": kg["f"][2],
         "g_f_bound_ms": kg["f"][3]},
        {"name": "decode_layer_step", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_layer.cu",
         "replaces": "voxtral_tpu/ops/decode_step_pallas.py:348",
         "launches": launches("decode_layer_step")[0],
         "launches_by_path": launches("decode_layer_step")[1],
         "max_abs_err": batched["k7_err"], "ms": k7t[0], "plain_ms": k7t[1],
         "bound_ms": k7t[2], "bound_by": k7t[3], "library_ms": None,
         "host_called_ms": k7t[4], "rows8_ms": k7t8[0],
         "rows8_plain_ms": k7t8[1],
         "rows8_bound_ms": k7t8[2], "window_full_ms": k7tw[0],
         "window_full_plain_ms": k7tw[1], "window_full_bound_ms": k7tw[2],
         "s413_ms": k7t413[0], "s413_bound_ms": k7t413[2],
         "route_step_ms": batched["layer_ms"]},
        {"name": "decode_stack_step_lm_argmax", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_step.cu",
         "fold": "voxtral_tpu_torch/csrc/lm_argmax.cuh",
         "replaces": "voxtral_tpu/ops/decode_step_pallas.py:1654",
         "modes": ["i"],
         "launches": w8_launches("decode_stack_step_lm_argmax")[0],
         "launches_by_path": w8_launches("decode_stack_step_lm_argmax")[1],
         "max_abs_err": mesh["k1i_err"], "ms": k1i[0], "plain_ms": k1i[1],
         "bound_ms": k1i[2], "bound_by": k1i[3], "library_ms": None,
         "spec_ms": k1i8[0], "spec_plain_ms": k1i8[1],
         "spec_bound_ms": k1i8[2], "device_ms": k1i[4]},
        {"name": "attn_half_step", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_tp.cu",
         "replaces": "voxtral_tpu/ops/decode_tp_pallas.py:741",
         "launches": w8_launches("attn_half_step")[0],
         "launches_by_path": w8_launches("attn_half_step")[1],
         "modes": ["bounded", "b", "d", "e", "e x b", "f", "f x e"],
         "max_abs_err": max(mesh["k45_err"], mstream["k4_err"]),
         "ms": k4[0], "plain_ms": k4[1],
         "bound_ms": k4[2], "bound_by": k4[3], "library_ms": None,
         "host_called_ms": k4[4], "spec_ms": k4s[0],
         "spec_plain_ms": k4s[1], "spec_bound_ms": k4s[2],
         "largest_cache_ms": k4l[0], "largest_cache_bound_ms": k4l[2],
         "rows4_ms": k44[0], "rows4_plain_ms": k44[1],
         "rows4_bound_ms": k44[2],
         # K4's cache modes at tp = 2 (K4_MODE_CASES): device ms
         # (CUDA graph), plain ms, bound ms, host-called ms.
         **{f"{name}_{key}": k4m[name][i] for name in K4_MODE_CASES
            for i, key in ((0, "ms"), (1, "plain_ms"), (2, "bound_ms"),
                           (4, "host_called_ms"))}},
        {"name": "ffn_half_step", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_tp.cu",
         "replaces": "voxtral_tpu/ops/decode_tp_pallas.py:818",
         "launches": w8_launches("ffn_half_step")[0],
         "launches_by_path": w8_launches("ffn_half_step")[1],
         "max_abs_err": mesh["k45_err"], "ms": k5[0], "plain_ms": k5[1],
         "bound_ms": k5[2], "bound_by": k5[3], "library_ms": None,
         "host_called_ms": k5[4], "rows8_ms": k5s[0],
         "rows8_bound_ms": k5s[2], "rows4_ms": k54[0],
         "rows4_plain_ms": k54[1], "rows4_bound_ms": k54[2]},
        {"name": "lm_half_argmax", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_tp.cu",
         "fold": "voxtral_tpu_torch/csrc/lm_argmax.cuh",
         "replaces": "voxtral_tpu/ops/decode_tp_pallas.py:1349",
         "launches": w8_launches("lm_half_argmax")[0],
         "launches_by_path": w8_launches("lm_half_argmax")[1],
         "max_abs_err": mesh["k6_err"], "ms": k6[0], "plain_ms": k6[1],
         "bound_ms": k6[2], "bound_by": k6[3], "library_ms": None,
         "host_called_ms": k6[4], "rows8_ms": k6s[0],
         "rows8_bound_ms": k6s[2]},
        # The g32 (q4g) modes of K1 (i), K4, K5 and K6 (phase 13d): ms is
        # the device time (CUDA graph), host_called_ms the wrapper called
        # from the host.
        {"name": "decode_stack_step_lm_argmax_g32", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_step.cu",
         "fold": "voxtral_tpu_torch/csrc/lm_argmax.cuh",
         "replaces": "voxtral_tpu/ops/decode_step_pallas.py:1654",
         "modes": ["i", "h"],
         "launches": launches("decode_stack_step_lm_argmax_g32")[0],
         "launches_by_path": launches("decode_stack_step_lm_argmax_g32")[1],
         "max_abs_err": gq["k1i_err"], "ms": g1i[4], "plain_ms": g1i[1],
         "bound_ms": g1i[2], "bound_by": g1i[3], "library_ms": None,
         "host_called_ms": g1i[0], "spec_ms": g1i8[4],
         "spec_plain_ms": g1i8[1], "spec_bound_ms": g1i8[2]},
        # K1 (i) over the bf16 table (phase 11d): ms is the device time
        # (CUDA graph), host_called_ms the wrapper called from the host.
        {"name": "decode_stack_step_lm_argmax_bf16", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_step.cu",
         "fold": "voxtral_tpu_torch/csrc/lm_argmax.cuh",
         "replaces": "voxtral_tpu/ops/decode_step_pallas.py:1654",
         "modes": ["i", "g"],
         "launches": launches("decode_stack_step_lm_argmax_bf16")[0],
         "launches_by_path": launches("decode_stack_step_lm_argmax_bf16")[1],
         "max_abs_err": dm["k1i_err"], "ms": b1i[4], "plain_ms": b1i[1],
         "bound_ms": b1i[2], "bound_by": b1i[3], "library_ms": None,
         "host_called_ms": b1i[0], "spec_ms": b1i8[4],
         "spec_plain_ms": b1i8[1], "spec_bound_ms": b1i8[2],
         "rows12_ms": b1i12[4], "rows12_plain_ms": b1i12[1],
         "rows12_bound_ms": b1i12[2],
         "dp2_ms_per_position": dm["ms_pos"], "dp2_peak_gb": dm["peak"]},
        {"name": "attn_half_step_g32", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_tp.cu",
         "replaces": "voxtral_tpu/ops/decode_tp_pallas.py:741",
         "modes": ["g32", "bounded", "b", "d", "e", "f"],
         "launches": launches("attn_half_step_g32")[0],
         "launches_by_path": launches("attn_half_step_g32")[1],
         "max_abs_err": gq["k45_err"], "ms": g4[0], "plain_ms": g4[1],
         "bound_ms": g4[2], "bound_by": g4[3], "library_ms": None,
         "host_called_ms": g4[4], "spec_ms": g4s[0],
         "spec_plain_ms": g4s[1], "spec_bound_ms": g4s[2],
         "rows4_ms": g44[0], "rows4_plain_ms": g44[1],
         "rows4_bound_ms": g44[2],
         **{f"{name}_{key}": gq["k4m_times"][name][i]
            for name in K4_G32_MODES
            for i, key in ((0, "ms"), (1, "plain_ms"), (2, "bound_ms"))}},
        {"name": "ffn_half_step_g32", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_tp.cu",
         "replaces": "voxtral_tpu/ops/decode_tp_pallas.py:818",
         "launches": launches("ffn_half_step_g32")[0],
         "launches_by_path": launches("ffn_half_step_g32")[1],
         "max_abs_err": gq["k45_err"], "ms": g5[0], "plain_ms": g5[1],
         "bound_ms": g5[2], "bound_by": g5[3], "library_ms": None,
         "host_called_ms": g5[4], "rows8_ms": g5s[0],
         "rows8_plain_ms": g5s[1], "rows8_bound_ms": g5s[2],
         "rows4_ms": g54[0], "rows4_plain_ms": g54[1],
         "rows4_bound_ms": g54[2]},
        {"name": "lm_half_argmax_g32", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_tp.cu",
         "fold": "voxtral_tpu_torch/csrc/lm_argmax.cuh",
         "replaces": "voxtral_tpu/ops/decode_tp_pallas.py:1349",
         "launches": launches("lm_half_argmax_g32")[0],
         "launches_by_path": launches("lm_half_argmax_g32")[1],
         "max_abs_err": gq["k6_err"], "ms": g6[0], "plain_ms": g6[1],
         "bound_ms": g6[2], "bound_by": g6[3], "library_ms": None,
         "host_called_ms": g6[4], "rows8_ms": g6s[0],
         "rows8_plain_ms": g6s[1], "rows8_bound_ms": g6s[2]},
        # K1's g32 weight stream (from 5 rows, every linear and the lm
        # fold of a q4g step) alone on the lm table: ms the device time
        # (CUDA graph) at SPEC_K rows, rows{2,64}_ms, fold12_ms; launches
        # the q4g K1 steps that took it.
        {"name": "k1_stream_g32", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/k1_stream.cuh",
         "replaces": "voxtral_tpu/ops/decode_step_pallas.py:1654",
         "modes": ["h", "i"],
         "launches": launches("decode_stack_step_g32_stream")[0],
         "launches_by_path": launches("decode_stack_step_g32_stream")[1],
         "max_abs_err": gs["err"], "ms": gs[SPEC_K][0],
         "plain_ms": gs[SPEC_K][1], "bound_ms": gs[SPEC_K][2],
         "bound_by": gs[SPEC_K][3], "library_ms": None,
         "host_called_ms": gs[SPEC_K][4],
         **{f"rows{r}_{key}": gs[r][i] for r in G32_STREAM_ROWS
            if r != SPEC_K
            for i, key in ((0, "ms"), (1, "plain_ms"), (2, "bound_ms"))},
         "fold12_ms": gs["fold"][0], "fold12_plain_ms": gs["fold"][1],
         "fold12_bound_ms": gs["fold"][2]},
        # K6's g32 fold on K1's weight stream (from 5 rows; phase 13d at
        # SPEC_K rows, the planted ties included).
        {"name": "lm_half_argmax_g32_stream", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/k1_stream.cuh",
         "replaces": "voxtral_tpu/ops/decode_tp_pallas.py:1349",
         "launches": launches("lm_half_argmax_g32_stream")[0],
         "launches_by_path": launches("lm_half_argmax_g32_stream")[1],
         "max_abs_err": gq["k6_err"], "ms": g6s[0], "plain_ms": g6s[1],
         "bound_ms": g6s[2], "bound_by": g6s[3], "library_ms": None,
         "host_called_ms": g6s[4]},
        {"name": "q4_matmul", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/q4_matmul.cu",
         "replaces": "voxtral_tpu/ops/q4_pallas.py:150",
         "launches": launches("q4_matmul")[0],
         "launches_by_path": launches("q4_matmul")[1],
         "max_abs_err": k3_err, "ms": k3t[0], "plain_ms": k3t[1],
         "bound_ms": k3t[2], "bound_by": k3t[3], "library_ms": None,
         "host_called_ms": k3t[4],
         # Every shape: device ms (CUDA graph), host-called ms.
         "shapes_ms": {f"{m}x{n}x{k}": [round(t[0], 5), round(t[4], 5)]
                       for (m, n, k), t in k3_times.items()}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
