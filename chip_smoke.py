#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (voxtral_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. device  — needs ``torch.cuda.is_available()``; prints the card's name
             and power limit as nvidia-smi reports them.
2. build   — nvcc builds voxtral_tpu_torch/csrc/*.cu for sm_90a.
3. kernels — each hand-written kernel against its plain PyTorch version
             on the card, at the main path's shapes, with its time beside
             the plain version's:
             K2 w8_matmul (W8A8 GEMM), K1 decode_stack_step (one full
             26-layer decode step + lm_head) in mode (a) at one row,
             mode (b) spec=8 at 1 and 8 streams (8 and 64 rows, distinct
             per-stream offsets) and mode (c) (an offset per row, spec=1,
             4 rows).
4. main    — Voxtral Mini 4B at full width with random w8 weights (seed
             0): TranscribePipeline.transcribe_samples on a 16 s chirp,
             through the kernels, sequential and then speculative
             (PipelineConfig(speculative=8), draft "ngram" and "pad"),
             each run with the launch counters reset just before and read
             just after; then the same pipelines through the plain
             versions.  Tokens must be identical (near-tie rule), and
             every speculative pass is one K1 launch.  Then three mels
             (x, 0.9 x, 1.1 x) through transcribe_streaming_batch with
             speculative=4 against the sequential batch.
5. numbers — RTF, decode ms/token, the weight-stream bandwidth of the
             decode step, passes and tokens per pass, peak GPU memory,
             each beside the card name and power limit.

The script imports the port (``voxtral_tpu_torch``) only, and fails if
``jax`` was loaded by the end of the run.

The second-to-last line of stdout is the kernels' JSON record, the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

AUDIO_SECS = 16.0
SR = 16000

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
SPEC_K = 8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


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


def in_turns(kernel_fn, plain_fn, iters: int, plain_iters: int):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, plain_iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def chirp() -> np.ndarray:
    """The 16 s speech-band chirp of bench.py."""
    t = np.arange(int(AUDIO_SECS * SR)) / SR
    return (0.5 * np.sin(2 * np.pi * (200 + 150 * t) * t)).astype(np.float32)


def check_k2(dev, card):
    """K2 at the main path's shapes -> (max abs err, ms, plain ms)."""
    import torch

    from voxtral_tpu_torch.ops import w8_kernel as k2

    # (M, K, N): lm_head after prefill; prefill wq; encoder w1 and w2
    # (608 positions for 16 s); adapter w1 (152 positions); ADA w0 / w2.
    shapes = [(1, 3072, 131072), (38, 3072, 4096), (608, 1280, 5120),
              (608, 5120, 1280), (152, 5120, 3072), (1, 3072, 32),
              (1, 32, 3072)]
    gen = torch.Generator(device=dev).manual_seed(0)
    worst, times = 0.0, {}
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
        ms, plain_ms = in_turns(lambda: k2.w8_matmul(xq, sx, codes, scale),
                                lambda: k2.w8_matmul_plain(xq, sx, codes,
                                                           scale), 20, 3)
        times[(m, k, n)] = (ms, plain_ms)
        gbs = (m * k + n * k) / ms / 1e6
        print(f"K2 w8_matmul M={m} K={k} N={n}: max_abs_err {err:.3e} "
              f"(bit-equal {torch.equal(got, ref)}), kernel {ms:.4f} ms "
              f"({gbs:.1f} GB/s of int8 operands), plain {plain_ms:.4f} ms "
              f"[{card}]", flush=True)
    return worst, times


def check_k1(model, dev, card):
    """One full decode step (26 layers + lm_head) on the model's fused
    weights, cache S=240 at offset 235, against the plain version."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    cfg = model.config.language_model
    fused = model.fused_decode
    dec = model.params["decoder"]
    L, D, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    S, off = 240, 235
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = (L, 1, cfg.n_kv_heads, S, hd)
    kc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    x = torch.randn((1, D), device=dev, generator=gen)
    ada = k1.ada_vectors(dec, model.t_embed(6.0))
    c, s = k1.rope_pair_vectors(off, hd, cfg.rope_theta, device=dev)
    emb = dec["tok_embeddings"]["w8"]
    args = (x, off, fused["attn_norm"], fused["ffn_norm"], ada,
            fused["sqkv"], fused["so"], fused["s13"], fused["s2"], c, s,
            kc, vc, fused["wqkv"], fused["wo"], fused["w13"], fused["w2"],
            dec["norm"].float(), emb["codes"], emb["scale"])
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
              eps=cfg.norm_eps, window=cfg.sliding_window)
    got = k1.decode_stack_step(*args, **kw)
    torch.cuda.synchronize()
    ref = k1.decode_stack_step_plain(*args, **kw)
    worst = 0.0
    for name, g, r, tol in zip(("x_out", "k_new", "v_new", "logits"), got,
                               ref, (K1_RTOL, KV_RTOL, KV_RTOL, K1_RTOL)):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        rel = err / r.abs().max().item()
        print(f"K1 decode_stack_step {name}: max_abs_err {err:.3e} "
              f"({rel:.3e} of max, bit-equal {torch.equal(g, r)})",
              flush=True)
        if not rel <= tol:
            fail(f"K1 decode_stack_step {name}: error {rel:.3e} of max > "
                 f"{tol}")
        worst = max(worst, err)
    if got[3].argmax(-1).tolist() != ref[3].argmax(-1).tolist():
        fail("K1 decode_stack_step: argmax differs from the plain version")
    ms, plain_ms = in_turns(lambda: k1.decode_stack_step(*args, **kw),
                            lambda: k1.decode_stack_step_plain(*args, **kw),
                            20, 2)
    nbytes = step_weight_bytes(fused, emb)
    print(f"K1 decode_stack_step L={L} S={S} offset={off}: kernel {ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms; weights {nbytes / 1e9:.4f} GB/step "
          f"-> {nbytes / ms / 1e6:.1f} GB/s [{card}]", flush=True)
    return worst, ms, plain_ms, nbytes


def check_k1_rows(model, dev, card, offs, spec, iters, plain_iters):
    """One K1 step over len(offs) streams x ``spec`` rows with distinct
    per-stream offsets (an int32 device vector) and per-row RoPE, cache
    S = 240 + spec - 1, against the plain version -> (max abs err, ms,
    plain ms)."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    cfg = model.config.language_model
    fused = model.fused_decode
    dec = model.params["decoder"]
    L, D, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    S, bc = 240 + spec - 1, len(offs)
    gen = torch.Generator(device=dev).manual_seed(2 + bc * spec)
    shape = (L, bc, cfg.n_kv_heads, S, hd)
    kc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    x = torch.randn((bc * spec, D), device=dev, generator=gen)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    pos = (off[:, None] + torch.arange(spec, device=dev)).reshape(-1)
    c, s = k1.rope_pair_vectors(pos, hd, cfg.rope_theta, device=dev)
    ada = k1.ada_vectors(dec, model.t_embed(6.0))
    emb = dec["tok_embeddings"]["w8"]
    args = (x, off, fused["attn_norm"], fused["ffn_norm"], ada,
            fused["sqkv"], fused["so"], fused["s13"], fused["s2"], c, s,
            kc, vc, fused["wqkv"], fused["wo"], fused["w13"], fused["w2"],
            dec["norm"].float(), emb["codes"], emb["scale"])
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
              eps=cfg.norm_eps, window=cfg.sliding_window, spec=spec)
    tag = f"K1 decode_stack_step spec={spec} streams={bc} rows={bc * spec}"
    got = k1.decode_stack_step(*args, **kw)
    torch.cuda.synchronize()
    ref = k1.decode_stack_step_plain(*args, **kw)
    worst = 0.0
    for name, g, r, tol in zip(("x_out", "k_new", "v_new", "logits"), got,
                               ref, (K1_RTOL, KV_RTOL, KV_RTOL, K1_RTOL)):
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
    ms, plain_ms = in_turns(lambda: k1.decode_stack_step(*args, **kw),
                            lambda: k1.decode_stack_step_plain(*args, **kw),
                            iters, plain_iters)
    nbytes = step_weight_bytes(fused, emb)
    print(f"{tag} S={S} offsets {offs[0]}..{offs[-1]}: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; weights {nbytes / 1e9:.4f} GB/pass -> "
          f"{nbytes / ms / 1e6:.1f} GB/s [{card}]", flush=True)
    return worst, ms, plain_ms


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


def step_weight_bytes(fused, emb) -> int:
    """Bytes of weights one decode step streams, from the shapes: int8
    codes + f32 row scales of the four stacks and the lm table, plus the
    norm vectors."""
    keys = ("wqkv", "sqkv", "wo", "so", "w13", "s13", "w2", "s2",
            "attn_norm", "ffn_norm")
    total = sum(fused[k].numel() * fused[k].element_size() for k in keys)
    return total + sum(t.numel() * t.element_size()
                       for t in (emb["codes"], emb["scale"]))


def main() -> int:
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an "
             "NVIDIA GPU (there is no CPU fallback)")
    from voxtral_tpu_torch import VoxtralConfig, VoxtralTokenizer
    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.models.voxtral import PREFIX_LEN, VoxtralModel
    from voxtral_tpu_torch.ops import _build
    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.ops import w8_kernel as k2
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline
    from voxtral_tpu_torch.utils.quantize import random_w8_params

    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ------------------------------------------------------------
    lib, build_s = _build.build()
    _build.library()
    print(f"build: {build_s:.2f} s ({lib.name})", flush=True)

    # Full-width random w8 model, built once on the host, moved once.
    cfg = VoxtralConfig.voxtral()
    t0 = time.perf_counter()
    tree = random_w8_params(cfg, seed=0)
    params = params_from_numpy(tree, dev)
    del tree
    model = VoxtralModel(params, cfg, dev)
    plain = VoxtralModel(params, cfg, dev, kernels=False)
    plain.fused_decode = model.fused_decode  # the same stacks, not a copy
    torch.cuda.synchronize()
    print(f"random w8 weights (seed 0) built and moved: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. kernels vs plain -------------------------------------------------
    k2_err, k2_times = check_k2(dev, card)
    k1_err, k1_ms, k1_plain_ms, step_bytes = check_k1(model, dev, card)
    spec8 = check_k1_rows(model, dev, card, [235], SPEC_K, 20, 2)
    spread = [150 + round(i * 85 / 7) for i in range(8)]  # 150 .. 235
    spec64 = check_k1_rows(model, dev, card, spread, SPEC_K, 10, 1)
    rows4 = check_k1_rows(model, dev, card, [60, 120, 180, 235], 1, 20, 2)
    k1_err = max(k1_err, spec8[0], spec64[0], rows4[0])
    print(f"K1 step ms [{card}]: 1 row {k1_ms:.3f}, spec={SPEC_K} 8 rows "
          f"{spec8[1]:.3f}, 64 rows {spec64[1]:.3f}; 4 rows with per-row "
          f"offsets {rows4[1]:.3f}", flush=True)

    # -- 4. main path --------------------------------------------------------
    sig = chirp()
    tok = VoxtralTokenizer([None] * 131072, {}, 131072)
    pipe = TranscribePipeline(model, tok)
    plain_pipe = TranscribePipeline(plain, tok)
    pipe.transcribe_samples(sig, SR)  # warm-up (cuBLAS / cuDNN handles)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    k2.w8_matmul.launches = 0
    k1.decode_stack_step.launches = 0
    t0 = time.perf_counter()
    pipe.transcribe_samples(sig, SR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2_launches = k2.w8_matmul.launches
    k1_launches = k1.decode_stack_step.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    # Token-level checks (same pipeline and input, outside the counted run).
    chunks = pipe._chunk_tokens(sig, SR)
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
    if k1_launches != n_steps:
        fail(f"K1 launches {k1_launches} != decode steps {n_steps}")
    e, lm = cfg.audio_encoder, cfg.language_model
    min_k2 = e.n_layers * 7 + 2 + lm.n_layers * 9
    if k2_launches < min_k2:
        fail(f"K2 launches {k2_launches} < encoder + adapter + prefill "
             f"linears {min_k2}")
    print(f"launch counts in the main-path run: K2 w8_matmul {k2_launches} "
          f"(encoder + adapter + prefill linears: {min_k2}), "
          f"K1 decode_stack_step {k1_launches}", flush=True)

    plain.record_margins = True
    plain_tokens = plain_pipe._chunk_tokens(sig, SR)[0]
    seq_margins = plain.last_margins[0].copy()
    if not np.isfinite(seq_margins).all():
        fail("non-finite logits on the plain path")
    same = first_divergence("sequential kernel vs plain", tokens,
                            plain_tokens, seq_margins, MARGIN_TIE)
    print(f"tokens kernel == plain: {same} ({len(set(tokens.tolist()))} "
          f"distinct; min plain top-2 margin {float(seq_margins.min()):.3e})",
          flush=True)

    # -- 4b. main path, speculative -----------------------------------------
    spec_runs = {}
    for draft in ("ngram", "pad"):
        pcfg = PipelineConfig(speculative=SPEC_K, draft=draft)
        spipe = TranscribePipeline(model, tok, pcfg)
        spipe.transcribe_samples(sig, SR)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        k2.w8_matmul.launches = 0
        k1.decode_stack_step.launches = 0
        t0 = time.perf_counter()
        spipe.transcribe_samples(sig, SR)
        torch.cuda.synchronize()
        s_wall = time.perf_counter() - t0
        s_k2 = k2.w8_matmul.launches
        s_k1 = k1.decode_stack_step.launches
        passes = model.last_spec_passes
        s_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        tag = f"speculative K={SPEC_K} draft={draft}"
        if s_k1 != passes or passes < 1:
            fail(f"{tag}: K1 launches {s_k1} != passes {passes}")
        if s_k2 < min_k2:
            fail(f"{tag}: K2 launches {s_k2} < {min_k2}")
        s_tokens = spipe._chunk_tokens(sig, SR)[0]
        if len(s_tokens) != n_tok:
            fail(f"{tag}: {len(s_tokens)} tokens != {n_tok}")
        same_seq = first_divergence(f"{tag} vs sequential kernel", s_tokens,
                                    tokens, seq_margins, SPEC_MARGIN_TIE)
        plain.record_margins = True
        p_tokens = TranscribePipeline(plain, tok, pcfg)._chunk_tokens(
            sig, SR)[0]
        if not np.isfinite(plain.last_margins).all():
            fail(f"{tag}: non-finite logits on the plain path")
        same_plain = first_divergence(f"{tag} kernel vs plain", s_tokens,
                                      p_tokens, plain.last_margins[0],
                                      MARGIN_TIE)
        spec_runs[draft] = dict(wall=s_wall, k1=s_k1, k2=s_k2,
                                passes=passes, peak=s_peak)
        print(f"{tag}: launch counts K2 w8_matmul {s_k2}, K1 "
              f"decode_stack_step {s_k1} = passes {passes} "
              f"({n_steps / passes:.3f} decode tokens per pass); tokens == "
              f"sequential kernel: {same_seq}, == spec plain: {same_plain}",
              flush=True)

    # -- 4c. batched speculative --------------------------------------------
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

    # -- 5. numbers ----------------------------------------------------------
    t0 = time.perf_counter()
    pipe.mel.compute_log_batch(padded)
    with torch.no_grad():
        model.encode_audio(mel)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    decode_ms_tok = (wall - enc_s) * 1e3 / n_tok
    print(f"RTF {wall / AUDIO_SECS:.5f} ({wall * 1e3:.1f} ms for "
          f"{AUDIO_SECS:.0f} s audio, transcribe_samples end to end) "
          f"[{card}]", flush=True)
    print(f"decode stage {decode_ms_tok:.3f} ms/token (end-to-end time minus "
          f"mel + encoder + adapter {enc_s * 1e3:.1f} ms, over {n_tok} "
          f"tokens, prefill included) [{card}]", flush=True)
    print(f"decode step weight stream: {step_bytes / 1e9:.4f} GB/step / "
          f"{k1_ms:.3f} ms = {step_bytes / k1_ms / 1e6:.1f} GB/s [{card}]",
          flush=True)
    print(f"peak GPU memory (max_memory_allocated) in the main-path run: "
          f"{peak_gb:.3f} GB [{card}]", flush=True)
    for draft, run in spec_runs.items():
        w = run["wall"]
        print(f"speculative K={SPEC_K} draft={draft}: RTF "
              f"{w / AUDIO_SECS:.5f} ({w * 1e3:.1f} ms), decode "
              f"{(w - enc_s) * 1e3 / n_tok:.3f} ms/token, {run['passes']} "
              f"passes, {n_steps / run['passes']:.3f} decode tokens per "
              f"pass, peak GPU memory {run['peak']:.3f} GB [{card}]",
              flush=True)
        per_pass = (w - enc_s) * 1e3 / run["passes"]
        print(f"speculative K={SPEC_K} draft={draft}: {per_pass:.3f} ms per "
              f"pass end to end (prefill included) against a {spec8[1]:.3f}"
              f" ms K1 spec step: {per_pass - spec8[1]:.3f} ms of host work,"
              f" loop-exit sync and other device work per pass [{card}]",
              flush=True)

    jax_mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    if jax_mods:
        fail(f"the port imported jax: {sorted(jax_mods)[:5]}")

    def launches_by_path(key):
        return {"sequential": k1_launches if key == "k1" else k2_launches,
                **{f"speculative_{d}": r[key] for d, r in spec_runs.items()}}

    lm_shape = (1, 3072, 131072)
    record = {"kernels": [
        {"name": "w8_matmul", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/w8_matmul.cu",
         "replaces": "voxtral_tpu/ops/w8_pallas.py:51",
         "launches": k2_launches + sum(r["k2"] for r in spec_runs.values()),
         "launches_by_path": launches_by_path("k2"),
         "max_abs_err": k2_err,
         "ms": k2_times[lm_shape][0], "plain_ms": k2_times[lm_shape][1]},
        {"name": "decode_stack_step", "route": "cuda",
         "source": "voxtral_tpu_torch/csrc/decode_step.cu",
         "replaces": "voxtral_tpu/ops/decode_step_pallas.py:1654",
         "modes": ["a", "b", "c"],
         "launches": k1_launches + sum(r["k1"] for r in spec_runs.values()),
         "launches_by_path": launches_by_path("k1"),
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "spec_ms": spec8[1], "spec_plain_ms": spec8[2],
         "spec64_ms": spec64[1], "spec64_plain_ms": spec64[2]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
