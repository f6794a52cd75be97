"""Complete Voxtral Realtime model: greedy, sampled and speculative
decode (port of ``voxtral_tpu/models/voxtral.py``, on one device or a
mesh).

Weight routes, as the JAX model picks them (``megakernel_mode``):

* w8 leaves -> the fused step, K1 modes (a)-(c);
* unpacked q4 leaves (``q4g``) with ``q4g_geometry_ok`` -> the fused
  step in mode (h), the tied lm_head folded in when the table is q4g;
* dense bf16 leaves -> the fused step in mode (g): the decoder's
  attention and FFN leaves are rewritten once to ``{"nt": w}`` and
  shared with K1's stacks (``fuse_decode_weights_bf16``), the dense
  table folded in as the lm_head;
* a one-shot batch whose geometry K1 refuses (``check_geometry``), or
  whose prefill cache and K1's head-major copy of it would not fit the
  card together (``utils.hbm.check_hbm``), on w8 leaves -> the
  per-layer route: K7 (``ops.decode_step.decode_layer_step``) once per
  layer and position in the position-major prefill cache itself, then
  the final norm and the lm_head through K2 (:func:`oneshot_plan`; JAX
  takes this route when its stack kernel's VMEM budget refuses a merged
  batch, ``models/voxtral.py:291-322``, ``:518-546``);
* packed q4 leaves (``q4``), q4g at other geometries and dense f32
  leaves, and q4g / bf16 batches K1 refuses -> the per-op step: ``decoder_forward_hidden_with_cache`` per
  position, every decoder linear and the lm_head through
  ``models.layers.linear`` / ``decoder.lm_head`` (K3 for packed
  leaves; f32 models compute and cache in f32, as JAX's XLA step);
  speculative decode rides the sequential loop there and on the
  per-layer route, as JAX gates it on the stack kernel;
* a w8 or q4g model, or a bf16 one at tp = 1, on a mesh
  (``VoxtralModel(mesh=)``, ``parallel/``) -> the tensor-parallel step
  (tp > 1: per layer K4 and K5 on every model shard, in g32 for q4g,
  the partial sums added across the shards, then the greedy token from
  K6's vocab-sharded fold, or from the whole lm_head on the first
  device when a q4g stack sits over a table that is not g32 or a
  vocabulary tp does not split; the rows split over the data axis when
  dp > 1) or the data-parallel one (dp >
  1: K1 per data group, mode (i) folding the argmax over a w8, g32 or
  bf16 table), as JAX's ``parallel=`` branches (``models/voxtral.py:
  431-495``, ``:582-680``; JAX sends a meshed bf16 model down its
  GSPMD-partitioned XLA step, ``:824-826``: the same tokens by another
  route); the encoder, adapter, prefill and first token run whole on the
  mesh's first device.

Behaviour kept from the reference:

* prefix of 38 positions: BOS=1 + 37 x ``[STREAMING_PAD]``=32; the first
  generated token comes from position 37's logits;
* per-step input = ``audio_embeds[pos] + embed(prev_token)``;
* greedy argmax (first index of the maximum, as ``jnp.argmax``) at every
  position up to the audio length, or temperature / top-k sampling;
* speculative decode (``speculative=K >= 2``, greedy): each pass drafts
  K tokens per row (bigram table or ``[STREAMING_PAD]``), verifies them
  in one K1 ``spec=K`` step and keeps the exact-greedy prefix, so the
  tokens are the sequential ones for any draft.

The fused sequential decode loop is a Python loop over positions on the
model's device: one K1 stack step (``ops/decode_step.py``) per token,
the K/V append in place, the argmax fed back without a host round trip;
the tokens reach the host once per call.  The speculative loop runs on
the device too, apart from one small device-to-host copy per pass that
decides whether another pass is needed.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Optional

import numpy as np
import torch

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.tokenizer import BOS_TOKEN, STREAMING_PAD
from voxtral_tpu_torch.device import DeviceLike, disable_tf32, resolve_device
from voxtral_tpu_torch.models.adapter import (
    adapter_forward,
    reshape_encoder_output,
)
from voxtral_tpu_torch.models.decoder import (
    create_cache,
    decoder_forward_hidden_with_cache,
    embed_tokens,
    lm_head,
)
from voxtral_tpu_torch.models.encoder import encoder_forward
from voxtral_tpu_torch.models.layers import (
    PLAIN,
    cache_update_layer,
    rms_norm,
    rope_tables,
)
from voxtral_tpu_torch.models.time_embedding import time_embedding
from voxtral_tpu_torch.ops import decode_step as k1
from voxtral_tpu_torch.ops import decode_tp as tpk
from voxtral_tpu_torch.parallel import (
    ParallelPlan,
    dp_decode_stack_step,
    row_groups,
)
from voxtral_tpu_torch.utils.hbm import HBMBudgetError, check_hbm
from voxtral_tpu_torch.utils.profiling import span

Params = dict[str, Any]

log = logging.getLogger("voxtral_tpu_torch")

PREFIX_LEN = 38


def make_prefix_ids() -> np.ndarray:
    """BOS + 37 x [STREAMING_PAD] (38 total)."""
    return np.array([BOS_TOKEN] + [STREAMING_PAD] * (PREFIX_LEN - 1),
                    dtype=np.int32)


# ---------------------------------------------------------------------------
# Speculative-decode helpers
# ---------------------------------------------------------------------------


def ngram_table_init(vocab: int, draft_token: int = STREAMING_PAD,
                     device=None) -> torch.Tensor:
    """Bigram draft table [vocab] int32: entry t = the most recently
    verified continuation of token t, first the ``draft_token`` fallback
    (so an untrained table drafts as the pad policy).  Lives on the
    device; drafting is K - 1 gathers, training one scatter per pass."""
    return torch.full((vocab,), draft_token, dtype=torch.int32,
                      device=device)


def ngram_drafts(table: torch.Tensor, prev: torch.Tensor,
                 K: int) -> torch.Tensor:
    """Chained bigram drafts: d0 = prev, d_{j+1} = table[d_j].
    ``prev`` [] or [B] -> drafts [K] or [B, K]."""
    d = [prev]
    for _ in range(K - 1):
        d.append(table[d[-1].long()])
    return torch.stack(d, dim=-1)


def ngram_train(table: torch.Tensor, drafts: torch.Tensor, y: torch.Tensor,
                live: torch.Tensor) -> None:
    """Train the table in place on one pass: table[drafts[b, j]] = y[b, j]
    for the live rows (``live`` [B] bool); dead rows write nothing.

    Where several writes hit one entry, the write with the highest flat
    index b * K + j wins (JAX's scatter leaves that order undefined).
    Every write to an entry stores the winner's value, so the scatter's
    own order cannot matter, and nothing is read back to the host.
    """
    tgt = drafts.reshape(-1).long()
    val = y.reshape(-1).to(table.dtype)
    flat = torch.arange(tgt.numel(), device=tgt.device)
    prio = torch.where(live[:, None].expand_as(drafts).reshape(-1), flat, -1)
    best = torch.full(table.shape, -1, dtype=flat.dtype, device=tgt.device)
    best.scatter_reduce_(0, tgt, prio, reduce="amax")
    win = best[tgt]
    table.scatter_(0, tgt, torch.where(win >= 0, val[win.clamp(min=0)],
                                       table[tgt]))


def append_rows(cache: torch.Tensor, new: torch.Tensor, offs: torch.Tensor,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row cache append, in place: write ``new[:, i]`` [L, H, hd] at
    slot ``offs[i]`` along the S axis of cache row ``rows[i]`` (default
    ``i``) of ``cache`` [L, Bc, H, S, hd].  Returns ``cache``.  On a
    head+ring cache the caller passes the mapped slots
    (``layers.ring_slot``)."""
    if rows is None:
        rows = torch.arange(new.shape[1], device=new.device)
    cache[:, rows, :, offs.long()] = new.permute(1, 0, 2, 3).to(cache.dtype)
    return cache


def append_scales(arr: torch.Tensor, new: torch.Tensor, offs: torch.Tensor,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row scale append beside :func:`append_rows` on an int8 cache,
    in place: write ``new[:, i]`` [L, H] at slot ``offs[i]`` along the S
    axis of row ``rows[i]`` (default ``i``) of ``arr`` [L, Bc, H, S] (JAX
    ``streaming._append_scales``).  Returns ``arr``."""
    if rows is None:
        rows = torch.arange(new.shape[1], device=new.device)
    arr[:, rows, :, offs.long()] = new.permute(1, 0, 2).to(arr.dtype)
    return arr


def select_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy argmax (first index on ties), or temperature / top-k
    sampling when temperature > 0, drawn from ``generator``.
    logits [B, V] -> int32 [B]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def check_draft(draft: str) -> None:
    if draft not in ("pad", "ngram"):
        raise ValueError(f"draft policy must be pad|ngram, got {draft!r}")


def encode_audio_fn(params: Params, mel: torch.Tensor, cfg: VoxtralConfig,
                    mm=None) -> torch.Tensor:
    """mel [B, n_mels, T] -> audio embeds [B, T/16, llm_dim]."""
    enc = encoder_forward(params["encoder"], mel, cfg.audio_encoder, mm)
    return adapter_forward(params["adapter"],
                           reshape_encoder_output(enc, cfg.downsample_factor),
                           mm)


def transcribe_streaming_fn(params: Params, mel: torch.Tensor,
                            t_embed: torch.Tensor, cfg: VoxtralConfig,
                            fused: Optional[Params], mm=None, step=None,
                            margins: Optional[list] = None, *,
                            temperature: float = 0.0, top_k: int = 0,
                            seed: int = 0, speculative: int = 0,
                            draft: str = "ngram",
                            passes: Optional[list] = None,
                            route: str = "stack", layer_step=None,
                            decode_stats: Optional[dict] = None,
                            mesh_step=None) -> torch.Tensor:
    """Transcription of a batch of mels -> int32 [B, S - 38].

    ``fused``: the stacks of :func:`ops.decode_step.fuse_decode_weights`
    or ``fuse_decode_weights_q4g`` (the K1 step), or None (the per-op
    step).  ``route`` (with fused stacks): "stack", the K1 step over a
    head-major copy of the prefill cache, or "layer", K7 per layer in the
    prefill cache itself (w8 stacks; :func:`oneshot_plan` picks it), or,
    on a mesh, "tp" / "dp": ``mesh_step(cache, slots, ada_vecs,
    logits_too)`` cuts the prefill cache into the shards' head-major
    caches and returns the meshed step (:func:`_tp_step`,
    :func:`_dp_step`).
    ``mm`` / ``step`` / ``layer_step``: the linears' kernels (a
    :class:`~voxtral_tpu_torch.models.layers.Matmuls`), the K1 step and
    the K7 layer step (the kernel wrappers by default; their plain
    versions run the same path without the kernels).  ``temperature`` > 0
    samples (top-k when ``top_k`` > 0) from a generator seeded with
    ``seed``.  ``speculative=K >= 2`` (greedy only, at least one decode
    position, the stack route) verifies K drafted tokens per pass with
    ``draft`` "ngram" or "pad"; sampling and the other routes ride the
    sequential loop.  ``margins``, when a list, receives the top-2 logit
    margin [B] of every position (diagnostics for near-tie flips);
    ``passes``, when a list, receives the number of speculative passes;
    ``decode_stats``, when a dict, receives "seconds", the wall time of
    everything after the first token (the decode loop, the stack route's
    cache copy included, synchronized at both ends), and on the card
    "extra_bytes", the most memory allocated in that time above what was
    allocated when it began (the peak statistics are reset there).
    """
    check_draft(draft)
    step = step or k1.decode_stack_step
    lm_cfg = cfg.language_model
    dev = mel.device
    dec = params["decoder"]

    audio_embeds = encode_audio_fn(params, mel, cfg, mm)  # [B, S, D]
    batch, seq_len = audio_embeds.shape[0], audio_embeds.shape[1]
    prefix_ids = torch.as_tensor(make_prefix_ids(), device=dev).long()
    prefix_inputs = (audio_embeds[:, :PREFIX_LEN, :]
                     + embed_tokens(dec, prefix_ids[None].expand(batch, -1)))

    # The cache takes the compute dtype (bf16; f32 for f32 models).
    cache = create_cache(lm_cfg, batch, seq_len, audio_embeds.dtype,
                         device=dev)
    rope = rope_tables(lm_cfg.head_dim, seq_len, lm_cfg.rope_theta, device=dev)
    # Prefill: fills cache positions 0..37, predicts the token at 38.
    hidden, cache = decoder_forward_hidden_with_cache(
        dec, prefix_inputs, t_embed, cache, lm_cfg, rope, mm=mm)
    logits = lm_head(dec, hidden[:, -1, :], mm=mm)  # [B, V]

    gen = None
    if temperature > 0.0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    token = select_token(logits, gen, temperature, top_k)
    if margins is not None:
        margins.append(top2_margin(logits))
    if decode_stats is not None:
        base = _decode_mark(dev)
        t0 = _clock(dev)

    if fused is None and mesh_step is None:
        tokens = _per_op_decode(dec, audio_embeds, t_embed, token, cache,
                                rope, lm_cfg, mm, gen, temperature, top_k,
                                margins)
    elif route == "layer":
        tokens = _layer_decode(layer_step or k1.decode_layer_step, dec,
                               fused, k1.ada_vectors(dec, t_embed, mm),
                               audio_embeds, token, cache, lm_cfg, mm, gen,
                               temperature, top_k, margins)
    else:
        K = speculative
        spec = K >= 2 and temperature <= 0.0 and seq_len - PREFIX_LEN > 1
        slots = seq_len + (K - 1 if spec else 0)
        ada_vecs = k1.ada_vectors(dec, t_embed, mm)
        if route in ("tp", "dp"):
            run = mesh_step(cache, slots, ada_vecs,
                            margins is not None or temperature > 0.0)
        else:
            run = _stack_step(
                fused_step_fn(dec, fused, ada_vecs, lm_cfg, mm, step),
                *_head_major(cache, slots))
        del cache  # the steps read their copies: the prefill cache goes now
        tokens = _stack_decode(run, dec, audio_embeds, token, slots, lm_cfg,
                               gen, temperature, top_k, K if spec else 0,
                               draft, margins, passes)
    if decode_stats is not None:
        decode_stats["seconds"] = _clock(dev) - t0
        if dev.type == "cuda":
            decode_stats["extra_bytes"] = (
                torch.cuda.max_memory_allocated(dev) - base)
    return tokens


def _clock(dev) -> float:
    """Host seconds after the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _decode_mark(dev) -> int:
    """Bytes allocated on the card now, the peak statistics reset to it
    (0 on the CPU)."""
    if dev.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _head_major(cache, slots: int):
    """Head-major copies [L, B, Hkv, slots, hd] of the prefilled
    position-major cache [L, B, S, Hkv, hd] for K1; slots past S (the
    speculative loop's K - 1 slot tail) are zero."""
    L, batch, S, n_kv, hd = cache.k.shape
    k_cache = torch.zeros((L, batch, n_kv, slots, hd), dtype=cache.k.dtype,
                          device=cache.k.device)
    v_cache = torch.zeros_like(k_cache)
    k_cache[:, :, :, :S] = cache.k.permute(0, 1, 3, 2, 4)
    v_cache[:, :, :, :S] = cache.v.permute(0, 1, 3, 2, 4)
    return k_cache, v_cache


def _stack_step(run_step, k_cache: torch.Tensor, v_cache: torch.Tensor):
    """The K1 route's step on the head-major caches (:func:`_head_major`):
    ``step(x, off, cos, sin, at=None, stream=None, spec=1) -> (logits,
    None)``, the fresh K / V appended in place (at slot ``off``, or at the
    rows' positions ``at`` of their streams ``stream`` under spec): the
    step reads slots below its offsets only, so the appends leave its
    inputs as they were."""

    def step(x, off, cos, sin, at=None, stream=None, spec=1):
        _, k_new, v_new, logits = run_step(x, off, cos, sin, k_cache,
                                           v_cache, spec=spec)
        if spec == 1:
            k_cache[:, :, :, off] = k_new
            v_cache[:, :, :, off] = v_new
        else:
            append_rows(k_cache, k_new, at, stream)
            append_rows(v_cache, v_new, at, stream)
        return logits, None

    return step


def _stack_decode(step, dec: Params, audio_embeds: torch.Tensor,
                  first: torch.Tensor, slots: int, lm_cfg, gen,
                  temperature: float, top_k: int, K: int, draft: str,
                  margins: Optional[list],
                  passes: Optional[list]) -> torch.Tensor:
    """The fused routes of :func:`transcribe_streaming_fn` over caches of
    ``slots`` slots (a K - 1 slot tail when ``K`` >= 2 runs the
    speculative loop, whose last pass appends K rows at slots up to
    seq_len + K - 2): one ``step`` per position (:func:`_stack_step`,
    :func:`_tp_step`, :func:`_dp_step`: each returns the logits, the
    greedy tokens, or both), or the speculative loop.
    -> int32 [B, n_steps + 1]."""
    dev = audio_embeds.device
    batch, seq_len = audio_embeds.shape[0], audio_embeds.shape[1]
    n_steps = seq_len - PREFIX_LEN - 1
    cos_t, sin_t = k1.rope_pair_vectors(
        torch.arange(slots, device=dev), lm_cfg.head_dim, lm_cfg.rope_theta)
    if K >= 2:
        return _spec_decode(step, dec, audio_embeds, first, cos_t, sin_t, K,
                            draft == "ngram", lm_cfg.vocab_size, margins,
                            passes)

    token = first
    tokens = torch.empty((batch, n_steps + 1), dtype=torch.int32, device=dev)
    tokens[:, 0] = token
    for i in range(n_steps):
        off = PREFIX_LEN + i
        text = embed_tokens(dec, token.long()[:, None])  # [B, 1, D]
        x = (audio_embeds[:, off:off + 1, :] + text)[:, 0, :].float()
        logits, token = step(x, off, cos_t[off], sin_t[off])
        if token is None:
            token = select_token(logits, gen, temperature, top_k)
        tokens[:, i + 1] = token
        if margins is not None:
            margins.append(top2_margin(logits))
    return tokens


def _layer_decode(layer_step, dec: Params, fused: Params,
                  ada_vecs: torch.Tensor, audio_embeds: torch.Tensor,
                  first: torch.Tensor, cache, lm_cfg, mm, gen,
                  temperature: float, top_k: int,
                  margins: Optional[list]) -> torch.Tensor:
    """The per-layer route (JAX ``layer_body``, ``models/voxtral.py:
    518-546``): per position, one K7 call per layer on the position-major
    prefill cache [L, B, S, Hkv, hd], each followed by its append; then
    the final norm and the lm_head (K2: K7 folds no lm_head).
    -> int32 [B, n_steps + 1]."""
    batch, seq_len = audio_embeds.shape[0], audio_embeds.shape[1]
    n_steps = seq_len - PREFIX_LEN - 1
    kw = dict(n_heads=lm_cfg.n_heads, n_kv=lm_cfg.n_kv_heads,
              head_dim=lm_cfg.head_dim, eps=lm_cfg.norm_eps,
              window=lm_cfg.sliding_window)
    cos_t, sin_t = k1.rope_pair_vectors(
        torch.arange(seq_len, device=audio_embeds.device), lm_cfg.head_dim,
        lm_cfg.rope_theta)
    # Each layer's own vectors and cache views, cut once.
    per_layer = [
        (fused["attn_norm"][l], fused["ffn_norm"][l], ada_vecs[l],
         fused["sqkv"][l], fused["so"][l], fused["s13"][l], fused["s2"][l])
        for l in range(cache.k.shape[0])]
    caches = list(zip(cache.k, cache.v))
    stacks = (fused["wqkv"], fused["wo"], fused["w13"], fused["w2"])
    tokens = torch.empty((batch, n_steps + 1), dtype=torch.int32,
                         device=audio_embeds.device)
    tokens[:, 0] = first
    token = first
    for i in range(n_steps):
        off = PREFIX_LEN + i
        text = embed_tokens(dec, token.long()[:, None])  # [B, 1, D]
        x = (audio_embeds[:, off:off + 1, :] + text)[:, 0, :].float()
        cos, sin = cos_t[off], sin_t[off]
        for l, (vecs, (k_l, v_l)) in enumerate(zip(per_layer, caches)):
            x, k_new, v_new = layer_step(x, l, off, *vecs, cos, sin, k_l,
                                         v_l, *stacks, **kw)
            # K7 reads slots < off only: the append in place at off
            # leaves its inputs as they were.
            cache_update_layer(k_l, v_l, k_new[:, None], v_new[:, None],
                               off)
        logits = lm_head(dec, rms_norm(x, dec["norm"], lm_cfg.norm_eps),
                         mm=mm)
        token = select_token(logits, gen, temperature, top_k)
        tokens[:, i + 1] = token
        if margins is not None:
            margins.append(top2_margin(logits))
    return tokens


def fused_step_fn(dec: Params, fused: Params, ada_vecs: torch.Tensor, lm_cfg,
                  mm=None, step=None):
    """The K1 step with the model's stacks bound: ``run(x, off, cos, sin,
    k_cache, v_cache, spec=1, ring=None, **cache_kw) -> (x_out, k_new,
    v_new, logits)``.  ``step``: the kernel wrapper (default) or its plain
    version; ``ring``: the head+ring cache layout (mode (d));
    ``cache_kw``: ``k_scales`` / ``v_scales`` (mode (e)) and
    ``cache_chunk`` (mode (f))."""
    step = step or k1.decode_stack_step
    step_kw = dict(n_heads=lm_cfg.n_heads, n_kv=lm_cfg.n_kv_heads,
                   head_dim=lm_cfg.head_dim, eps=lm_cfg.norm_eps,
                   window=lm_cfg.sliding_window)
    lm_kw = _lm_fold(dec, fused)

    def run_step(x, off, cos, sin, k_cache, v_cache, spec=1, ring=None,
                 **cache_kw):
        out = step(x, off, fused["attn_norm"], fused["ffn_norm"], ada_vecs,
                   fused["sqkv"], fused["so"], fused["s13"], fused["s2"],
                   cos, sin, k_cache, v_cache, fused["wqkv"], fused["wo"],
                   fused["w13"], fused["w2"], spec=spec, ring=ring, **lm_kw,
                   **cache_kw, **step_kw)
        if lm_kw:
            return out
        # No lm fold (a q4g stack over another table): the final norm and
        # the lm_head run after the step, as in JAX.
        x_out, k_new, v_new = out
        hidden = rms_norm(x_out, dec["norm"], lm_cfg.norm_eps)
        return x_out, k_new, v_new, lm_head(dec, hidden, mm=mm)

    return run_step


def _lm_fold(dec: Params, fused: Params) -> dict:
    """The step's lm-fold arguments: the w8 table (row scales), the q4g
    table (group scales, from ``fuse_decode_weights_q4g``) or the dense
    table in bf16 (mode (g), no scale); none when a q4g stack sits over a
    table it cannot fold."""
    fold = dict(final_norm=dec["norm"].float())
    emb = dec["tok_embeddings"]
    if fused["sqkv"] is None:  # mode (g): dense bf16 stacks
        return dict(fold, lm_codes=emb.to(torch.bfloat16), lm_scale=None)
    if fused["sqkv"].dim() == 3:  # g32 stacks
        if "lm_codes" not in fused:
            return {}
        return dict(fold, lm_codes=fused["lm_codes"],
                    lm_scale=fused["lm_scale"])
    return dict(fold, lm_codes=emb["w8"]["codes"], lm_scale=emb["w8"]["scale"])


def _per_op_decode(dec: Params, audio_embeds: torch.Tensor,
                   t_embed: torch.Tensor, first: torch.Tensor, cache,
                   rope, lm_cfg, mm, gen, temperature: float, top_k: int,
                   margins: Optional[list]) -> torch.Tensor:
    """The per-op sequential loop (JAX ``transcribe_streaming_fn``'s
    ``else`` step, ``models/voxtral.py:547-563``): per position, the
    decoder layers op by op over the prefilled [L, B, S, Hkv, hd] cache,
    then the lm_head.  -> int32 [B, n_steps + 1]."""
    batch, seq_len = audio_embeds.shape[0], audio_embeds.shape[1]
    n_steps = seq_len - PREFIX_LEN - 1
    tokens = torch.empty((batch, n_steps + 1), dtype=torch.int32,
                         device=audio_embeds.device)
    tokens[:, 0] = first
    token = first
    for i in range(n_steps):
        off = PREFIX_LEN + i
        text = embed_tokens(dec, token.long()[:, None])  # [B, 1, D]
        hidden, cache = decoder_forward_hidden_with_cache(
            dec, audio_embeds[:, off:off + 1, :] + text, t_embed, cache,
            lm_cfg, rope, mm=mm)
        logits = lm_head(dec, hidden[:, 0, :], mm=mm)
        token = select_token(logits, gen, temperature, top_k)
        tokens[:, i + 1] = token
        if margins is not None:
            margins.append(top2_margin(logits))
    return tokens


def _spec_decode(step, dec: Params, audio_embeds: torch.Tensor,
                 first: torch.Tensor, cos_t: torch.Tensor,
                 sin_t: torch.Tensor, K: int, ngram: bool, vocab: int,
                 margins: Optional[list],
                 passes: Optional[list]) -> torch.Tensor:
    """The speculative loop of :func:`transcribe_streaming_fn` (JAX
    ``spec_body``): per pass, draft K tokens per row, verify them in one
    ``spec=K`` step (which appends all K fresh K/V rows), keep the
    exact-greedy prefix, train the bigram table.  Each row advances by its own
    accepted count; finished rows ride along with their position frozen
    and write only past their last token.  -> int32 [B, n_steps + 1]."""
    dev = audio_embeds.device
    batch, seq_len, dim = audio_embeds.shape
    n_steps = seq_len - PREFIX_LEN - 1
    # Input row of generated index i = audio_embeds[PREFIX_LEN + i] +
    # embed(token_i); K copies of the last row keep every slice of a
    # pass (finished rows included) in bounds.
    inputs = audio_embeds[:, PREFIX_LEN:PREFIX_LEN + n_steps, :]
    inputs = torch.cat([inputs, inputs[:, -1:].expand(-1, K, -1)], dim=1)
    rows = torch.arange(batch, device=dev)
    stream = rows.repeat_interleave(K)  # the stream of each step row
    slot = torch.arange(K, device=dev)
    pos = torch.zeros((batch,), dtype=torch.long, device=dev)
    prev = first
    toks = torch.zeros((batch, n_steps + K), dtype=torch.int32, device=dev)
    marg = (torch.zeros((batch, n_steps + K), device=dev)
            if margins is not None else None)
    table = ngram_table_init(vocab, device=dev) if ngram else None
    pad = torch.full((batch, K - 1), STREAMING_PAD, dtype=torch.int32,
                     device=dev)
    n_pass = 0
    # JAX's while_loop tests any(pos < n_steps) on the device; here the
    # host reads that one bool per pass (a small device-to-host copy,
    # which waits for the pass to finish).
    while bool((pos < n_steps).any()):
        offs = PREFIX_LEN + pos  # [B] absolute position of slot 0
        drafts = (ngram_drafts(table, prev, K) if ngram
                  else torch.cat([prev[:, None], pad], dim=1))
        idx = pos[:, None] + slot  # [B, K] generated indices
        text = embed_tokens(dec, drafts.long())  # [B, K, D]
        x = (inputs[rows[:, None], idx] + text).reshape(batch * K, dim)
        at = (offs[:, None] + slot).reshape(-1)  # per-row positions
        # The step appends all K fresh rows at offs + j, in place: it
        # read slots < offs only, and rows past the accepted count stay
        # invisible (masked by the offsets) until later appends overwrite
        # them.
        logits, y = step(x.float(), offs.to(torch.int32), cos_t[at],
                         sin_t[at], at, stream, K)
        if y is None:
            y = select_token(logits)
        y = y.reshape(batch, K)
        # Exact-greedy acceptance: y[:, j] is valid iff every earlier
        # draft matched its verified token; y[:, 0] always is.
        match = (y[:, :K - 1] == drafts[:, 1:]).to(torch.int32)
        n_acc = 1 + torch.cumprod(match, dim=1).sum(dim=1)
        live = pos < n_steps
        adv = torch.where(live, torch.minimum(n_acc, n_steps - pos), 0)
        toks.scatter_(1, idx, y)
        if marg is not None:
            marg.scatter_(1, idx, top2_margin(logits).reshape(batch, K))
        picked = y.gather(1, (adv - 1).clamp(0, K - 1)[:, None])[:, 0]
        prev = torch.where(adv > 0, picked, prev)
        if ngram:
            ngram_train(table, drafts, y, live)
        pos = pos + adv
        n_pass += 1
    if passes is not None:
        passes.append(n_pass)
    if margins is not None:
        margins.extend(marg[:, :n_steps].unbind(dim=1))
    return torch.cat([first[:, None], toks[:, :n_steps]], dim=1)


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


# ---------------------------------------------------------------------------
# The meshed routes (tensor and data parallelism in one process)
# ---------------------------------------------------------------------------


def _head_major_shards(cache, slots: int, plan: ParallelPlan,
                       groups: list[slice]):
    """Each shard's head-major copies [L, B_d, Hkv / tp, slots, hd] of the
    prefilled position-major cache [L, B, S, Hkv, hd]: data group d's
    streams and model shard i's KV heads, on ``mesh.devices[d][i]``;
    slots past S (the speculative tail) zero.  -> (K grid, V grid)."""
    L, _, S, n_kv, hd = cache.k.shape
    kl = n_kv // plan.tp

    def one(t, rows, i, dev):
        out = torch.zeros((L, rows.stop - rows.start, kl, slots, hd),
                          dtype=t.dtype, device=dev)
        out[:, :, :, :S] = t[:, rows, :, i * kl:(i + 1) * kl].permute(
            0, 1, 3, 2, 4).to(dev)
        return out

    return tuple([[one(t, rows, i, dev)
                   for i, dev in enumerate(plan.mesh.devices[d])]
                  for d, rows in enumerate(groups)]
                 for t in (cache.k, cache.v))


def _append_grid(grid, new, off, at, stream, groups, spec: int) -> None:
    """Append each shard's fresh K or V ([L, rows_d, Hkv_l, hd]) into its
    cache, in place: at slot ``off`` (spec = 1), or each row at its
    position ``at`` in its stream (``stream``, the batch's numbering) of
    the group."""
    for d, g in enumerate(groups):
        rows = slice(g.start * spec, g.stop * spec)
        for cache, n in zip(grid[d], new[d]):
            if spec == 1:
                cache[:, :, :, off] = n
            else:
                append_rows(cache, n, at[rows].to(cache.device),
                            (stream[rows] - g.start).to(cache.device))


def _tp_step(model, dec: Params, ada_vecs, lm_cfg, mm, k_sh, v_sh,
             groups, logits_too: bool, greedy: bool):
    """The TP route's step (JAX's ``use_tp`` branches, ``models/voxtral.py:
    431-468``, ``:634-663``): :func:`ops.decode_tp.tp_decode_step` over
    the shards' caches, the appends, then :func:`mesh_lm_head` (the
    greedy token from the vocab-sharded fold, the whole lm_head on the
    mesh's first device for sampling, the margins or a table that does
    not fold).  Data groups split the rows when dp > 1."""
    plan, placed, kern = model.parallel, model.fused_tp, model.kernels
    kw = dict(n_heads=lm_cfg.n_heads, n_kv=lm_cfg.n_kv_heads,
              head_dim=lm_cfg.head_dim, eps=lm_cfg.norm_eps,
              window=lm_cfg.sliding_window,
              attn=tpk.attn_half_step if kern else tpk.attn_half_step_plain,
              ffn=tpk.ffn_half_step if kern else tpk.ffn_half_step_plain)

    def step(x, off, cos, sin, at=None, stream=None, spec=1):
        xo, kn, vn = tpk.tp_decode_step(
            plan.mesh, x, off, model._tp_norms[0], model._tp_norms[1],
            ada_vecs, placed, cos, sin, k_sh, v_sh, spec=spec, **kw)
        _append_grid(k_sh, kn, off, at, stream, groups, spec)
        _append_grid(v_sh, vn, off, at, stream, groups, spec)
        return mesh_lm_head(model, plan.mesh, xo, placed, None, greedy,
                            logits_too)

    return step


def _dp_step(model, ada_vecs, lm_cfg, k_g, v_g, groups, logits_too: bool,
             greedy: bool):
    """The DP route's step (JAX ``use_dp``, ``models/voxtral.py:482-495``,
    ``:673-679``): :func:`parallel.dp_decode_stack_step`, each data group's
    K1 on its rows with the lm fold, then the appends.  Greedy without
    the margins, K1 mode (i) folds the argmax (the token, no logits; over
    a w8 or a g32 table); otherwise the fold returns the logits
    (:func:`mesh_lm_head`, which also takes a table that does not fold)."""
    st = model._dp_stacks
    fold = [st.get(k) for k in ("final_norm", "lm_codes", "lm_scale")]
    kw = dict(n_heads=lm_cfg.n_heads, n_kv=lm_cfg.n_kv_heads,
              head_dim=lm_cfg.head_dim, eps=lm_cfg.norm_eps,
              window=lm_cfg.sliding_window,
              lm_argmax=greedy and not logits_too and fold[1] is not None,
              step=model._step)

    def step(x, off, cos, sin, at=None, stream=None, spec=1):
        xo, kn, vn, *last = dp_decode_stack_step(
            model.parallel.mesh, x, off, st["attn_norm"], st["ffn_norm"],
            ada_vecs, st["sqkv"], st["so"], st["s13"], st["s2"], cos, sin,
            k_g, v_g, st["wqkv"], st["wo"], st["w13"], st["w2"], *fold,
            spec=spec, **kw)
        _append_grid([[c] for c in k_g], [[n] for n in kn], off, at, stream,
                     groups, spec)
        _append_grid([[c] for c in v_g], [[n] for n in vn], off, at, stream,
                     groups, spec)
        return mesh_lm_head(model, model.parallel.mesh, xo, st, last,
                            greedy, logits_too)

    return step


def mesh_lm_head(model, mesh, xo: torch.Tensor, table: Params,
                 folded: Optional[list], greedy: bool, logits_too: bool):
    """The lm head after a meshed decode step, for the one-shot steps and
    the streaming decoders -> (logits [rows, V] or None, greedy tokens
    [rows] int32 or None).  ``folded``: on a data-parallel mesh, what
    the data groups' K1 returned beside x_out (K1 mode (i)'s tokens
    [rows, 1] int32, or the logits; empty when ``table`` has none to
    fold); None on a tp mesh, where K6 folds the greedy token over
    ``table``'s vocab shards.  A q4g stack over a table that is not g32
    has no fold (JAX without ``"lm_codes"``, ``models/voxtral.py:
    446-468``): the logits then come from the whole lm_head on the
    mesh's first device, as they do for sampling and the margins
    (``logits_too``), and the caller picks the token."""
    dec, eps = model.params["decoder"], model.config.language_model.norm_eps
    logits = token = None
    if folded:
        if folded[0].dtype == torch.int32:
            token = folded[0][:, 0]
        else:
            logits = folded[0]
    elif folded is None and greedy and "lm_codes" in table:
        half = (tpk.lm_half_argmax if model.kernels
                else tpk.lm_half_argmax_plain)
        token = tpk.tp_lm_head_token(mesh, xo, dec["norm"],
                                     table["lm_codes"], table["lm_scale"],
                                     eps=eps, half=half)
    if logits is None and (logits_too or token is None):
        logits = lm_head(dec, rms_norm(xo, dec["norm"], eps), mm=model._mm)
    return logits, token


def _mesh_plan(model, plan: ParallelPlan, batch: int, seq_len: int,
               spec: int):
    """:func:`oneshot_plan`'s rung on a mesh: "tp" (tp > 1, a data axis
    when dp > 1) or "dp", when the shard's geometry is taken (K4's
    attention block, or K1's, at the local shard; the shard divisibility)
    and ``check_hbm`` admits each shard's caches on its own device (the
    first also holds the prefill cache).  Otherwise
    it raises: a mesh never falls back to one device."""
    lm = model.config.language_model
    slots = seq_len + (spec - 1 if spec > 1 else 0)
    route = "tp" if plan.tp > 1 else "dp"
    what = (f"a one-shot batch of {batch} rows x {seq_len} positions on a "
            f"{plan.dp} x {plan.tp} mesh")
    try:
        if route == "tp":
            tpk.check_tp_geometry(slots, lm.head_dim, lm.sliding_window,
                                  spec, lm.n_kv_heads, lm.hidden_dim,
                                  plan.tp)
        else:
            k1.check_geometry(slots, lm.head_dim, lm.sliding_window, spec)
        # The shards' head-major copies (each data group's rows, split
        # over the model shards' KV heads), and the prefill cache on the
        # mesh's first device.
        rows = -(-batch // plan.dp)
        check_hbm(model, plan.dp * oneshot_cache_bytes(model, rows, slots),
                  f"{what}, prefill cache + the shards' head-major copies",
                  batch, dp=plan.dp,
                  first_bytes=oneshot_cache_bytes(model, batch, seq_len))
    except (ValueError, HBMBudgetError) as exc:
        raise type(exc)(f"no decode route takes {what} -- {route}: "
                        f"{exc}") from exc
    return route, (f"{route}: the shards' geometry is taken and their "
                   "caches fit")


def oneshot_cache_bytes(model, batch: int, slots: int) -> int:
    """Bytes of one decoder K + V cache of ``batch`` rows x ``slots``
    positions in the model's cache dtype."""
    lm = model.config.language_model
    item = torch.empty((), dtype=model.cache_dtype).element_size()
    return (2 * lm.n_layers * batch * slots * lm.n_kv_heads * lm.head_dim
            * item)


def oneshot_plan(model, batch: int, seq_len: int, spec: int = 1):
    """The decode route of a one-shot batch -> (route, reason).

    The port's counterpart of JAX's VMEM gate (``models/voxtral.py:
    291-322``), a ladder of rungs:

    * "stack": K1, when ``check_geometry`` takes the cache (``seq_len``
      slots, plus ``spec - 1`` for a speculative batch) and ``check_hbm``
      admits the prefill cache together with K1's head-major copy of it;
    * "layer": K7 on the prefill cache itself (one copy), when K1 is
      refused, for w8 stacks (JAX's K7 is w8-only);
    * "per_op": a model without fused stacks, or q4g / bf16 stacks K1
      refuses, when one copy fits;
    * on a mesh (``model.parallel``, dp x tp > 1), "tp" or "dp" and
      nothing else (:func:`_mesh_plan`).

    ``reason`` names each refusal on the way.  When even one copy does
    not fit, the last rung's exception is raised with every refusal.  No
    argument selects a rung: tests force one by replacing this function.
    """
    plan = model.parallel
    if plan is not None and plan.dp * plan.tp > 1:
        return _mesh_plan(model, plan, batch, seq_len, spec)
    one = oneshot_cache_bytes(model, batch, seq_len)
    what = f"a one-shot batch of {batch} rows x {seq_len} positions"
    if model.fused_decode is None:
        check_hbm(model, one, what, batch)
        return "per_op", f"{model.decode_route} weights have no fused step"
    lm = model.config.language_model
    slots = seq_len + (spec - 1 if spec > 1 else 0)
    try:
        k1.check_geometry(slots, lm.head_dim, lm.sliding_window, spec)
        check_hbm(model, one + oneshot_cache_bytes(model, batch, slots),
                  f"{what}, prefill cache + K1's head-major copy", batch)
        return "stack", "K1 takes the geometry and both cache copies fit"
    except (ValueError, HBMBudgetError) as exc:
        refused = [f"stack (K1): {exc}"]
    route = "layer" if model.decode_route == "w8" else "per_op"
    try:
        if route == "layer":
            k1.check_layer_geometry(seq_len, lm.head_dim, lm.sliding_window)
        check_hbm(model, one, f"{what}, prefill cache", batch)
    except (ValueError, HBMBudgetError) as exc:
        refused.append(f"{route} ({'K7' if route == 'layer' else 'no K1'}): "
                       f"{exc}")
        raise type(exc)("no decode route takes " + what + " -- "
                        + "; ".join(refused)) from exc
    return route, "; ".join(refused)


def _per_group(t, mesh):
    """One copy of a replicated stack per data group, on the group's
    device (``mesh.devices[d][0]``): ``.to`` is the tensor itself on the
    device it lies on, so groups sharing a card share the stacks; a tuple
    of segments (mode (g)'s qkv and w13) becomes one tuple per group;
    None (mode (g)'s scale keys) stays None."""
    if t is None:
        return None
    if isinstance(t, tuple):
        return [tuple(seg.to(row[0]) for seg in t) for row in mesh.devices]
    return [t.to(row[0]) for row in mesh.devices]


class VoxtralModel:
    """Parameter tree + config on one device: greedy, sampled and
    speculative decode.

    ``params``: the port's tensor tree (see ``convert.params_from_numpy``)
    with w8, q4 (packed or unpacked) or dense (bf16 / f32) decoder
    layers; the route follows the JAX model (module docstring).  A dense
    bf16 tree's decoder leaves are rewritten in place to ``{"nt": w}``
    (memory-neutral, as JAX does).  ``device``: where the tree lives
    (``None``: the card).  ``kernels=False`` runs the same path through
    the plain PyTorch versions of the kernels (for comparison on the
    card; on the CPU the kernel wrappers take the plain versions anyway).

    ``mesh`` (``parallel.make_mesh``; w8 and q4g trees, bf16 at tp = 1):
    the one-shot decode runs tensor-parallel (tp > 1: the K4 / K5 halves
    per model shard, in g32 for q4g, and the vocab-sharded K6 fold, the
    rows split over the data axis when dp > 1) or data-parallel (dp > 1:
    K1 per data group, each group's stacks on its device), as the JAX
    model's ``mesh=`` does (``models/voxtral.py:863-964``).  A q4g model
    outside JAX's gate for the g32 halves (``ops.decode_tp.check_tp_q4g``),
    bf16 at tp > 1 and f32 on any mesh raise: JAX decodes them through a
    GSPMD-partitioned step the port does not have (ROADMAP item 12.3b).
    The tree lives on the mesh's first device, where the encoder,
    adapter, prefill and first token run unsharded.  Under tp > 1 the
    single-device stacks are dropped (``fused_decode`` None, as JAX): sessions and pools on such a
    model stream the placed shards (``fused_tp``; ``streaming.py``).  A
    batch is padded with
    zero mel rows to a multiple of dp and trimmed after (JAX
    ``_pad_dp_rows``).
    """

    def __init__(self, params: Params, config: Optional[VoxtralConfig] = None,
                 device: DeviceLike = None, *, kernels: bool = True,
                 mesh=None):
        disable_tf32()
        if mesh is not None and device is None:
            device = mesh.first
        self.device = resolve_device(device)
        self.params = params
        self.config = config or VoxtralConfig.voxtral()
        lm = self.config.language_model
        dec = params["decoder"]
        # The encoder, adapter and prefill compute in the dense weights'
        # dtype, bf16 on the quantized routes; the KV cache takes it (f32
        # models keep an f32 cache; K1's routes a bf16 one), as JAX does.
        w1 = params["adapter"]["w1"]
        self.compute_dtype = (torch.bfloat16 if isinstance(w1, dict)
                              else w1.dtype)
        self.cache_dtype = self.compute_dtype
        mode = k1.megakernel_mode(dec, lm.head_dim)
        # Which decode route runs: "w8" / "q4g" / "bf16" (the fused K1
        # step) or "per_op" (the decoder layers op by op).
        self.fused_decode = None
        self.decode_route = "per_op"
        if mode == "w8":
            self.fused_decode = k1.fuse_decode_weights(dec)
            self.decode_route = "w8"
        elif mode == "q4g" and k1.q4g_geometry_ok(lm):
            self.fused_decode = k1.fuse_decode_weights_q4g(dec)
            self.decode_route = "q4g"
        elif mode == "bf16":
            self.fused_decode = k1.fuse_decode_weights_bf16(dec)
            self.decode_route = "bf16"
        self.kernels = kernels
        self._mm = None if kernels else PLAIN
        self._step = k1.decode_stack_step if kernels \
            else k1.decode_stack_step_plain
        self._layer_step = k1.decode_layer_step if kernels \
            else k1.decode_layer_step_plain
        # The route of the last one-shot call ("stack", "layer" or
        # "per_op", :func:`oneshot_plan`) and why.
        self.last_decode_route: Optional[str] = None
        self.last_route_reason = ""
        # Set to True to append one record per one-shot call to
        # ``decode_log``: route, rows, positions, decode steps, the decode
        # loop's wall seconds (synchronized at both ends: measuring costs
        # two synchronizations per call) and, on the card, the memory it
        # allocated above its start ("extra_bytes").
        self.measure_decode = False
        self.decode_log: list[dict] = []
        # Set to True to keep the top-2 logit margins of the last call
        # in ``last_margins`` ([B, S - 38] numpy).
        self.record_margins = False
        self.last_margins: Optional[np.ndarray] = None
        # Speculative passes of the last call (0: sequential decode).
        self.last_spec_passes = 0
        # The mesh (JAX ``parallel`` / ``fused_tp``): the plan, the TP
        # stacks placed on the shards' devices (each leaf a grid [d][i]
        # of shard i of data group d), or the DP groups' copies of K1's
        # stacks.
        self.parallel: Optional[ParallelPlan] = None
        self.fused_tp: Optional[Params] = None
        self._dp_stacks: Optional[Params] = None
        if mesh is not None:
            self._attach_mesh(mesh)

    def _attach_mesh(self, mesh) -> None:
        """Build the meshed decode's weights (JAX ``VoxtralModel.__init__``
        with ``mesh=``, ``models/voxtral.py:863-964``); ValueError for what
        this slice's meshed path cannot take (no silent single-device
        route)."""
        plan = ParallelPlan(mesh)
        self.parallel = plan
        if self.device != mesh.first:
            raise ValueError(f"the model's tree lives on the mesh's first "
                             f"device {mesh.first}, not {self.device}")
        if plan.dp * plan.tp == 1:
            return
        route = self.decode_route
        if route not in ("w8", "q4g") and not (route == "bf16"
                                               and plan.tp == 1):
            dense = route == "bf16" or self.compute_dtype == torch.float32
            what = ("bf16 weights at tp > 1" if route == "bf16" else
                    "f32 weights" if dense else f"{route} weights")
            raise ValueError(
                f"a {plan.dp} x {plan.tp} mesh takes w8 or q4g weights, or "
                f"bf16 at tp = 1, not {what}: "
                + ("JAX decodes a dense model on such a mesh through its "
                   "GSPMD-partitioned XLA step, which the port does not "
                   "have (ROADMAP item 12.3b)" if dense else
                   "packed q4 decodes per op, on one device"))
        lm = self.config.language_model
        dec = self.params["decoder"]
        fused = self.fused_decode
        q4g = self.decode_route == "q4g"
        # The lm fold's table: w8's rowwise codes, the g32 table of a q4g
        # model, or none (a q4g stack over a table that is not g32).
        lm_fold = _lm_fold(dec, fused)
        if plan.tp > 1:
            if q4g:
                try:
                    tpk.check_tp_q4g(lm.n_heads, lm.n_kv_heads, lm.head_dim,
                                     lm.hidden_dim, plan.tp)
                except ValueError as exc:
                    raise ValueError(
                        f"{exc}: JAX's gate for the g32 TP halves; outside "
                        "it JAX decodes through its GSPMD-partitioned XLA "
                        "step, which the port does not have (ROADMAP item "
                        "12.3b)") from exc
            if lm.n_kv_heads % plan.tp or lm.hidden_dim % plan.tp:
                raise ValueError(
                    f"tp={plan.tp} must divide n_kv={lm.n_kv_heads} and "
                    f"hidden={lm.hidden_dim}")
            shard = (tpk.tp_shard_fused_weights_q4g if q4g
                     else tpk.tp_shard_fused_weights)
            stacked = shard(fused, lm.n_heads, lm.n_kv_heads, lm.head_dim,
                            lm.hidden_dim, plan.tp)
            # Without a table to fold, or with a vocabulary tp does not
            # split (JAX's ``V % tp`` gate, ``models/voxtral.py:934``,
            # ``:946``), the greedy step takes the whole lm_head on the
            # first device.
            if "lm_codes" in lm_fold and lm.vocab_size % plan.tp == 0:
                codes, scale = lm_fold["lm_codes"], lm_fold["lm_scale"]
                table = (tpk.tp_shard_lm_head_q4g(codes, scale, plan.tp)
                         if q4g else tpk.tp_shard_lm_head(
                             {"codes": codes, "scale": scale}, plan.tp))
                stacked.update(lm_codes=table["codes"],
                               lm_scale=table["scale"])
            # Only the placed shards are kept: on cards of their own, the
            # first device does not hold every shard's stacks.
            self.fused_tp = tpk.place_shards(mesh, stacked)
            self._tp_norms = (fused["attn_norm"], fused["ffn_norm"])
            # The single-device stacks go, as in JAX: the halves stream
            # their own shards.
            self.fused_decode = None
            return
        self._dp_stacks = {
            name: _per_group(t, mesh) for name, t in {**fused,
                                                      **lm_fold}.items()}

    @classmethod
    def from_numpy(cls, tree: Params, config: Optional[VoxtralConfig] = None,
                   device: DeviceLike = None, **kw) -> "VoxtralModel":
        """Model from the JAX package's numpy parameter tree, moved to
        ``device`` (``None``: the card)."""
        from voxtral_tpu_torch.convert import params_from_numpy

        if device is None and kw.get("mesh") is not None:
            device = kw["mesh"].first
        device = resolve_device(device)
        return cls(params_from_numpy(tree, device), config, device, **kw)

    # -- API ----------------------------------------------------------------

    def t_embed(self, delay_tokens: float = 6.0) -> torch.Tensor:
        emb = time_embedding(delay_tokens, self.config.language_model.dim)
        return torch.as_tensor(emb, device=self.device).to(self.compute_dtype)

    def _cast_mel(self, mel) -> torch.Tensor:
        return torch.as_tensor(mel, device=self.device).to(self.compute_dtype)

    def encode_audio(self, mel) -> torch.Tensor:
        with span("encode_audio", mel_frames=int(mel.shape[-1])):
            return encode_audio_fn(self.params, self._cast_mel(mel),
                                   self.config, self._mm)

    def decoder_seq_len(self, mel_frames: int) -> int:
        """Decoder positions for a mel length: floor(floor(T/4)/4) on even T."""
        t1 = (mel_frames + 1) // 2
        t2 = (t1 + 1) // 2
        return t2 // self.config.downsample_factor

    def transcribe_streaming(self, mel, delay_tokens: float = 6.0,
                             temperature: float = 0.0, top_k: int = 0,
                             seed: int = 0, speculative: int = 0,
                             draft: str = "ngram") -> np.ndarray:
        """One mel chunk [1, n_mels, T] -> int32 tokens after the prefix.

        Greedy by default; ``temperature`` > 0 samples (top-k when
        ``top_k`` > 0) from a generator seeded with ``seed``.
        ``speculative=K >= 2`` (greedy only) verifies K drafted tokens
        per pass (``draft`` "ngram" or "pad"): the same tokens, fewer
        passes when the drafts hit.
        """
        seq = self.decoder_seq_len(mel.shape[-1])
        with span("transcribe_streaming", mel_frames=int(mel.shape[-1]),
                  tokens=seq - PREFIX_LEN):
            return self._transcribe(mel, delay_tokens,
                                    temperature=temperature, top_k=top_k,
                                    seed=seed, speculative=speculative,
                                    draft=draft)[0]

    def transcribe_streaming_batch(self, mel_batch, delay_tokens: float = 6.0,
                                   speculative: int = 0,
                                   draft: str = "ngram") -> np.ndarray:
        """B equal-length mel chunks [B, n_mels, T] -> int32 [B, S - 38],
        greedy (speculative with ``speculative=K >= 2``)."""
        return self._transcribe(mel_batch, delay_tokens,
                                speculative=speculative, draft=draft)

    def transcribe_streaming_batch_async(self, mel_batch,
                                         delay_tokens: float = 6.0,
                                         speculative: int = 0,
                                         draft: str = "ngram"):
        """:meth:`transcribe_streaming_batch` without the fetch: the
        tokens as an int32 tensor [B, S - 38] on the model's device (a
        numpy zeros array [B, 0] for a mel too short to decode); fetch
        with ``np.asarray(t.cpu())``.  The kernels are queued on the
        current stream; the speculative loop still reads one bool per
        pass."""
        tokens = self._transcribe_device(mel_batch, delay_tokens,
                                         speculative=speculative,
                                         draft=draft)
        if tokens is None:
            return np.zeros((mel_batch.shape[0], 0), dtype=np.int32)
        return tokens

    def _transcribe(self, mel, delay_tokens: float, **kw) -> np.ndarray:
        tokens = self._transcribe_device(mel, delay_tokens, **kw)
        if tokens is None:
            return np.zeros((mel.shape[0], 0), dtype=np.int32)
        return tokens.cpu().numpy()

    def _pad_dp_rows(self, mel_batch: torch.Tensor):
        """Pad the batch with zero rows to a multiple of the mesh's data
        axis (JAX ``_pad_dp_rows``, ``models/voxtral.py:1040-1058``); the
        padded rows' tokens are trimmed by the caller.  -> (mel, real
        rows).  Every one-shot entry point (``transcribe_streaming``,
        ``transcribe_streaming_batch``, ``transcribe_streaming_batch_async``)
        comes through :meth:`_transcribe_device`, which calls this."""
        b = mel_batch.shape[0]
        if self.parallel is None or self.parallel.dp <= 1:
            return mel_batch, b
        pad = (-b) % self.parallel.dp
        if pad == 0:
            return mel_batch, b
        return torch.cat([mel_batch, mel_batch.new_zeros(
            (pad, *mel_batch.shape[1:]))]), b

    def _mesh_step(self, dec: Params, lm_cfg, batch: int, cache, slots: int,
                   ada_vecs, logits_too: bool, greedy: bool):
        """The meshed route's step over the shards' copies of ``cache``."""
        plan = self.parallel
        groups = row_groups(batch, plan.dp)
        k_sh, v_sh = _head_major_shards(cache, slots, plan, groups)
        if plan.tp > 1:
            return _tp_step(self, dec, ada_vecs, lm_cfg, self._mm, k_sh,
                            v_sh, groups, logits_too, greedy)
        return _dp_step(self, ada_vecs, lm_cfg, [g[0] for g in k_sh],
                        [g[0] for g in v_sh], groups, logits_too, greedy)

    def _transcribe_device(self, mel, delay_tokens: float, **kw):
        check_draft(kw["draft"])
        mel, real_b = self._pad_dp_rows(self._cast_mel(mel))
        self.last_spec_passes = 0
        seq = self.decoder_seq_len(mel.shape[-1])
        if seq < PREFIX_LEN + 1:
            return None
        spec = kw.get("speculative", 0)
        greedy = kw.get("temperature", 0.0) <= 0.0
        route, why = oneshot_plan(self, mel.shape[0], seq,
                                  spec if spec >= 2 and greedy else 1)
        self.last_decode_route, self.last_route_reason = route, why
        (log.info if route == "layer" or (route == "per_op"
                                          and self.fused_decode is not None)
         else log.debug)("one-shot decode of %d rows x %d positions: %s "
                         "route (%s)", mel.shape[0], seq, route, why)
        margins = [] if self.record_margins else None
        passes: list = []
        stats: Optional[dict] = {} if self.measure_decode else None
        mesh_step = None
        if route in ("tp", "dp"):
            def mesh_step(cache, slots, ada_vecs, logits_too):
                return self._mesh_step(
                    self.params["decoder"], self.config.language_model,
                    mel.shape[0], cache, slots, ada_vecs, logits_too, greedy)
        with torch.no_grad():
            tokens = transcribe_streaming_fn(
                self.params, mel, self.t_embed(delay_tokens), self.config,
                None if route == "per_op" else self.fused_decode, self._mm,
                self._step, margins, passes=passes, route=route,
                layer_step=self._layer_step, decode_stats=stats,
                mesh_step=mesh_step, **kw)[:real_b]
        if passes:
            self.last_spec_passes = passes[0]
        if stats is not None:
            self.decode_log.append(dict(route=route, rows=mel.shape[0],
                                        positions=seq,
                                        steps=seq - PREFIX_LEN - 1, **stats))
        if margins is not None:
            self.last_margins = torch.stack(margins, dim=1)[:real_b].cpu(
                ).numpy()
        return tokens
