"""Real-time incremental transcription: the live session and the pool
that batches sessions (port of ``voxtral_tpu/streaming.py``:
``StreamingSession`` and ``StreamPool``).

Audio is fed in pieces of any size; text comes back with the model's
native delay.  Each step recomputes the conv over an overlapping mel
window (the stride-2 k=3 conv pair needs 3 mel frames of lookahead and
3 of lookback) with 4 frames of STFT margin, so the streamed encoder
input equals the one-shot computation.  Step layout (P =
``step_positions`` decoder positions per step):

    samples -- mel window --> conv --> [4P encoder frames] --encoder
    cache--> reshape(4) --> adapter --> [P audio embeds] --decoder
    cache--> P greedy tokens

The 76-token silence left pad is prepended (it covers the 38-position
prefill).  Routes follow the model's (``VoxtralModel.decode_route``):

* "w8" / "q4g" / "bf16": steady steps decode through the K1 stack step
  (weight modes a / h / g), its head+ring mask (mode (d)) on unbounded
  sessions, its ``spec=K`` mode (b) with a device-resident offset when
  ``speculative=K``;
* "per_op" (packed q4, dense f32): the decoder op by op, K3 on every
  packed linear; f32 models keep f32 caches, as JAX's.

The first step (encoder frames [0, 4 (38 + P)), the prefill, the first
token and the P - 1 positions after it) runs the decoder op by op on
every route, as JAX does.  ``lax.scan`` / ``while_loop`` become Python
loops on the model's device; tokens reach the host once per
``feed`` / ``finish`` (deferred fetches), and a speculative pass reads
one bool to decide whether another is needed.  ``unbounded=True`` lays
both caches out as head+ring buffers (a permanent 38-position prefix
head and a ring covering the sliding window), so a session runs until
the RoPE table ends (16384 decoder positions of 160 ms, ~43.7 min).

:class:`StreamPool` steps up to ``max_streams`` sessions together: one
batched encoder pass (every linear sees B x 4P rows) and P K1 steps with
per-row offsets, RoPE and ring phases, so the streams share each pass
over the weights.  Its decoder caches are head-major [L, B, Hkv, S, hd],
bf16 or int8 with per-vector scales (K1 mode (e)), resident or walked in
chunks of ``CACHE_CHUNK`` slots (mode (f)), as the ladder of
``kv_dtype`` selects; ``speculative=K`` verifies K drafts per slot and
pass.  A pool on a model with fused weights runs K1 and nothing else: a
geometry no rung admits raises in the constructor.

On a model with a mesh (``VoxtralModel(mesh=)``: w8 or q4g weights,
or bf16 at tp = 1) sessions and pools decode meshed, as JAX's
(``voxtral_tpu/streaming.py:530-620``, the ``wg`` gate ``:550-575``): tp > 1 runs the K4 / K5 halves
per model shard (the head+ring, int8 and chunked cache modes included;
in g32 for q4g) and K6's vocab-sharded greedy tokens (the whole lm_head
on the first device when a q4g stack sits over a table that is not
g32), the pool's slots split over the data axis too when dp > 1; a
data-parallel pool runs K1 per data group (in mode (g) on bf16 weights,
its greedy tokens from mode (i) over the bf16 table).  The decoder
caches are then shard grids (:class:`_ShardedKV`); the encoder, the adapter and every stream's first
step stay on the mesh's first device.  A solo session runs on data group
0's shards.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from voxtral_tpu_torch.audio.mel import MelSpectrogram
from voxtral_tpu_torch.audio.pad import PadConfig
from voxtral_tpu_torch.device import to_torch
from voxtral_tpu_torch.models.adapter import (
    adapter_forward,
    reshape_encoder_output,
)
from voxtral_tpu_torch.models.decoder import (
    DECODER_ROPE_MAX_SEQ,
    create_cache,
    decoder_forward_hidden_with_cache,
    embed_tokens,
    lm_head,
)
from voxtral_tpu_torch.models.encoder import (
    create_encoder_cache,
    encoder_layers_with_cache,
)
from voxtral_tpu_torch.models.layers import (
    KVCache,
    conv_downsample,
    ring_slot,
    rope_tables,
)
from voxtral_tpu_torch.models.voxtral import (
    PREFIX_LEN,
    VoxtralModel,
    append_rows,
    append_scales,
    check_draft,
    fused_step_fn,
    make_prefix_ids,
    mesh_lm_head,
    ngram_drafts,
    ngram_table_init,
    ngram_train,
    select_token,
    top2_margin,
)
from voxtral_tpu_torch.ops import decode_step as k1
from voxtral_tpu_torch.ops import decode_tp as tpk
from voxtral_tpu_torch.parallel import (
    Mesh,
    dp_decode_stack_step,
    row_groups,
)
from voxtral_tpu_torch.tokenizer import STREAMING_PAD, VoxtralTokenizer
from voxtral_tpu_torch.utils.hbm import HBMBudgetError, check_hbm
from voxtral_tpu_torch.utils.profiling import span

MEL_HOP = 160
MEL_MARGIN = 4  # STFT frames of margin so window-interior frames are exact
SAMPLES_PER_POSITION = 2560  # 16 mel frames
# Chunk of the pool's chunked cache rungs (K1 mode (f), ``cache_chunk=``):
# such a cache rounds up to a multiple of it.
CACHE_CHUNK = 512


def _mel_frames_needed(last_frame: int) -> int:
    """Samples required so mel frames [0, last_frame) are computable."""
    return MEL_HOP * (last_frame - 1) + 200 + MEL_HOP


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 widens to f32 (exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# Steps shared by the solo session and the pool's slots
# ---------------------------------------------------------------------------


def _conv(model: VoxtralModel, mel: np.ndarray) -> torch.Tensor:
    """Conv downsampler over mel windows [B, n_mels, W] -> [B, W / 4, D]."""
    mel = model._cast_mel(mel)
    return conv_downsample(mel, model.params["encoder"]["conv"]).transpose(
        1, 2)


def _encode(model: VoxtralModel, x: torch.Tensor, cache: KVCache, rope,
            ring):
    """Encoder layers over new conv frames x [B, n, D] (appended to the
    encoder cache, per row when ``cache.length`` is a tensor) + adapter
    -> (audio embeds [B, n / 4, D], cache)."""
    cfg, params = model.config, model.params
    hidden, cache = encoder_layers_with_cache(
        params["encoder"], x, cache, cfg.audio_encoder, rope, ring=ring,
        mm=model._mm)
    audio = adapter_forward(
        params["adapter"],
        reshape_encoder_output(hidden, cfg.downsample_factor), model._mm)
    return audio, cache


def _decode_per_op(model: VoxtralModel, inputs: torch.Tensor,
                   prev: torch.Tensor, cache: KVCache, t_embed, rope, ring,
                   record):
    """Greedy decode of len(inputs) positions, the decoder op by op over
    a position-major cache (JAX ``_decode_scan``); inputs [1, n, D] are
    the audio embeds of input positions.  ``record(tokens, logits)``
    queues each token; -> (the last token, cache)."""
    dec, lm = model.params["decoder"], model.config.language_model
    for i in range(inputs.shape[1]):
        text = embed_tokens(dec, prev.long()[:, None])
        hidden, cache = decoder_forward_hidden_with_cache(
            dec, inputs[:, i:i + 1] + text, t_embed, cache, lm, rope,
            model._mm, ring=ring)
        logits = lm_head(dec, hidden[:, 0], mm=model._mm)
        prev = select_token(logits)
        record(prev, logits)
    return prev, cache


def _init_step(model: VoxtralModel, P: int, mel0: np.ndarray, t_embed,
               encode, ring_head: Optional[int], dec_cache: KVCache, dec_rope,
               dec_ring, record):
    """The first step of a stream, solo or in a pool's slot: encoder
    frames [0, 4 n), the 38-position prefill, the first token and
    positions 39 .. n - 1 (n = 38 + P); mel0 covers frames
    [0, 16 n + 8) so the last conv frame has its lookahead.
    ``encode(x)`` appends conv frames to the stream's encoder cache and
    returns their audio embeds; ``ring_head`` the encoder ring's head
    (None: bounded).  The decoder cache is batch-1 and position-major,
    written in place.  -> (last token, last audio embed, dec_cache)."""
    n = PREFIX_LEN + P
    dec = model.params["decoder"]
    x = _conv(model, mel0)[:, :4 * n]
    if ring_head is None:
        audio = encode(x)
    else:
        # A ring write must fit one region: the first 4 x 38 frames fill
        # the permanent head, the rest start the ring (two cached calls
        # compute what one does).
        audio = torch.cat([encode(x[:, :ring_head]),
                           encode(x[:, ring_head:])], dim=1)
    prefix = torch.as_tensor(make_prefix_ids(), device=x.device).long()
    hidden, dec_cache = decoder_forward_hidden_with_cache(
        dec, audio[:, :PREFIX_LEN] + embed_tokens(dec, prefix[None]),
        t_embed, dec_cache, model.config.language_model, dec_rope,
        model._mm, ring=dec_ring)
    logits = lm_head(dec, hidden[:, -1], mm=model._mm)
    first = select_token(logits)
    record(first, logits)
    last, dec_cache = _decode_per_op(model, audio[:, PREFIX_LEN:-1], first,
                                     dec_cache, t_embed, dec_rope, dec_ring,
                                     record)
    return last, audio[:, -1:], dec_cache


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------


def _mesh_shape(model: VoxtralModel) -> tuple[int, int]:
    """(dp, tp) of the model's mesh; (1, 1) without one."""
    plan = model.parallel
    return (plan.dp, plan.tp) if plan is not None else (1, 1)


def _fused_weights(model: VoxtralModel):
    """The stacks the fused decode streams: the placed TP shards on a
    mesh with tp > 1 (``model.fused_tp``), else K1's (``fused_decode``,
    which a data-parallel model keeps); None without fused weights."""
    return model.fused_tp if _mesh_shape(model)[1] > 1 \
        else model.fused_decode


def _rung_refusal(model: VoxtralModel, batch: int, cache_s: int,
                  itemsize: Optional[int], chunk: Optional[int],
                  spec: int) -> Optional[str]:
    """Why the fused decode cannot run ``batch`` rows over
    ``cache_s``-slot caches of this kind, or None: on a mesh, a stream
    count the data axis does not divide; the attention block's shared
    memory (``check_geometry``, on a tp mesh with K4's shard rules,
    ``check_tp_geometry``; a chunked walk holds ``chunk`` scores, a
    resident one up to ``cache_s``); the card's memory for the rung's
    decoder caches and scale planes, spread over the mesh's shards, and
    the init slot on the first device (``check_hbm``, per shard)."""
    lm = model.config.language_model
    dp, tp = _mesh_shape(model)
    streams = batch // spec
    per_slot = 2 * lm.n_layers * lm.n_kv_heads * cache_s
    caches = per_slot * streams * (lm.head_dim * (itemsize or 2)
                                   + (4 if itemsize == 1 else 0))
    try:
        row_groups(streams, dp)  # JAX's refusal of an undivided batch
        if tp > 1:
            tpk.check_tp_geometry(cache_s, lm.head_dim, None, spec,
                                  lm.n_kv_heads, lm.hidden_dim, tp, None,
                                  chunk, itemsize == 1)
        else:
            k1.check_geometry(cache_s, lm.head_dim, None, spec, None, chunk,
                              itemsize == 1)
        check_hbm(model, caches, f"a pool of {streams} streams", streams,
                  dp=dp, first_bytes=per_slot * lm.head_dim * 2)
    except (ValueError, HBMBudgetError) as e:
        return str(e)
    return None


def _fused_plan(model: VoxtralModel, batch: int, cache_s: int,
                itemsize: Optional[int] = None, chunk: Optional[int] = None,
                spec: int = 1):
    """The pool's fused decode plan for ``batch`` rows and a
    ``cache_s``-slot cache: ``{"w": the stacks}`` on one device, with
    ``"tp"`` on a mesh with tp > 1 (the K4 / K5 halves and K6, the rows
    split over the data axis too when dp > 1) or ``"dp"`` on a
    data-parallel mesh (K1 per data group), as JAX's meshed plan
    (``voxtral_tpu/streaming.py:530-620``); refused, the reason (a str,
    :func:`_rung_refusal`); None when the model carries no fused
    weights.  ``itemsize=1`` evaluates the int8 KV cache, ``chunk`` the
    chunked walk.  The pool's ladder asks it rung by rung; a test forces
    a rung by replacing it (a replacement may refuse with None)."""
    w = _fused_weights(model)
    if w is None:
        return None
    why = _rung_refusal(model, batch, cache_s, itemsize, chunk, spec)
    if why:
        return why
    dp, tp = _mesh_shape(model)
    if tp > 1:
        return {"w": w, "tp": tp}
    return {"w": w, "dp": dp} if dp > 1 else {"w": w}


class _ShardedKV:
    """The fused decoder caches of a pool or a session, head-major: a
    grid ``[d][i]`` of [L, B_d, Hkv / tp, S, hd] tensors on
    ``devices[d][i]`` (data group d's streams, model shard i's KV heads;
    one device: the grid ``[[t]]`` of the whole [L, B, Hkv, S, hd]), in
    the model's cache dtype, or int8 codes with f32 scale grids of
    [L, B_d, Hkv / tp, S] (K1 / K4 mode (e))."""

    def __init__(self, devices, streams: int, lm, slots: int, int8: bool,
                 dtype):
        self.devices = devices
        self.groups = row_groups(streams, len(devices))
        self.int8 = int8
        heads = lm.n_kv_heads // len(devices[0])

        def grid(tail, dt):
            return [[torch.zeros((lm.n_layers, g.stop - g.start, heads,
                                  slots, *tail), dtype=dt, device=dev)
                     for dev in row] for g, row in zip(self.groups, devices)]

        cdt = torch.int8 if int8 else dtype
        self.k, self.v = grid((lm.head_dim,), cdt), grid((lm.head_dim,), cdt)
        self.ks = grid((), torch.float32) if int8 else None
        self.vs = grid((), torch.float32) if int8 else None

    def exposed(self) -> tuple:
        """(k, v, k scales, v scales): the tensors on one device, the
        grids on a mesh."""
        one = len(self.devices) * len(self.devices[0]) == 1
        return tuple(g[0][0] if one and g is not None else g
                     for g in (self.k, self.v, self.ks, self.vs))

    def tensors(self) -> list:
        return [t for g in (self.k, self.v, self.ks, self.vs)
                if g is not None for row in g for t in row]

    def append(self, k_new, v_new, slots: torch.Tensor,
               rows: torch.Tensor) -> None:
        """Fresh K / V in place: grids ``[d][i]`` of [L, n_d, Hkv_l, hd]
        (data group d's rows of the step, in order), row j at slot
        ``slots[j]`` of cache row ``rows[j]`` (the batch's numbering),
        quantized per vector (codes and scales) on an int8 cache."""
        at = 0
        for d, g in enumerate(self.groups):
            n = k_new[d][0].shape[1]
            sl, rl = slots[at:at + n], rows[at:at + n] - g.start
            at += n
            for i, dev in enumerate(self.devices[d]):
                s_i, r_i = sl.to(dev), rl.to(dev)
                for cache, scales, new in ((self.k, self.ks, k_new),
                                           (self.v, self.vs, v_new)):
                    if self.int8:
                        q, sc = k1.quantize_kv(new[d][i])
                        append_rows(cache[d][i], q, s_i, r_i)
                        append_scales(scales[d][i], sc, s_i, r_i)
                    else:
                        append_rows(cache[d][i], new[d][i], s_i, r_i)

    def _locate(self, b: int) -> tuple[int, int]:
        for d, g in enumerate(self.groups):
            if g.start <= b < g.stop:
                return d, b - g.start
        raise IndexError(f"cache row {b} of {self.groups[-1].stop}")

    def read(self, b: int, dev) -> tuple:
        """Cache row ``b`` gathered from its shards, dequantized: K and V
        [L, Hkv, S, hd] f32 on ``dev``."""
        d, r = self._locate(b)
        out = []
        for cache, scales in ((self.k, self.ks), (self.v, self.vs)):
            parts = []
            for i in range(len(self.devices[d])):
                t = cache[d][i][:, r].float()
                if scales is not None:
                    t = t * scales[d][i][:, r][..., None]
                parts.append(t.to(dev))
            out.append(torch.cat(parts, dim=1))
        return tuple(out)

    def write(self, b: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Position-major k / v [L, n, Hkv, hd] (n <= S) into cache row
        ``b``, scattered over its shards' heads, quantized per vector on
        an int8 cache; the slots past n are zeroed."""
        d, r = self._locate(b)
        n = k.shape[1]
        for i, dev in enumerate(self.devices[d]):
            for cache, scales, new in ((self.k, self.ks, k),
                                       (self.v, self.vs, v)):
                c = cache[d][i]
                h = c.shape[2]
                part = new[:, :, i * h:(i + 1) * h].transpose(1, 2).to(dev)
                c[:, r, :, n:] = 0
                if scales is None:
                    c[:, r, :, :n] = part.to(c.dtype)
                    continue
                q, sc = k1.quantize_kv(part)
                c[:, r, :, :n] = q
                scales[d][i][:, r, :, :n] = sc
                scales[d][i][:, r, :, n:] = 0


def _decoder(model: VoxtralModel, w, ada: torch.Tensor, kv: _ShardedKV,
             ring, chunk: Optional[int], mesh: Optional[Mesh]):
    """The fused decode of a pool or a session over ``kv``:
    ``decode(x, offs, cos, sin, spec=1) -> (tokens [rows] int32, logits
    [rows, V] or None, k_new, v_new)``, the fresh K / V as ``kv``'s
    grids, for :meth:`_ShardedKV.append`.  On one device (``mesh``
    None): K1 with the lm fold (logits always).  On a mesh with tp > 1:
    :func:`ops.decode_tp.tp_decode_step` (K4 / K5 per shard, the rows
    over the data axis) and K6's vocab-sharded tokens
    (``tp_lm_head_token``); the whole lm_head on the first device only
    for the top-2 margins (``model.record_margins``), or for the tokens
    when the shards carry no table to fold (a q4g stack over a table that
    is not g32).  On a data-parallel mesh: ``dp_decode_stack_step`` (K1
    per data group), its tokens from mode (i) unless the margins need
    the logits or there is no fold (then the lm_head on the first
    device)."""
    dec, lm = model.params["decoder"], model.config.language_model
    kw = dict(n_heads=lm.n_heads, n_kv=lm.n_kv_heads, head_dim=lm.head_dim,
              eps=lm.norm_eps, window=lm.sliding_window, ring=ring,
              cache_chunk=chunk)
    if mesh is None:
        run_step = fused_step_fn(dec, w, ada, lm, model._mm, model._step)
        cache_kw = {} if chunk is None else {"cache_chunk": chunk}
        if kv.int8:
            cache_kw.update(k_scales=kv.ks[0][0], v_scales=kv.vs[0][0])

        def decode(x, offs, cos, sin, spec=1):
            _, kn, vn, logits = run_step(x, offs, cos, sin, kv.k[0][0],
                                         kv.v[0][0], spec=spec, ring=ring,
                                         **cache_kw)
            return select_token(logits), logits, [[kn]], [[vn]]

        return decode
    if mesh.shape["model"] > 1:
        kern = model.kernels
        parts = dict(attn=tpk.attn_half_step if kern
                     else tpk.attn_half_step_plain,
                     ffn=tpk.ffn_half_step if kern
                     else tpk.ffn_half_step_plain)

        def decode(x, offs, cos, sin, spec=1):
            xo, kn, vn = tpk.tp_decode_step(
                mesh, x, offs, model._tp_norms[0], model._tp_norms[1], ada,
                w, cos, sin, kv.k, kv.v, kv.ks, kv.vs, spec=spec, **parts,
                **kw)
            logits, tokens = mesh_lm_head(model, mesh, xo, w, None, True,
                                          model.record_margins)
            return (select_token(logits) if tokens is None else tokens,
                    logits, kn, vn)

        return decode
    st = model._dp_stacks

    def first(grid):
        return None if grid is None else [row[0] for row in grid]

    fold = [st.get(k) for k in ("final_norm", "lm_codes", "lm_scale")]

    def decode(x, offs, cos, sin, spec=1):
        argmax = not model.record_margins and fold[1] is not None
        xo, kn, vn, *last = dp_decode_stack_step(
            mesh, x, offs, st["attn_norm"], st["ffn_norm"], ada, st["sqkv"],
            st["so"], st["s13"], st["s2"], cos, sin, first(kv.k),
            first(kv.v), st["wqkv"], st["wo"], st["w13"], st["w2"], *fold,
            first(kv.ks), first(kv.vs), spec=spec, lm_argmax=argmax,
            step=model._step, **kw)
        logits, tokens = mesh_lm_head(model, mesh, xo, st, last, True,
                                      model.record_margins)
        return (select_token(logits) if tokens is None else tokens, logits,
                [[n] for n in kn], [[n] for n in vn])

    return decode


def _ring_remap(src: np.ndarray, head: int, src_size: int, dst_size: int,
                written: int) -> np.ndarray:
    """Re-lay a head+ring cache onto another ring size.

    ``src`` is [L, 1, head + src_size, H, hd].  Position p >= head lives
    at slot head + (p - head) % size.  Only the last min(src_size,
    dst_size) positions survive: both rings cover the window + P, so
    every position a later query can reach is kept; older target slots
    stay zero and lie outside every window."""
    out_shape = list(src.shape)
    out_shape[2] = head + dst_size
    dst = np.zeros(out_shape, src.dtype)
    dst[:, :, :head] = src[:, :, :head]
    lo = max(head, written - min(src_size, dst_size))
    ps = np.arange(lo, written)
    if ps.size:
        dst[:, :, head + (ps - head) % dst_size] = \
            src[:, :, head + (ps - head) % src_size]
    return dst


def _host_f32(a) -> np.ndarray:
    """A checkpoint array (numpy f32 / bf16, or a tensor) as f32 numpy."""
    if not isinstance(a, torch.Tensor):
        a = to_torch(np.asarray(a), "cpu")
    return a.detach().float().cpu().numpy()


class StreamPool:
    """Steps concurrent streaming sessions together (port of the JAX
    ``StreamPool``, on one device or a mesh).

    The pool owns the caches of ``max_streams`` slots; sessions attach
    to free slots (``StreamingSession(model, pool=pool)``) and their
    steady steps run as one batch: the encoder over B windows at once,
    then P decode positions.  A slot that is not ready rides the pass
    masked: bounded, its cache writes go to the sacrificial slots past
    ``max_dec`` / ``max_enc``; unbounded, to its own next slots (not yet
    valid, or already outside the window, and overwritten by its next
    real step); its tokens are dropped and its feedback state kept.

    With fused weights (w8, q4g) the decode half is K1 with per-row
    offsets and RoPE (mode (c)), per-row ring phases (d), int8 KV (e)
    and / or the chunked cache (f) as ``kv_dtype`` and the ladder pick
    them; the decoder caches are head-major [L, B, Hkv, S, hd].  On a
    model with a mesh (``VoxtralModel(mesh=)``, w8 or q4g) the decode half
    runs the K4 / K5 halves and K6 (in g32 for q4g) (tp > 1, ``_tp_mesh``; the slots split
    over the data axis too when dp > 1) or K1 per data group (dp > 1,
    ``_dp_mesh``), in the same cache modes, over caches held as shard
    grids (``dec_k`` etc. are then grids ``[d][i]`` of [L, B / dp,
    Hkv / tp, S, hd] on the shards' devices); the encode half stays
    batched on the mesh's first device (JAX ``streaming.py:877-905``,
    ``:1025-1101``, ``:1162-1290``).  No rung admitted is an error, not
    a fall-back.  Models without fused weights (packed q4) take the
    per-op step slot by slot.
    """

    def __init__(
        self,
        model: VoxtralModel,
        max_streams: int = 4,
        step_positions: int = 8,
        max_duration_s: float = 120.0,
        delay_tokens: float = 6.0,
        unbounded: bool = False,
        kv_dtype: str = "auto",
        speculative: int = 0,
        draft_token: int = STREAMING_PAD,
        draft: str = "pad",
    ):
        """``kv_dtype``: "model" (bf16 caches), "int8" (per-vector int8
        codes + f32 scales: half the cache bytes K1 reads and the card
        holds) or "auto" (bf16 if a rung admits it, else int8); each
        tries the resident cache first, then the chunked one
        (``CACHE_CHUNK`` slots a chunk, the cache rounded up to it).
        ``speculative=K >= 2``: every pass verifies K drafted tokens per
        slot (K1 ``spec=K``; rows (slot, draft) share the slot's cache),
        each slot advancing by its own accepted count; exact greedy
        tokens; resident rungs only (a chunked walk requantizes per
        chunk, which the fresh rows cannot join); on a data-parallel
        mesh ``max_streams`` must divide into whole streams per data
        group.  ``unbounded=True``: head+ring caches, a slot runs until
        the RoPE table ends."""
        check_draft(draft)
        self.model = model
        self.cfg = model.config
        self.B = max_streams
        self.P = step_positions
        self.max_duration_s = max_duration_s
        self.delay_tokens = delay_tokens
        self.unbounded = unbounded
        self.speculative = int(speculative or 0)
        self._draft_token = int(draft_token)
        self.draft = draft
        if self.speculative > self.P:
            raise ValueError(
                f"speculative={self.speculative} must be <= "
                f"step_positions={self.P}")
        lm, enc = self.cfg.language_model, self.cfg.audio_encoder
        dev = model.device
        if unbounded:
            gran = 4 * self.P
            self._dec_ring = (PREFIX_LEN, lm.sliding_window + self.P)
            self._enc_ring = (4 * PREFIX_LEN,
                              -(-(enc.sliding_window + gran) // gran) * gran)
            self.max_dec = DECODER_ROPE_MAX_SEQ  # the RoPE table's bound
            s_dec, s_enc = sum(self._dec_ring), sum(self._enc_ring)
            rope_positions = DECODER_ROPE_MAX_SEQ
        else:
            self._dec_ring = self._enc_ring = None
            self.max_dec = (int(max_duration_s * 6.25) + PREFIX_LEN
                            + 2 * self.P)
            # One write granule of sacrificial slots for masked steps;
            # a speculative pass can overshoot by up to 2K - 2 more (a
            # slot that finished keeps appending at its frozen position
            # + the draft offsets until every slot reaches P).
            s_dec = self.max_dec + self.P + 2 * self.speculative
            s_enc = 4 * self.max_dec + 4 * self.P
            rope_positions = self.max_dec
        self.max_enc = 4 * self.max_dec

        # The cache ladder, each rung (itemsize, chunk): resident first,
        # then chunked (shared memory no longer bounds S).
        spec = max(1, self.speculative)
        if kv_dtype not in ("auto", "model", "int8"):
            raise ValueError(
                f"kv_dtype must be 'auto', 'model' or 'int8', got "
                f"{kv_dtype!r}")
        if spec > 1:
            ladder = {"model": [(None, None)], "int8": [(1, None)],
                      "auto": [(None, None), (1, None)]}[kv_dtype]
        else:
            ladder = {"int8": [(1, None), (1, CACHE_CHUNK)],
                      "model": [(None, None), (None, CACHE_CHUNK)],
                      "auto": [(None, None), (1, None),
                               (1, CACHE_CHUNK)]}[kv_dtype]
        dp, tp = _mesh_shape(model)
        if spec > 1 and self.B % dp:
            raise ValueError(
                f"speculative meshed pools need max_streams ({self.B}) "
                f"divisible by the data axis ({dp}) so every stream's K "
                "draft rows shard with its cache")
        self.cache_int8 = False
        self._cache_chunk = None
        self._fused = None
        if _fused_weights(model) is None:
            if spec > 1:
                raise ValueError(
                    "speculative pools need the fused K1 step (w8, q4g or "
                    f"bf16 weights); this model decodes {model.decode_route}")
        else:
            refused = []
            for item, chunk in ladder:
                s_try = s_dec if chunk is None else -(-s_dec // chunk) * chunk
                plan = _fused_plan(model, self.B * spec, s_try, itemsize=item,
                                   chunk=chunk, spec=spec)
                if isinstance(plan, dict):
                    self._fused = plan
                    self.cache_int8 = item == 1
                    self._cache_chunk = chunk
                    s_dec = s_try
                    if chunk is not None and unbounded:
                        # The ring grows to the padded S: a ring above
                        # window + P is fine (the window bound masks the
                        # older entries).
                        self._dec_ring = (PREFIX_LEN, s_dec - PREFIX_LEN)
                    break
                refused.append(
                    f"{'int8' if item == 1 else 'bf16'} cache, "
                    f"{'resident' if chunk is None else f'chunks of {chunk}'}"
                    f", {s_try} slots: {plan or 'refused by _fused_plan'}")
            if self._fused is None:
                # No per-op fall-back for a model with fused weights.
                raise ValueError(
                    f"StreamPool(max_streams={self.B}, unbounded="
                    f"{unbounded}, kv_dtype={kv_dtype!r}, speculative="
                    f"{self.speculative}): K1 can take no rung of the "
                    "cache ladder -- " + "; ".join(refused))
        self._s_dec, self._s_enc = s_dec, s_enc

        mesh = model.parallel.mesh if dp * tp > 1 else None
        self._tp_mesh = mesh if tp > 1 and self._fused is not None else None
        self._dp_mesh = mesh if tp == 1 and self._fused is not None else None

        # Admission from the exact shapes allocated below.  The caches take
        # the model's cache dtype (bf16; f32 on an f32 model's generic
        # pool).  On a mesh the decoder caches spread over the shards; the
        # encoder caches and the init slot stay on the first device.
        cdt = model.cache_dtype
        cds = torch.empty((), dtype=cdt).element_size()
        shape_e = (enc.n_layers, self.B, s_enc, enc.n_kv_heads, enc.head_dim)
        first_bytes = 2 * math.prod(shape_e) * cds
        per_slot = 2 * lm.n_layers * lm.n_kv_heads * s_dec
        if self._fused is not None:
            dec_bytes = per_slot * self.B * lm.head_dim * (
                1 if self.cache_int8 else cds)
            if self.cache_int8:
                dec_bytes += per_slot * self.B * 4
            first_bytes += per_slot * lm.head_dim * cds  # the init slot
        else:
            dec_bytes = per_slot * self.B * lm.head_dim * cds
        self.cache_bytes = first_bytes + dec_bytes
        check_hbm(model, dec_bytes,
                  f"StreamPool(max_streams={self.B}, unbounded={unbounded}, "
                  f"kv_dtype={kv_dtype!r})", rows=self.B, dp=dp,
                  first_bytes=first_bytes)

        # Encoder caches [L, B, S, H, hd]: a slot is the batch-1 view
        # [:, b:b + 1] (JAX keeps [B, L, 1, S, H, hd] and vmaps).
        self.enc_k = torch.zeros(shape_e, dtype=cdt, device=dev)
        self.enc_v = torch.zeros(shape_e, dtype=cdt, device=dev)
        self.dec_ks = self.dec_vs = None
        self._init_dec_zero = None
        self._kv = None
        if self._fused is not None:
            self._kv = _ShardedKV(mesh.devices if mesh else [[dev]], self.B,
                                  lm, s_dec, self.cache_int8, cdt)
            self.dec_k, self.dec_v, self.dec_ks, self.dec_vs = \
                self._kv.exposed()
            # The position-major cache every slot's init step runs in (on
            # the first device): an init writes slots [0, 38 + P) and
            # reads nothing it did not write, so the slot is shared and
            # the rest stays zero.
            self._init_dec_zero = create_cache(lm, 1, s_dec, cdt, dev)
            with torch.no_grad():
                ada = k1.ada_vectors(model.params["decoder"],
                                     model.t_embed(delay_tokens), model._mm)
            self._decode = _decoder(model, self._fused["w"], ada, self._kv,
                                    self._dec_ring, self._cache_chunk, mesh)
        else:
            shape_d = (self.B, lm.n_layers, 1, s_dec, lm.n_kv_heads,
                       lm.head_dim)
            self.dec_k = torch.zeros(shape_d, dtype=cdt, device=dev)
            self.dec_v = torch.zeros(shape_d, dtype=cdt, device=dev)
        self.prev_tok = torch.zeros(self.B, dtype=torch.int32, device=dev)
        self.prev_audio = torch.zeros((self.B, 1, lm.dim),
                                      dtype=model.compute_dtype, device=dev)
        self._enc_rope = rope_tables(enc.head_dim, 4 * rope_positions,
                                     enc.rope_theta, device=dev)
        self._dec_rope = rope_tables(lm.head_dim, rope_positions,
                                     lm.rope_theta, device=dev)
        self._t_embed = model.t_embed(delay_tokens)
        # One bigram draft table shared by the slots (streams of one pool
        # mostly speak one language; exactness never depends on a draft).
        self._draft_table = None
        self._spec_stats = None
        if spec > 1:
            self._spec_stats = torch.zeros(2, dtype=torch.int64, device=dev)
            if draft == "ngram":
                self._draft_table = ngram_table_init(
                    lm.vocab_size, self._draft_token, device=dev)
        self.sessions: list[Optional["StreamingSession"]] = [None] * self.B

    # -- slots ---------------------------------------------------------------

    def attach(self, session: "StreamingSession") -> int:
        for b in range(self.B):
            if self.sessions[b] is None:
                self.sessions[b] = session
                return b
        raise RuntimeError(f"stream pool full ({self.B} slots)")

    def detach(self, slot: int) -> None:
        self.sessions[slot] = None

    @property
    def free_slots(self) -> int:
        return sum(1 for s in self.sessions if s is None)

    def _recorder(self):
        """(record(tokens, logits), result() -> (tokens, margins or None))
        for steps that emit one token at a time."""
        toks, marg = [], []
        keep = self.model.record_margins

        def record(t, logits):
            toks.append(t.reshape(-1))
            if keep:
                marg.append(top2_margin(logits).reshape(-1))

        return record, lambda: (torch.cat(toks),
                                torch.cat(marg) if keep else None)

    def _enc_slot(self, b: int, length: int) -> KVCache:
        return KVCache(self.enc_k[:, b:b + 1], self.enc_v[:, b:b + 1], length)

    # -- slot checkpoints ----------------------------------------------------

    def _solo_geometry(self) -> tuple[int, int]:
        """(solo max_dec, solo decoder ring size) a checkpoint of this
        pool is laid out for: what ``StreamingSession.__init__`` builds
        (the pool's ring may be chunk-grown, its bounded caches carry
        the sacrificial granule)."""
        if self.unbounded:
            ring = self.cfg.language_model.sliding_window + self.P
            return PREFIX_LEN + ring, ring
        return self.max_dec, 0

    def slot_state(self, sess: "StreamingSession") -> dict:
        """Snapshot of one pooled session in the solo layout
        (position-major caches, solo geometry), so
        ``StreamingSession.restore`` rebuilds it solo or in another
        pool, in either package.  int8 caches are dequantized on the way
        out; the requantization on the way into an int8 pool is exact
        (each vector's largest element maps to +-127, so scale and codes
        come back)."""
        b = sess._slot
        p0 = sess._positions_done
        solo_max_dec, solo_ring = self._solo_geometry()
        enc_k = _to_numpy(self.enc_k[:, b:b + 1])  # [L, 1, s_enc, H, hd]
        enc_v = _to_numpy(self.enc_v[:, b:b + 1])
        if self._fused is not None:
            km, vm = self._kv.read(b, self.model.device)  # [L, H, S, hd]
            dk = _to_numpy(km.transpose(1, 2)[:, None])  # [L, 1, S, H, hd]
            dv = _to_numpy(vm.transpose(1, 2)[:, None])
        else:
            dk, dv = _to_numpy(self.dec_k[b]), _to_numpy(self.dec_v[b])
        if self.unbounded:
            if self._dec_ring[1] != solo_ring:
                dk = _ring_remap(dk, PREFIX_LEN, self._dec_ring[1],
                                 solo_ring, p0)
                dv = _ring_remap(dv, PREFIX_LEN, self._dec_ring[1],
                                 solo_ring, p0)
        else:
            dk, dv = dk[:, :, :solo_max_dec], dv[:, :, :solo_max_dec]
            enc_k = enc_k[:, :, :4 * solo_max_dec]
            enc_v = enc_v[:, :, :4 * solo_max_dec]
        return {
            "version": StreamingSession.CHECKPOINT_VERSION,
            "P": self.P,
            "unbounded": self.unbounded,
            "max_dec": solo_max_dec,
            "delay_tokens": self.delay_tokens,
            "samples": np.asarray(sess._samples, np.float32),
            "samples_base": sess._samples_base,
            "positions_done": p0,
            "tokens": np.asarray(sess.tokens, np.int32),
            "text": sess._text,
            "finished": sess._finished,
            "prev_token": int(self.prev_tok[b]),
            "prev_audio": _to_numpy(self.prev_audio[b][None]),
            "enc_k": enc_k,
            "enc_v": enc_v,
            "enc_len": 4 * p0,
            "dec_k": dk,
            "dec_v": dv,
            "dec_len": p0,
            "endpoint_mark": sess._endpoint_mark,
        }

    def write_slot(self, b: int, state: dict) -> None:
        """Load a solo-layout checkpoint into slot ``b`` (the inverse of
        :meth:`slot_state`)."""
        p0 = int(state["positions_done"])
        dev = self.model.device
        _, solo_ring = self._solo_geometry()
        dk, dv = _host_f32(state["dec_k"]), _host_f32(state["dec_v"])
        enc_k, enc_v = _host_f32(state["enc_k"]), _host_f32(state["enc_v"])
        if self.unbounded:
            if self._dec_ring[1] != solo_ring:
                dk = _ring_remap(dk, PREFIX_LEN, solo_ring,
                                 self._dec_ring[1], p0)
                dv = _ring_remap(dv, PREFIX_LEN, solo_ring,
                                 self._dec_ring[1], p0)
        else:
            def pad(a, slots):  # the sacrificial slots, zero
                width = [(0, 0)] * a.ndim
                width[2] = (0, slots - a.shape[2])
                return np.pad(a, width)

            dk, dv = pad(dk, self._s_dec), pad(dv, self._s_dec)
            enc_k, enc_v = pad(enc_k, self._s_enc), pad(enc_v, self._s_enc)

        def dev16(a):
            return to_torch(a, dev).to(self.model.cache_dtype)

        if self._fused is not None:
            self._kv.write(b, to_torch(dk, dev)[:, 0], to_torch(dv, dev)[:, 0])
        else:
            self.dec_k[b], self.dec_v[b] = dev16(dk), dev16(dv)
        self.enc_k[:, b:b + 1] = dev16(enc_k)
        self.enc_v[:, b:b + 1] = dev16(enc_v)
        self.prev_tok[b] = int(state["prev_token"])
        self.prev_audio[b] = to_torch(_host_f32(state["prev_audio"]),
                                      dev).to(self.model.compute_dtype)[0]

    # -- steps ---------------------------------------------------------------

    def _slot_init(self, b: int, sess: "StreamingSession",
                   pending: list) -> None:
        """The solo session's first step on slot ``b``: the encoder into
        the slot's cache views, the decoder into the shared init slot
        (fused pools), whose first 38 + P rows then move head-major into
        the slot, quantized when the caches are int8."""
        need = PREFIX_LEN + self.P
        mel0 = sess._mel_window(0, 16 * need + 8)
        if self._fused is not None:
            dec0 = KVCache(self._init_dec_zero.k, self._init_dec_zero.v, 0)
        else:
            dec0 = KVCache(self.dec_k[b], self.dec_v[b], 0)
        self.enc_k[:, b] = 0
        self.enc_v[:, b] = 0
        record, result = self._recorder()
        enc = [self._enc_slot(b, 0)]

        def encode(x):
            audio, enc[0] = _encode(self.model, x, enc[0], self._enc_rope,
                                    self._enc_ring)
            return audio

        last, prev_audio, dec_cache = _init_step(
            self.model, self.P, mel0, self._t_embed, encode,
            self._enc_ring and self._enc_ring[0], dec0, self._dec_rope,
            self._dec_ring, record)
        if self._fused is not None:
            # The init wrote slots [0, need) in both layouts (a ring's
            # head, then the start of its body).
            self._kv.write(b, dec_cache.k[:, 0, :need],
                           dec_cache.v[:, 0, :need])
        else:
            self.dec_k[b, :, :, need:] = 0
            self.dec_v[b, :, :, need:] = 0
        self.prev_tok[b] = last[0]
        self.prev_audio[b] = prev_audio[0]
        pending.append((sess, *result()))
        sess._positions_done = need

    def pump(self) -> None:
        """Run every step that has audio, batching across the ready
        sessions, until none can advance.  Token fetches are deferred to
        the end (the next step's inputs live on the device), and they
        happen even when a step raises: the positions of the finished
        steps already advanced.  With ``model.record_margins`` the
        sessions also get each token's top-2 logit margin."""
        # (session, tokens, top-2 margins or None) on the device, in order
        pending: list = []
        try:
            with torch.no_grad():
                self._pump_loop(pending)
        finally:
            if pending:
                flat = torch.cat([t for _, t, _ in pending]).tolist()
                marg = (torch.cat([m for _, _, m in pending]).tolist()
                        if pending[0][2] is not None else None)
                at = 0
                for sess, t, _ in pending:
                    sess.tokens.extend(flat[at:at + t.numel()])
                    if marg is not None:
                        sess.margins.extend(marg[at:at + t.numel()])
                    at += t.numel()

    def _pump_loop(self, pending: list) -> None:
        dev = self.model.device
        while True:
            progressed = False
            for b, sess in enumerate(self.sessions):
                if (sess is not None and sess._positions_done == 0
                        and sess._available_positions()
                        >= PREFIX_LEN + self.P):
                    self._slot_init(b, sess, pending)
                    progressed = True

            ready = [False] * self.B
            for b, sess in enumerate(self.sessions):
                if sess is None or sess._positions_done == 0:
                    continue
                if sess._positions_done + self.P > self.max_dec:
                    # Mark, do not raise: one overlong stream must not
                    # stall the others.
                    sess.overrun = True
                    continue
                if (sess._available_positions()
                        >= sess._positions_done + self.P):
                    ready[b] = True
            if not any(ready):
                if not progressed:
                    return
                continue

            n_ready = sum(ready)
            if self._fused is None:
                with span("pool_step", ready=n_ready, fused=False):
                    self._pool_step(ready, pending)
            else:
                n_mels = self.cfg.audio.num_mel_bins
                mel_wins = np.zeros((self.B, n_mels, 16 * self.P + 8),
                                    np.float32)
                if self.unbounded:
                    # No sacrificial slots in a ring: a masked row writes
                    # at its own next slots.
                    done = [s._positions_done if s is not None else 0
                            for s in self.sessions]
                else:
                    done = [self.max_dec] * self.B  # the sacrificial slots
                with span("pool_mel", ready=n_ready):
                    for b, sess in enumerate(self.sessions):
                        if ready[b]:
                            p0 = sess._positions_done
                            mel_wins[b] = sess._mel_window(
                                16 * p0 - MEL_MARGIN,
                                16 * (p0 + self.P) + MEL_MARGIN)[0]
                            done[b] = p0
                dec_len = torch.tensor(done, dtype=torch.int32, device=dev)
                step = (self._pool_step_spec if self.speculative > 1
                        else self._pool_step_fused)
                with span("pool_step", ready=n_ready, fused=True):
                    tokens, margins = step(
                        mel_wins, torch.tensor(ready, device=dev), dec_len)
                for b, sess in enumerate(self.sessions):
                    if ready[b]:
                        pending.append((sess, tokens[b], None if margins
                                        is None else margins[b]))
            for b, sess in enumerate(self.sessions):
                if ready[b]:
                    sess._positions_done += self.P
                    if self.unbounded:
                        sess._trim_samples()

    def _pool_step(self, ready: list, pending: list) -> None:
        """The generic step, for a model without fused weights (packed
        q4): each ready slot takes the solo per-op step on its own cache
        views.  A Python loop over the slots, here and only here: the
        per-op decoder is launch-bound at one row and has no batched
        form in either package's kernels (JAX vmaps the same step)."""
        for b, sess in enumerate(self.sessions):
            if not ready[b]:
                continue
            p0 = sess._positions_done
            mel = sess._mel_window(16 * p0 - MEL_MARGIN,
                                   16 * (p0 + self.P) + MEL_MARGIN)
            audio, _ = _encode(
                self.model, _conv(self.model, mel)[:, 1:1 + 4 * self.P],
                self._enc_slot(b, 4 * p0), self._enc_rope, self._enc_ring)
            inputs = torch.cat([self.prev_audio[b:b + 1], audio[:, :-1]],
                               dim=1)
            record, result = self._recorder()
            last, _ = _decode_per_op(
                self.model, inputs, self.prev_tok[b:b + 1],
                KVCache(self.dec_k[b], self.dec_v[b], p0), self._t_embed,
                self._dec_rope, self._dec_ring, record)
            self.prev_tok[b] = last[0]
            self.prev_audio[b] = audio[0, -1:]
            pending.append((sess, *result()))

    def _encode_windows(self, mel_wins: np.ndarray, ready: torch.Tensor,
                        dec_len: torch.Tensor) -> torch.Tensor:
        """The encode half of a fused step: B windows in one batched pass
        (per-row cache lengths and ring phases), the P decoder inputs
        per slot [B, P, D]; ready slots' last embed is kept for the next
        step."""
        x = _conv(self.model, mel_wins)[:, 1:1 + 4 * self.P]
        audio, _ = _encode(
            self.model, x, KVCache(self.enc_k, self.enc_v, 4 * dec_len),
            self._enc_rope, self._enc_ring)
        inputs = torch.cat([self.prev_audio, audio[:, :-1]], dim=1)
        self.prev_audio = torch.where(ready[:, None, None], audio[:, -1:],
                                      self.prev_audio)
        return inputs

    def _slots(self, positions: torch.Tensor) -> torch.Tensor:
        if self._dec_ring is None:
            return positions
        return ring_slot(positions, *self._dec_ring)

    def _pool_step_fused(self, mel_wins: np.ndarray, ready: torch.Tensor,
                         dec_len: torch.Tensor) -> torch.Tensor:
        """One pooled step: the batched encoder, then P fused decode
        steps over all B rows (K1, or the meshed route), each row at its
        own offset, RoPE position and ring phase.  -> (tokens [B, P],
        top-2 margins [B, P] or None); a masked row's are dropped by the
        caller."""
        dec, lm = self.model.params["decoder"], self.cfg.language_model
        inputs = self._encode_windows(mel_wins, ready, dec_len)
        prev = self.prev_tok
        rows = torch.arange(self.B, device=ready.device)
        tokens, margins = [], []
        for i in range(self.P):
            offs = dec_len + i  # [B] absolute positions
            text = embed_tokens(dec, prev.long()[:, None])[:, 0]
            x = (inputs[:, i] + text).float()
            cos, sin = k1.rope_pair_vectors(offs, lm.head_dim, lm.rope_theta)
            prev, logits, k_new, v_new = self._decode(x, offs, cos, sin)
            # The step reads visible slots only, and a row's slot(offs)
            # is not one, so the append in place is safe.
            self._kv.append(k_new, v_new, self._slots(offs.long()), rows)
            tokens.append(prev)
            if self.model.record_margins:
                margins.append(top2_margin(logits))
        self.prev_tok = torch.where(ready, prev, self.prev_tok)
        return (torch.stack(tokens, dim=1),
                torch.stack(margins, dim=1) if margins else None)

    def _pool_step_spec(self, mel_wins: np.ndarray, ready: torch.Tensor,
                        dec_len: torch.Tensor) -> torch.Tensor:
        """One pooled speculative step: K1 ``spec=K`` passes until every
        ready slot has decoded P positions.  Each pass verifies K drafts
        per slot; a slot advances by its own accepted count.  Slots that
        finished, or are not ready, ride the passes with their position
        frozen: their appends land at their own later positions (masked
        by the offsets, overwritten by the next true append) and their
        tokens in the buffer's K spare columns or, not ready, nowhere
        that is read.  The host reads one bool per pass.  -> (tokens
        [B, P], top-2 margins [B, P] or None)."""
        dec, lm = self.model.params["decoder"], self.cfg.language_model
        dev = ready.device
        B, P, K = self.B, self.P, self.speculative
        inputs = self._encode_windows(mel_wins, ready, dec_len)
        # K copies of the last row keep every K-row slice in bounds.
        inputs = torch.cat([inputs, inputs[:, -1:].expand(-1, K, -1)], dim=1)
        rows = torch.arange(B, device=dev)
        stream = rows.repeat_interleave(K)  # the cache row of a step row
        slot = torch.arange(K, device=dev)
        pos = torch.zeros(B, dtype=torch.long, device=dev)
        prev = self.prev_tok
        toks = torch.zeros((B, P + K), dtype=torch.int32, device=dev)
        marg = (torch.zeros((B, P + K), device=dev)
                if self.model.record_margins else None)
        pad = torch.full((B, K - 1), self._draft_token, dtype=torch.int32,
                         device=dev)
        table = self._draft_table
        while bool((ready & (pos < P)).any()):
            offs = dec_len.long() + pos  # [B] per-slot absolute positions
            drafts = (ngram_drafts(table, prev, K) if table is not None
                      else torch.cat([prev[:, None], pad], dim=1))
            idx = pos[:, None] + slot  # [B, K]
            text = embed_tokens(dec, drafts.long())
            x = (inputs[rows[:, None], idx] + text).reshape(B * K, -1)
            at = (offs[:, None] + slot).reshape(-1)
            cos, sin = k1.rope_pair_vectors(at, lm.head_dim, lm.rope_theta)
            y, logits, k_new, v_new = self._decode(
                x.float(), offs.to(torch.int32), cos, sin, spec=K)
            y = y.reshape(B, K)
            match = (y[:, :K - 1] == drafts[:, 1:]).to(torch.int32)
            n_acc = 1 + torch.cumprod(match, dim=1).sum(dim=1)
            live = ready & (pos < P)
            adv = torch.where(live, torch.minimum(n_acc, P - pos), 0)
            # All K fresh rows of every slot go in, at offs + j.
            self._kv.append(k_new, v_new, self._slots(at), stream)
            toks.scatter_(1, idx, y)
            if marg is not None:
                marg.scatter_(1, idx, top2_margin(logits).reshape(B, K))
            picked = y.gather(1, (adv - 1).clamp(0, K - 1)[:, None])[:, 0]
            prev = torch.where(adv > 0, picked, prev)
            if table is not None:
                # Live slots only: a masked slot's y comes from no audio.
                ngram_train(table, drafts, y, live)
            self._spec_stats += torch.stack([torch.ones_like(adv[0]),
                                             adv.sum()])
            pos = pos + adv
        self.prev_tok = torch.where(ready, prev, self.prev_tok)
        return toks[:, :P], None if marg is None else marg[:, :P]

    def spec_metrics(self) -> Optional[dict]:
        """The pool's speculative counters (one host read; None when
        spec is off): ``accepted_rows`` sums the slots' advances, so
        ``tokens_per_pass`` is the pool's aggregate (up to ready slots
        x K)."""
        if self.speculative <= 1:
            return None
        passes, accepted = self._spec_stats.tolist()
        return {
            "passes": passes,
            "accepted_rows": accepted,
            "tokens_per_pass": round(accepted / max(1, passes), 3),
            "draft": self.draft,
        }


def session_geometry(cfg, step_positions: int, max_duration_s: float,
                     unbounded: bool) -> tuple:
    """(decoder ring, encoder ring, decoder slots, encoder slots) of a
    solo session's caches; the rings are (head, size), None when
    bounded."""
    if not unbounded:
        max_dec = int(max_duration_s * 6.25) + PREFIX_LEN + 2 * step_positions
        return None, None, max_dec, 4 * max_dec
    # Ring sizes: the window + one write granule (the decoder writes P
    # positions per step, the encoder 4P frames), the encoder ring
    # rounded to its granule so no write wraps.
    lm, enc = cfg.language_model, cfg.audio_encoder
    gran = 4 * step_positions
    dec_ring = (PREFIX_LEN, lm.sliding_window + step_positions)
    enc_ring = (4 * PREFIX_LEN, -(-(enc.sliding_window + gran) // gran) * gran)
    return dec_ring, enc_ring, sum(dec_ring), sum(enc_ring)


def _session_cache_bytes(model: VoxtralModel, max_dec: int,
                         max_enc: int) -> tuple[int, int]:
    """(decoder cache bytes, all cache bytes) of a solo session."""
    lm, enc = model.config.language_model, model.config.audio_encoder
    itemsize = torch.empty((), dtype=model.cache_dtype).element_size()
    dec_bytes = 2 * itemsize * lm.n_layers * max_dec * lm.n_kv_heads * (
        lm.head_dim)
    return dec_bytes, dec_bytes + 2 * itemsize * (
        enc.n_layers * max_enc * enc.n_kv_heads * enc.head_dim)


def solo_cache_bytes(model: VoxtralModel, step_positions: int = 8,
                     max_duration_s: float = 120.0,
                     unbounded: bool = False) -> int:
    """The cache bytes a solo ``StreamingSession(model, ...)`` of these
    arguments allocates (its ``cache_bytes``), without making one."""
    _, _, max_dec, max_enc = session_geometry(
        model.config, step_positions, max_duration_s, unbounded)
    return _session_cache_bytes(model, max_dec, max_enc)[1]


class StreamingSession:
    """Incremental transcription over a live 16 kHz mono stream, on the
    model's device: solo (batch 1, its own caches) or, with ``pool=``,
    in a slot of a :class:`StreamPool`, which steps it with the others."""

    CHECKPOINT_VERSION = 1

    def __init__(
        self,
        model: VoxtralModel,
        tokenizer: Optional[VoxtralTokenizer] = None,
        delay_tokens: float = 6.0,
        step_positions: int = 8,  # 8 x 160 ms = 1.28 s per step
        max_duration_s: float = 120.0,
        pad_config: Optional[PadConfig] = None,
        unbounded: bool = False,
        pool=None,
        speculative: int = 0,
        draft_token: int = STREAMING_PAD,
        draft: str = "pad",
    ):
        """``unbounded=True``: head+ring caches (window-sized, allocated
        up front), no duration limit but the RoPE table's; else caches
        for ``max_duration_s`` of audio.  ``speculative=K >= 2`` verifies
        K drafted tokens per K1 pass (``draft`` "pad" or "ngram"); it
        needs the fused route and K <= ``step_positions``.  Raises
        ValueError when K1 cannot take the cache geometry and
        :class:`~voxtral_tpu_torch.utils.hbm.HBMBudgetError` when the
        caches would not fit the card.  ``pool=``: the session takes a
        free slot of the pool and its geometry, step size and delay; the
        pool owns the caches and decodes (speculative is then the
        pool's)."""
        check_draft(draft)
        self.model = model
        self.tokenizer = tokenizer
        self.cfg = model.config
        self.P = step_positions
        self.pad_config = pad_config or PadConfig.voxtral()
        self._mel = MelSpectrogram.voxtral()
        self.unbounded = unbounded
        self._delay_tokens = delay_tokens
        self.speculative = int(speculative or 0)
        self._draft_token = int(draft_token)
        self.draft = draft
        self._pool = pool
        self._slot: Optional[int] = None
        # The audio buffer starts with the 76-token silence left pad
        # (= exactly the 38-position prefill).
        self._samples = np.zeros(self.pad_config.left_pad_samples(),
                                 np.float32)
        self._samples_base = 0  # samples trimmed from the buffer's head
        self._positions_done = 0
        self.tokens: list[int] = []
        # Top-2 logit margin per token when ``model.record_margins`` is
        # set (diagnostics for near-tie flips).
        self.margins: list[float] = []
        self._text = ""
        self._finished = False
        self._endpoint_mark = 0
        self.overrun = False  # pooled: the stream outran the pool's caches
        if pool is not None:
            if speculative:
                raise ValueError(
                    "speculative decode is the pool's on a pooled session "
                    "(StreamPool(speculative=K)), not the session's")
            if unbounded and not pool.unbounded:
                raise ValueError(
                    "unbounded pooled sessions need an unbounded pool "
                    "(StreamPool(unbounded=True))")
            self.unbounded = pool.unbounded
            self.P = pool.P
            self._max_dec = pool.max_dec
            # The pool's time embedding drives the decode, so its delay
            # is the session's (word timestamps, checkpoints).
            self._delay_tokens = pool.delay_tokens
            self._fused = False  # the pool decodes
            self._slot = pool.attach(self)
            return
        lm, enc = self.cfg.language_model, self.cfg.audio_encoder
        dev = model.device
        (self._dec_ring, self._enc_ring, self._max_dec,
         self._max_enc) = session_geometry(self.cfg, self.P, max_duration_s,
                                           unbounded)
        rope_positions = (DECODER_ROPE_MAX_SEQ if unbounded
                          else self._max_dec)

        # On a mesh the stream runs on data group 0's shards: K4 / K5 / K6
        # over its model shards (tp > 1), K1 on its device (dp > 1, tp = 1).
        # JAX replicates the one stream over the data axis; the tokens
        # are the same.
        tp = _mesh_shape(model)[1]
        self._tp_mesh = (Mesh([model.parallel.mesh.devices[0]]) if tp > 1
                         else None)
        self._fused = _fused_weights(model) is not None
        if self.speculative > 1:
            if not self._fused:
                raise ValueError(
                    "speculative decode needs the fused K1 step (w8, q4g or "
                    f"bf16 weights); this model decodes {model.decode_route}")
            if self.speculative > self.P:
                raise ValueError(
                    f"speculative={self.speculative} must be <= "
                    f"step_positions={self.P}")
        spec = max(1, self.speculative)
        if self._tp_mesh is not None:
            tpk.check_tp_geometry(self._max_dec, lm.head_dim,
                                  lm.sliding_window, spec, lm.n_kv_heads,
                                  lm.hidden_dim, tp, self._dec_ring)
        elif self._fused:
            # No per-op fallback: a geometry K1 cannot take is an error.
            k1.check_geometry(self._max_dec, lm.head_dim, lm.sliding_window,
                              spec, self._dec_ring)
        cache_dtype = model.cache_dtype  # bf16; f32 on an f32 model
        dec_bytes, self.cache_bytes = _session_cache_bytes(
            model, self._max_dec, self._max_enc)
        # On a tp mesh the shards hold the head-major decoder caches; the
        # first device the encoder's and the init's position-major one.
        sharded = self._tp_mesh is not None
        check_hbm(model, dec_bytes if sharded else self.cache_bytes,
                  f"StreamingSession(unbounded={unbounded}, "
                  f"max_duration_s={max_duration_s})", rows=1,
                  first_bytes=self.cache_bytes if sharded else 0)

        self.enc_cache = create_encoder_cache(enc, 1, self._max_enc,
                                              cache_dtype, dev)
        self.dec_cache = create_cache(lm, 1, self._max_dec, cache_dtype, dev)
        self._enc_rope = rope_tables(enc.head_dim, 4 * rope_positions,
                                     enc.rope_theta, device=dev)
        self._dec_rope = rope_tables(lm.head_dim, rope_positions,
                                     lm.rope_theta, device=dev)
        self._t_embed = model.t_embed(delay_tokens)
        self._kv = self._decode = self._ada = None
        if self._fused:
            with torch.no_grad():
                self._ada = k1.ada_vectors(model.params["decoder"],
                                           self._t_embed, model._mm)
        self._draft_table = None
        self._spec_stats = None
        if self.speculative > 1:
            # (passes, accepted rows), accumulated on the device.
            self._spec_stats = torch.zeros(2, dtype=torch.int64, device=dev)
            if draft == "ngram":
                self._draft_table = ngram_table_init(
                    lm.vocab_size, self._draft_token, device=dev)

        self._prev_token = torch.zeros(1, dtype=torch.int32, device=dev)
        self._prev_audio = torch.zeros((1, 1, lm.dim),
                                       dtype=model.compute_dtype, device=dev)

    # -- steps ---------------------------------------------------------------

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder layers over new conv frames x [1, n, D] (appended to
        the encoder cache) + adapter -> audio embeds [1, n / 4, D]."""
        audio, self.enc_cache = _encode(self.model, x, self.enc_cache,
                                        self._enc_rope, self._enc_ring)
        return audio

    def _record(self, out: list, tokens: torch.Tensor,
                logits: torch.Tensor) -> None:
        """Queue decoded tokens (and their top-2 margins when the model
        records them) for the host, on the device."""
        out.append((tokens.reshape(-1), top2_margin(logits)
                    if self.model.record_margins else None))

    def _decode_per_op(self, inputs: torch.Tensor, prev: torch.Tensor,
                       out: list):
        """:func:`_decode_per_op` over this session's cache; queues each
        token on ``out``; -> the last token."""
        prev, self.dec_cache = _decode_per_op(
            self.model, inputs, prev, self.dec_cache, self._t_embed,
            self._dec_rope, self._dec_ring,
            lambda t, lg: self._record(out, t, lg))
        return prev

    def _init_step(self, mel0: np.ndarray, out: list) -> None:
        """:func:`_init_step` on this session's caches."""
        self._prev_token, self._prev_audio, self.dec_cache = _init_step(
            self.model, self.P, mel0, self._t_embed, self._encode,
            self._enc_ring and self._enc_ring[0], self.dec_cache,
            self._dec_rope, self._dec_ring,
            lambda t, lg: self._record(out, t, lg))
        if self._fused:
            c = self.dec_cache
            self._attach_kv(c.k[:, 0], c.v[:, 0], c.length)

    def _attach_kv(self, k: torch.Tensor, v: torch.Tensor,
                   length: int) -> None:
        """The fused decode's head-major caches from position-major k / v
        [L, S, H, hd] (the init's, or a checkpoint's), once: on the
        model's device, or as the shards of data group 0 of the mesh
        (:class:`_ShardedKV`), and the decode over them."""
        mesh = self._tp_mesh
        w = _fused_weights(self.model)
        if mesh is not None:  # data group 0's shards
            w = {name: leaf[:1] for name, leaf in w.items()}
        self._kv = _ShardedKV(mesh.devices if mesh else [[self.model.device]],
                              1, self.cfg.language_model, k.shape[1], False,
                              self.model.cache_dtype)
        self._kv.write(0, k, v)
        self._decode = _decoder(self.model, w, self._ada, self._kv,
                                self._dec_ring, None, mesh)
        self.dec_cache = KVCache(*self._kv.exposed()[:2], length)

    def _steady_inputs(self, mel_win: np.ndarray) -> torch.Tensor:
        """Encode the step's 4P frames -> the decoder's P audio inputs
        (the previous step's last embed, then all but this step's last)."""
        audio = self._encode(
            _conv(self.model, mel_win)[:, 1:1 + 4 * self.P])
        inputs = torch.cat([self._prev_audio, audio[:, :-1]], dim=1)
        self._prev_audio = audio[:, -1:]
        return inputs

    def _fused_step(self, inputs: torch.Tensor, out: list) -> None:
        """P sequential fused steps (K1, or the TP halves and K6) over the
        head-major caches."""
        dec, lm = self.model.params["decoder"], self.cfg.language_model
        c = self.dec_cache
        off0 = c.length
        at = torch.arange(off0, off0 + self.P, device=inputs.device)
        cos, sin = k1.rope_pair_vectors(at, lm.head_dim, lm.rope_theta)
        slots = at if self._dec_ring is None else ring_slot(
            at, *self._dec_ring)
        row = torch.zeros(1, dtype=torch.long, device=inputs.device)
        prev = self._prev_token
        for i in range(self.P):
            text = embed_tokens(dec, prev.long()[:, None])[:, 0]
            x = (inputs[:, i] + text).float()
            prev, logits, k_new, v_new = self._decode(x, off0 + i, cos[i],
                                                      sin[i])
            # The step reads visible slots only, and slot(off) is not one
            # (in a ring: it holds a position outside the window), so the
            # append in place leaves the step's inputs as they were.
            self._kv.append(k_new, v_new, slots[i:i + 1], row)
            self._record(out, prev, logits)
        self.dec_cache = KVCache(c.k, c.v, off0 + self.P)
        self._prev_token = prev

    def _spec_step(self, inputs: torch.Tensor, out: list) -> None:
        """P positions in K1 ``spec=K`` passes: draft K tokens, verify
        them in one pass, keep the exact-greedy prefix (JAX
        ``_stream_step_spec_fn``).  The offset advances on the device
        and reaches K1 as its offset vector; the host reads one bool per
        pass (the loop exit)."""
        dec, lm = self.model.params["decoder"], self.cfg.language_model
        dev = inputs.device
        P, K = self.P, self.speculative
        c = self.dec_cache
        # K - 1 copies of the last row keep the K-row slice at pos = P - 1
        # in bounds; those rows' outputs are never accepted.
        inputs = torch.cat([inputs, inputs[:, -1:].expand(-1, K - 1, -1)],
                           dim=1)[0]
        slot = torch.arange(K, device=dev)
        pos = torch.zeros((), dtype=torch.long, device=dev)
        off = torch.full((1,), c.length, dtype=torch.int32, device=dev)
        prev = self._prev_token[0]
        toks = torch.zeros(P + K - 1, dtype=torch.int32, device=dev)
        marg = torch.zeros(P + K - 1, device=dev) \
            if self.model.record_margins else None
        pad = torch.full((K - 1,), self._draft_token, dtype=torch.int32,
                         device=dev)
        while bool(pos < P):
            if self._draft_table is not None:
                drafts = ngram_drafts(self._draft_table, prev, K)
            else:
                drafts = torch.cat([prev[None], pad])
            text = embed_tokens(dec, drafts.long()[None])[0]
            x = (inputs[pos + slot] + text).float()  # [K, D] rows (0, j)
            at = off.long() + slot  # absolute positions of the K rows
            cos, sin = k1.rope_pair_vectors(at, lm.head_dim, lm.rope_theta)
            y, logits, k_new, v_new = self._decode(x, off, cos, sin,
                                                   spec=K)  # y: [K]
            match = (y[:K - 1] == drafts[1:]).to(torch.int32)
            n_acc = torch.minimum(1 + torch.cumprod(match, dim=0).sum(),
                                  P - pos)
            # All K fresh rows go in, at their (ring) slots: rows past the
            # accepted count stay invisible until later appends overwrite
            # them (slots map deterministically from positions).
            slots = at if self._dec_ring is None else ring_slot(
                at, *self._dec_ring)
            self._kv.append(k_new, v_new, slots,
                            torch.zeros(K, dtype=torch.long, device=dev))
            toks[pos + slot] = y
            if marg is not None:
                marg[pos + slot] = top2_margin(logits)
            prev = y[n_acc - 1]
            if self._draft_table is not None:
                ngram_train(self._draft_table, drafts[None], y[None],
                            torch.ones(1, dtype=torch.bool, device=dev))
            self._spec_stats += torch.stack([torch.ones_like(n_acc), n_acc])
            pos = pos + n_acc
            off = off + n_acc.to(torch.int32)
        self.dec_cache = KVCache(c.k, c.v, c.length + P)
        self._prev_token = prev[None]
        out.append((toks[:P], None if marg is None else marg[:P]))

    # -- the step loop -------------------------------------------------------

    def _mel_window(self, frame_lo: int, frame_hi: int) -> np.ndarray:
        """Mel frames [frame_lo, frame_hi) [1, n_mels, n], exact against
        the whole-signal computation.  Indices are absolute; the buffer's
        head may be trimmed (``_samples_base``)."""
        base = self._samples_base
        if frame_lo == 0:
            logmel = self._mel.compute_log(
                self._samples[:_mel_frames_needed(frame_hi) - base])
            return logmel[:frame_hi].T[None]
        lo = frame_lo - MEL_MARGIN
        s0 = MEL_HOP * lo - base
        if s0 < 0:
            raise RuntimeError("audio buffer trimmed past the needed window")
        samples = self._samples[s0:_mel_frames_needed(frame_hi) - base]
        logmel = self._mel.compute_log(samples)
        return logmel[MEL_MARGIN:MEL_MARGIN + (frame_hi - frame_lo)].T[None]

    def _available_positions(self) -> int:
        """Positions whose encoder frames (with conv and STFT lookahead)
        the buffered samples can compute."""
        n = len(self._samples) + self._samples_base
        # Frame f is computable once 160 (f - 1) + 360 <= n samples.
        max_frame = (n - 360) // MEL_HOP + 1
        return max(0, (max_frame - 8) // 16)

    def _run_ready_steps(self) -> None:
        if self._pool is not None:
            self._pool.pump()
            return
        # Deferred fetches: a backlogged session runs its catch-up steps
        # back to back on the device and reads the tokens once.
        pending: list = []
        try:
            with torch.no_grad():
                self._step_loop(pending)
        finally:
            # Tokens of completed steps survive a mid-loop error (the
            # duration / RoPE bounds): their positions already advanced.
            if pending:
                self.tokens.extend(
                    torch.cat([t for t, _ in pending]).tolist())
                if self.model.record_margins:
                    self.margins.extend(
                        torch.cat([m for _, m in pending]).tolist())

    def _step_loop(self, pending: list) -> None:
        while True:
            avail = self._available_positions()
            if self._positions_done == 0:
                need = PREFIX_LEN + self.P
                if avail < need:
                    return
                self._init_step(self._mel_window(0, 16 * need + 8), pending)
                self._positions_done = need
            elif avail >= self._positions_done + self.P:
                self._check_bounds()
                p0 = self._positions_done
                inputs = self._steady_inputs(
                    self._mel_window(16 * p0 - 4, 16 * (p0 + self.P) + 4))
                if self.speculative > 1:
                    self._spec_step(inputs, pending)
                elif self._fused:
                    self._fused_step(inputs, pending)
                else:
                    self._prev_token = self._decode_per_op(
                        inputs, self._prev_token, pending)
                self._positions_done = p0 + self.P
            else:
                return

    def _check_bounds(self) -> None:
        """Bounded: the cache's end.  Unbounded: the RoPE table's end
        (the rings evict on the device); trim the host sample buffer."""
        if not self.unbounded:
            if self._positions_done + self.P > self._max_dec:
                raise RuntimeError(
                    "stream exceeded max_duration_s; use unbounded=True")
            return
        if self._positions_done + self.P > DECODER_ROPE_MAX_SEQ:
            raise RuntimeError(
                f"stream exceeded {DECODER_ROPE_MAX_SEQ} decoder positions "
                "(~43 min), the RoPE table's bound")
        self._trim_samples()

    def _trim_samples(self) -> None:
        """Drop host samples before the earliest future mel window
        (frame 16 p0 - MEL_MARGIN), in 10 s steps."""
        keep_from = max(
            0, MEL_HOP * (16 * self._positions_done - 2 * MEL_MARGIN) - 400)
        if keep_from - self._samples_base > 10 * 16000:
            drop = keep_from - self._samples_base
            self._samples = self._samples[drop:]
            self._samples_base += drop

    def _emit(self) -> str:
        if self.tokenizer is None:
            return ""
        text = self.tokenizer.decode([t for t in self.tokens if t >= 1000])
        if not self._finished:
            # A multi-byte UTF-8 character split across tokens decodes to
            # a trailing U+FFFD now and the character later: hold the
            # replacement back until it completes (or until finish()).
            while text.endswith("�"):
                text = text[:-1]
        delta = text[len(self._text):]
        self._text = text
        return delta

    # -- public API ----------------------------------------------------------

    def feed(self, samples: np.ndarray, pump: bool = True) -> str:
        """Append 16 kHz mono samples; returns the newly decoded text.
        ``pump=False`` only buffers them."""
        if self._finished:
            raise RuntimeError("session already finished")
        self._samples = np.concatenate(
            [self._samples, np.asarray(samples, np.float32)])
        if not pump:
            return ""
        self._run_ready_steps()
        return self._emit()

    def finish(self) -> str:
        """Right-pad with silence (alignment + 17 tokens, rounded up to a
        whole step) and decode every remaining position."""
        if self._finished:
            return ""
        self._finished = True
        total_abs = self._samples_base + len(self._samples)
        total = total_abs + self.pad_config.right_pad_samples(total_abs)
        target_positions = total // SAMPLES_PER_POSITION
        over = max(target_positions - PREFIX_LEN, self.P)
        rounded = PREFIX_LEN + (-(-over // self.P)) * self.P
        needed = _mel_frames_needed(16 * rounded + 8)
        pad = max(0, needed - self._samples_base - len(self._samples))
        self._samples = np.concatenate([self._samples,
                                        np.zeros(pad, np.float32)])
        self._run_ready_steps()
        if self._pool is not None and self._slot is not None:
            self._pool.detach(self._slot)
            self._slot = None
        return self._emit()

    @property
    def text(self) -> str:
        return self._text

    @property
    def words(self) -> list[dict]:
        """Word timestamps of the tokens so far (``decode_words``: 160 ms
        per position, delay-corrected), relative to the audio start."""
        if self.tokenizer is None:
            return []
        return self.tokenizer.decode_words(
            self.tokens, delay_s=self._delay_tokens * 0.08)

    @property
    def positions_done(self) -> int:
        return self._positions_done

    def spec_metrics(self) -> Optional[dict]:
        """Speculative acceptance counters (one host read; None when spec
        is off): passes, accepted rows, tokens per pass and the share of
        the K - 1 drafts per pass the model agreed with."""
        if self.speculative <= 1:
            return None
        passes, accepted = self._spec_stats.tolist()
        if passes == 0:
            return {"passes": 0, "accepted_rows": 0,
                    "tokens_per_pass": 0.0, "draft_acceptance": 0.0}
        return {
            "passes": passes,
            "accepted_rows": accepted,
            "tokens_per_pass": round(accepted / passes, 3),
            "draft_acceptance": round(
                (accepted - passes) / ((self.speculative - 1) * passes), 4),
        }

    def endpoint(self, min_pad_run: int = 8) -> bool:
        """True when text came since the last endpoint and the stream has
        since been silent (``[STREAMING_PAD]``) for ``min_pad_run``
        positions (8 = 1.28 s).  :meth:`consume_endpoint` marks it."""
        toks = self.tokens[self._endpoint_mark:]
        if len(toks) < min_pad_run:
            return False
        if any(t != STREAMING_PAD for t in toks[-min_pad_run:]):
            return False
        return any(t >= 1000 for t in toks)

    def consume_endpoint(self) -> None:
        """Mark the current utterance boundary as handled."""
        self._endpoint_mark = len(self.tokens)

    # -- checkpoints ---------------------------------------------------------
    #
    # The JAX package's format, field for field: a checkpoint written by
    # either package restores in the other.  The decoder cache is stored
    # position-major [L, 1, S, H, hd], caches in f32 (bf16 widens
    # exactly).

    def state_dict(self) -> dict:
        """Portable snapshot of the live session (host numpy); a pooled
        session's slot comes out in the solo layout
        (:meth:`StreamPool.slot_state`)."""
        if self._pool is not None:
            return self._pool.slot_state(self)
        dk, dv = self.dec_cache.k, self.dec_cache.v
        if self._fused and self._positions_done > 0:
            # Head-major (on a mesh: gathered from the shards) ->
            # position-major [L, 1, S, H, hd].
            k, v = self._kv.read(0, self.model.device)
            dk, dv = k.transpose(1, 2)[:, None], v.transpose(1, 2)[:, None]
        return {
            "version": self.CHECKPOINT_VERSION,
            "P": self.P,
            "unbounded": self.unbounded,
            "max_dec": self._max_dec,
            "delay_tokens": self._delay_tokens,
            "samples": np.asarray(self._samples, np.float32),
            "samples_base": self._samples_base,
            "positions_done": self._positions_done,
            "tokens": np.asarray(self.tokens, np.int32),
            "text": self._text,
            "finished": self._finished,
            "prev_token": int(self._prev_token.reshape(-1)[0]),
            "prev_audio": _to_numpy(self._prev_audio),
            "enc_k": _to_numpy(self.enc_cache.k),
            "enc_v": _to_numpy(self.enc_cache.v),
            "enc_len": int(self.enc_cache.length),
            "dec_k": _to_numpy(dk),
            "dec_v": _to_numpy(dv),
            "dec_len": int(self.dec_cache.length),
            "endpoint_mark": self._endpoint_mark,
        }

    def save(self, path) -> None:
        """:meth:`state_dict` as a compressed ``.npz``."""
        np.savez_compressed(path, **{k: np.asarray(v) for k, v in
                                     self.state_dict().items()})

    @classmethod
    def restore(cls, model: VoxtralModel, state: dict,
                tokenizer: Optional[VoxtralTokenizer] = None, pool=None,
                speculative: int = 0, draft: str = "pad",
                ) -> "StreamingSession":
        """Rebuild a live session from a :meth:`state_dict` (of either
        package) on ``model``, whose architecture must match; its decode
        route may differ (the caches are re-laid-out on entry).  Arrays
        may be numpy (f32 or bf16) or tensors.  ``pool=``: the session
        takes a slot of that pool and the caches go into the pool's
        (quantized anew when they are int8)."""
        if int(state["version"]) != cls.CHECKPOINT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {state['version']}")
        P = int(state["P"])
        if pool is not None:
            unbounded = bool(state["unbounded"])
            if pool.P != P or pool.unbounded != unbounded:
                raise ValueError(
                    f"pool geometry mismatch: checkpoint P={P} "
                    f"unbounded={unbounded}, pool P={pool.P} "
                    f"unbounded={pool.unbounded}")
            if pool._solo_geometry()[0] != int(state["max_dec"]):
                raise ValueError(
                    f"cache geometry mismatch: checkpoint max_dec="
                    f"{state['max_dec']}, pool normalizes to "
                    f"{pool._solo_geometry()[0]}")
            if float(pool.delay_tokens) != float(state["delay_tokens"]):
                raise ValueError(
                    f"delay_tokens mismatch: checkpoint "
                    f"{state['delay_tokens']}, pool {pool.delay_tokens} "
                    "(the pool's time embedding would change the output)")
            s = cls(model, tokenizer, pool=pool)
            s._load_host_state(state)
            pool.write_slot(s._slot, state)
            return s
        # __init__ derives max_dec = int(mds * 6.25) + ...; the +0.5
        # keeps int() from landing one position short under float error.
        mds = (int(state["max_dec"]) - PREFIX_LEN - 2 * P + 0.5) / 6.25
        s = cls(model, tokenizer, delay_tokens=float(state["delay_tokens"]),
                step_positions=P, max_duration_s=mds,
                unbounded=bool(state["unbounded"]), speculative=speculative,
                draft=draft)
        if s._max_dec != int(state["max_dec"]):
            raise ValueError(
                f"cache geometry mismatch: checkpoint max_dec="
                f"{state['max_dec']}, rebuilt {s._max_dec} (the "
                "architecture differs from the checkpointed model)")
        dev = model.device
        s._load_host_state(state)
        s._prev_token = torch.tensor([int(state["prev_token"])],
                                     dtype=torch.int32, device=dev)

        def cache(a):  # numpy (f32 or bf16) or a tensor
            if not isinstance(a, torch.Tensor):
                a = to_torch(np.asarray(a), dev)
            return a.to(dev, model.cache_dtype, copy=True)

        s._prev_audio = cache(state["prev_audio"]).to(model.compute_dtype)
        s.enc_cache = KVCache(cache(state["enc_k"]), cache(state["enc_v"]),
                              int(state["enc_len"]))
        dk, dv = cache(state["dec_k"]), cache(state["dec_v"])
        if s._fused and s._positions_done > 0:
            s._attach_kv(dk[:, 0], dv[:, 0], int(state["dec_len"]))
        else:
            s.dec_cache = KVCache(dk, dv, int(state["dec_len"]))
        return s

    def _load_host_state(self, state: dict) -> None:
        """The host side of a checkpoint: samples, positions, tokens."""
        self._samples = np.asarray(state["samples"], np.float32)
        self._samples_base = int(state["samples_base"])
        self._positions_done = int(state["positions_done"])
        self.tokens = [int(t) for t in np.asarray(state["tokens"])]
        self._text = str(state["text"])
        self._finished = bool(state["finished"])
        self._endpoint_mark = int(state["endpoint_mark"])

    @classmethod
    def load(cls, model: VoxtralModel, path,
             tokenizer: Optional[VoxtralTokenizer] = None,
             pool=None) -> "StreamingSession":
        """Restore from a :meth:`save` file (of either package), solo or
        into a slot of ``pool``."""
        with np.load(path, allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        for k in ("version", "P", "unbounded", "max_dec", "delay_tokens",
                  "samples_base", "positions_done", "finished",
                  "prev_token", "enc_len", "dec_len", "endpoint_mark"):
            state[k] = state[k].item()
        state["text"] = str(state["text"])
        return cls.restore(model, state, tokenizer, pool)
