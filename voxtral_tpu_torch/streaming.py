"""Real-time incremental transcription: the solo live session (port of
``voxtral_tpu/streaming.py::StreamingSession``).

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

* "w8" / "q4g": steady steps decode through the K1 stack step, its
  head+ring mask (mode (d)) on unbounded sessions, its ``spec=K`` mode
  (b) with a device-resident offset when ``speculative=K``;
* "per_op" (packed q4): the decoder op by op, K3 on every linear.

The first step (encoder frames [0, 4 (38 + P)), the prefill, the first
token and the P - 1 positions after it) runs the decoder op by op on
every route, as JAX does.  ``lax.scan`` / ``while_loop`` become Python
loops on the model's device; tokens reach the host once per
``feed`` / ``finish`` (deferred fetches), and a speculative pass reads
one bool to decide whether another is needed.  ``unbounded=True`` lays
both caches out as head+ring buffers (a permanent 38-position prefix
head and a ring covering the sliding window), so a session runs until
the RoPE table ends (16384 decoder positions, ~43 min).
"""

from __future__ import annotations

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
    _not_ported,
    append_rows,
    check_draft,
    fused_step_fn,
    make_prefix_ids,
    ngram_drafts,
    ngram_table_init,
    ngram_train,
    select_token,
    top2_margin,
)
from voxtral_tpu_torch.ops import decode_step as k1
from voxtral_tpu_torch.tokenizer import STREAMING_PAD, VoxtralTokenizer
from voxtral_tpu_torch.utils.hbm import check_hbm

MEL_HOP = 160
MEL_MARGIN = 4  # STFT frames of margin so window-interior frames are exact
SAMPLES_PER_POSITION = 2560  # 16 mel frames


def _mel_frames_needed(last_frame: int) -> int:
    """Samples required so mel frames [0, last_frame) are computable."""
    return MEL_HOP * (last_frame - 1) + 200 + MEL_HOP


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 widens to f32 (exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class StreamingSession:
    """Incremental transcription over a live 16 kHz mono stream (solo:
    one session, batch 1, on the model's device)."""

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
        caches would not fit the card."""
        if pool is not None:
            _not_ported("StreamPool (pooled streaming sessions)",
                        "ROADMAP queue 1, item 10")
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
        lm, enc = self.cfg.language_model, self.cfg.audio_encoder
        dev = model.device
        if unbounded:
            # Ring sizes: the window + one write granule (the decoder
            # writes P positions per step, the encoder 4P frames), the
            # encoder ring rounded to its granule so no write wraps.
            gran = 4 * self.P
            self._dec_ring = (PREFIX_LEN, lm.sliding_window + self.P)
            self._enc_ring = (4 * PREFIX_LEN,
                              -(-(enc.sliding_window + gran) // gran) * gran)
            self._max_dec = sum(self._dec_ring)
            self._max_enc = sum(self._enc_ring)
            rope_positions = DECODER_ROPE_MAX_SEQ
        else:
            self._dec_ring = self._enc_ring = None
            self._max_dec = (int(max_duration_s * 6.25) + PREFIX_LEN
                             + 2 * self.P)
            self._max_enc = 4 * self._max_dec
            rope_positions = self._max_dec

        self._fused = model.fused_decode is not None
        if self.speculative > 1:
            if not self._fused:
                raise ValueError(
                    "speculative decode needs the fused K1 step (w8 or q4g "
                    f"weights); this model decodes {model.decode_route}")
            if self.speculative > self.P:
                raise ValueError(
                    f"speculative={self.speculative} must be <= "
                    f"step_positions={self.P}")
        if self._fused:
            # No per-op fallback: a geometry K1 cannot take is an error.
            k1.check_geometry(self._max_dec, lm.head_dim, lm.sliding_window,
                              max(1, self.speculative), self._dec_ring)
        cache_dtype = torch.bfloat16
        self.cache_bytes = 2 * 2 * (
            enc.n_layers * self._max_enc * enc.n_kv_heads * enc.head_dim
            + lm.n_layers * self._max_dec * lm.n_kv_heads * lm.head_dim)
        check_hbm(model, self.cache_bytes,
                  f"StreamingSession(unbounded={unbounded}, "
                  f"max_duration_s={max_duration_s})", rows=1)

        self.enc_cache = create_encoder_cache(enc, 1, self._max_enc,
                                              cache_dtype, dev)
        self.dec_cache = create_cache(lm, 1, self._max_dec, cache_dtype, dev)
        self._enc_rope = rope_tables(enc.head_dim, 4 * rope_positions,
                                     enc.rope_theta, device=dev)
        self._dec_rope = rope_tables(lm.head_dim, rope_positions,
                                     lm.rope_theta, device=dev)
        self._t_embed = model.t_embed(delay_tokens)
        self._run_step = None
        if self._fused:
            dec = model.params["decoder"]
            with torch.no_grad():
                ada = k1.ada_vectors(dec, self._t_embed, model._mm)
            self._run_step = fused_step_fn(dec, model.fused_decode, ada, lm,
                                           model._mm, model._step)
        self._draft_table = None
        self._spec_stats = None
        if self.speculative > 1:
            # (passes, accepted rows), accumulated on the device.
            self._spec_stats = torch.zeros(2, dtype=torch.int64, device=dev)
            if draft == "ngram":
                self._draft_table = ngram_table_init(
                    lm.vocab_size, self._draft_token, device=dev)

        # The audio buffer starts with the 76-token silence left pad
        # (= exactly the 38-position prefill).
        self._samples = np.zeros(self.pad_config.left_pad_samples(),
                                 np.float32)
        self._samples_base = 0  # samples trimmed from the buffer's head
        self._positions_done = 0
        self._prev_token = torch.zeros(1, dtype=torch.int32, device=dev)
        self._prev_audio = torch.zeros((1, 1, lm.dim),
                                       dtype=model.compute_dtype, device=dev)
        self.tokens: list[int] = []
        # Top-2 logit margin per token when ``model.record_margins`` is
        # set (diagnostics for near-tie flips).
        self.margins: list[float] = []
        self._text = ""
        self._finished = False
        self._endpoint_mark = 0

    # -- steps ---------------------------------------------------------------

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder layers over new conv frames x [1, n, D] (appended to
        the encoder cache) + adapter -> audio embeds [1, n / 4, D]."""
        cfg, params = self.cfg, self.model.params
        hidden, self.enc_cache = encoder_layers_with_cache(
            params["encoder"], x, self.enc_cache, cfg.audio_encoder,
            self._enc_rope, ring=self._enc_ring, mm=self.model._mm)
        return adapter_forward(
            params["adapter"],
            reshape_encoder_output(hidden, cfg.downsample_factor),
            self.model._mm)

    def _conv(self, mel: np.ndarray) -> torch.Tensor:
        """Conv downsampler over a mel window -> [1, W / 4, D]."""
        mel = self.model._cast_mel(mel)
        return conv_downsample(
            mel, self.model.params["encoder"]["conv"]).transpose(1, 2)

    def _record(self, out: list, tokens: torch.Tensor,
                logits: torch.Tensor) -> None:
        """Queue decoded tokens (and their top-2 margins when the model
        records them) for the host, on the device."""
        out.append((tokens.reshape(-1), top2_margin(logits)
                    if self.model.record_margins else None))

    def _decode_per_op(self, inputs: torch.Tensor, prev: torch.Tensor,
                       out: list):
        """Greedy decode of len(inputs) positions, the decoder op by op
        over the position-major cache (JAX ``_decode_scan``); inputs
        [1, n, D] are the audio embeds of input positions.  Queues each
        token on ``out``; -> the last token."""
        dec, lm = self.model.params["decoder"], self.cfg.language_model
        for i in range(inputs.shape[1]):
            text = embed_tokens(dec, prev.long()[:, None])
            hidden, self.dec_cache = decoder_forward_hidden_with_cache(
                dec, inputs[:, i:i + 1] + text, self._t_embed,
                self.dec_cache, lm, self._dec_rope, self.model._mm,
                ring=self._dec_ring)
            logits = lm_head(dec, hidden[:, 0], mm=self.model._mm)
            prev = select_token(logits)
            self._record(out, prev, logits)
        return prev

    def _init_step(self, mel0: np.ndarray, out: list) -> None:
        """Encoder frames [0, 4 n), the 38-position prefill, the first
        token and positions 39 .. n - 1 (n = 38 + P); mel0 covers frames
        [0, 16 n + 8) so the last conv frame has its lookahead."""
        n = PREFIX_LEN + self.P
        dec = self.model.params["decoder"]
        x = self._conv(mel0)[:, :4 * n]
        if self._enc_ring is None:
            audio = self._encode(x)
        else:
            # A ring write must fit one region: the first 4 x 38 frames
            # fill the permanent head, the rest start the ring (two
            # cached calls compute what one does).
            head = self._enc_ring[0]
            audio = torch.cat([self._encode(x[:, :head]),
                               self._encode(x[:, head:])], dim=1)
        prefix = torch.as_tensor(make_prefix_ids(), device=x.device).long()
        hidden, self.dec_cache = decoder_forward_hidden_with_cache(
            dec, audio[:, :PREFIX_LEN] + embed_tokens(dec, prefix[None]),
            self._t_embed, self.dec_cache, self.cfg.language_model,
            self._dec_rope, self.model._mm, ring=self._dec_ring)
        logits = lm_head(dec, hidden[:, -1], mm=self.model._mm)
        first = select_token(logits)
        self._record(out, first, logits)
        self._prev_token = self._decode_per_op(audio[:, PREFIX_LEN:-1],
                                               first, out)
        self._prev_audio = audio[:, -1:]
        if self._fused:
            # K1 reads a head-major cache: [L, 1, S, H, hd] -> [L, 1, H,
            # S, hd], once.
            c = self.dec_cache
            self.dec_cache = KVCache(c.k.transpose(2, 3).contiguous(),
                                     c.v.transpose(2, 3).contiguous(),
                                     c.length)

    def _steady_inputs(self, mel_win: np.ndarray) -> torch.Tensor:
        """Encode the step's 4P frames -> the decoder's P audio inputs
        (the previous step's last embed, then all but this step's last)."""
        audio = self._encode(self._conv(mel_win)[:, 1:1 + 4 * self.P])
        inputs = torch.cat([self._prev_audio, audio[:, :-1]], dim=1)
        self._prev_audio = audio[:, -1:]
        return inputs

    def _fused_step(self, inputs: torch.Tensor, out: list) -> None:
        """P sequential K1 steps over the head-major cache."""
        dec, lm = self.model.params["decoder"], self.cfg.language_model
        c = self.dec_cache
        off0 = c.length
        cos, sin = k1.rope_pair_vectors(
            torch.arange(off0, off0 + self.P, device=inputs.device),
            lm.head_dim, lm.rope_theta)
        prev = self._prev_token
        for i in range(self.P):
            off = off0 + i
            text = embed_tokens(dec, prev.long()[:, None])[:, 0]
            x = (inputs[:, i] + text).float()
            _, k_new, v_new, logits = self._run_step(
                x, off, cos[i], sin[i], c.k, c.v, ring=self._dec_ring)
            # The step reads visible slots only, and slot(off) is not one
            # (in a ring: it holds a position outside the window), so the
            # append in place leaves the step's inputs as they were.
            slot = off if self._dec_ring is None else ring_slot(
                off, *self._dec_ring)
            c.k[:, :, :, slot] = k_new
            c.v[:, :, :, slot] = v_new
            prev = select_token(logits)
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
            _, k_new, v_new, logits = self._run_step(
                x, off, cos, sin, c.k, c.v, spec=K, ring=self._dec_ring)
            y = select_token(logits)  # [K]
            match = (y[:K - 1] == drafts[1:]).to(torch.int32)
            n_acc = torch.minimum(1 + torch.cumprod(match, dim=0).sum(),
                                  P - pos)
            # All K fresh rows go in, at their (ring) slots: rows past the
            # accepted count stay invisible until later appends overwrite
            # them (slots map deterministically from positions).
            slots = at if self._dec_ring is None else ring_slot(
                at, *self._dec_ring)
            rows = torch.zeros(K, dtype=torch.long, device=dev)
            append_rows(c.k, k_new, slots, rows)
            append_rows(c.v, v_new, slots, rows)
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
        """Portable snapshot of the live session (host numpy)."""
        dk, dv = self.dec_cache.k, self.dec_cache.v
        if self._fused and self._positions_done > 0:
            dk, dv = dk.transpose(2, 3), dv.transpose(2, 3)  # head-major
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
        may be numpy (f32 or bf16) or tensors."""
        if pool is not None:
            _not_ported("StreamPool (pooled streaming sessions)",
                        "ROADMAP queue 1, item 10")
        if int(state["version"]) != cls.CHECKPOINT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {state['version']}")
        P = int(state["P"])
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
        s._samples = np.asarray(state["samples"], np.float32)
        s._samples_base = int(state["samples_base"])
        s._positions_done = int(state["positions_done"])
        s.tokens = [int(t) for t in np.asarray(state["tokens"])]
        s._text = str(state["text"])
        s._finished = bool(state["finished"])
        s._endpoint_mark = int(state["endpoint_mark"])
        s._prev_token = torch.tensor([int(state["prev_token"])],
                                     dtype=torch.int32, device=dev)

        def cache(a):  # numpy (f32 or bf16) or a tensor
            if not isinstance(a, torch.Tensor):
                a = to_torch(np.asarray(a), dev)
            return a.to(dev, torch.bfloat16, copy=True)

        s._prev_audio = cache(state["prev_audio"]).to(model.compute_dtype)
        s.enc_cache = KVCache(cache(state["enc_k"]), cache(state["enc_v"]),
                              int(state["enc_len"]))
        dk, dv = cache(state["dec_k"]), cache(state["dec_v"])
        if s._fused and s._positions_done > 0:
            dk = dk.transpose(2, 3).contiguous()  # position-major -> head
            dv = dv.transpose(2, 3).contiguous()
        s.dec_cache = KVCache(dk, dv, int(state["dec_len"]))
        return s

    @classmethod
    def load(cls, model: VoxtralModel, path,
             tokenizer: Optional[VoxtralTokenizer] = None,
             pool=None) -> "StreamingSession":
        """Restore from a :meth:`save` file (of either package)."""
        with np.load(path, allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        for k in ("version", "P", "unbounded", "max_dec", "delay_tokens",
                  "samples_base", "positions_done", "finished",
                  "prev_token", "enc_len", "dec_len", "endpoint_mark"):
            state[k] = state[k].item()
        state["text"] = str(state["text"])
        return cls.restore(model, state, tokenizer, pool)
