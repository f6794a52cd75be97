"""Complete Voxtral Realtime model, sequential greedy decode
(port of the w8 fused route of ``voxtral_tpu/models/voxtral.py``).

Behaviour kept from the reference:

* prefix of 38 positions: BOS=1 + 37 x ``[STREAMING_PAD]``=32; the first
  generated token comes from position 37's logits;
* per-step input = ``audio_embeds[pos] + embed(prev_token)``;
* greedy argmax (first index of the maximum, as ``jnp.argmax``) at every
  position up to the audio length.

The decode loop is a Python loop over positions on the model's device:
one K1 stack step (``ops/decode_step.py``) per token, the K/V append in
place, the argmax fed back without a host round trip; the tokens reach
the host once per call.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from voxtral_tpu.config import VoxtralConfig
from voxtral_tpu.tokenizer import BOS_TOKEN, STREAMING_PAD
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
from voxtral_tpu_torch.models.layers import rope_tables
from voxtral_tpu_torch.models.time_embedding import time_embedding
from voxtral_tpu_torch.ops import decode_step as k1
from voxtral_tpu_torch.ops import w8_kernel as k2

Params = dict[str, Any]

PREFIX_LEN = 38


def make_prefix_ids() -> np.ndarray:
    """BOS + 37 x [STREAMING_PAD] (38 total)."""
    return np.array([BOS_TOKEN] + [STREAMING_PAD] * (PREFIX_LEN - 1),
                    dtype=np.int32)


def select_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy argmax over the vocab -> int32 [B] (first index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def encode_audio_fn(params: Params, mel: torch.Tensor, cfg: VoxtralConfig,
                    mm=None) -> torch.Tensor:
    """mel [B, n_mels, T] -> audio embeds [B, T/16, llm_dim]."""
    enc = encoder_forward(params["encoder"], mel, cfg.audio_encoder, mm)
    return adapter_forward(params["adapter"],
                           reshape_encoder_output(enc, cfg.downsample_factor),
                           mm)


def transcribe_streaming_fn(params: Params, mel: torch.Tensor,
                            t_embed: torch.Tensor, cfg: VoxtralConfig,
                            fused: Params, mm=None, step=None,
                            margins: Optional[list] = None) -> torch.Tensor:
    """Greedy transcription of a batch of mels -> int32 [B, S - 38].

    ``fused``: the stacks of :func:`ops.decode_step.fuse_decode_weights`.
    ``mm`` / ``step``: the W8A8 GEMM and the decode step (the kernel
    wrappers by default; their plain versions run the same path without
    the kernels).  ``margins``, when a list, receives the top-2 logit
    margin [B] of every position (diagnostics for near-tie flips).
    """
    step = step or k1.decode_stack_step
    lm_cfg = cfg.language_model
    dev = mel.device
    dec = params["decoder"]

    audio_embeds = encode_audio_fn(params, mel, cfg, mm)  # [B, S, D]
    batch, seq_len = audio_embeds.shape[0], audio_embeds.shape[1]
    prefix_ids = torch.as_tensor(make_prefix_ids(), device=dev).long()
    prefix_inputs = (audio_embeds[:, :PREFIX_LEN, :]
                     + embed_tokens(dec, prefix_ids[None].expand(batch, -1)))

    cache = create_cache(lm_cfg, batch, seq_len, device=dev)
    rope = rope_tables(lm_cfg.head_dim, seq_len, lm_cfg.rope_theta, device=dev)
    # Prefill: fills cache positions 0..37, predicts the token at 38.
    hidden, cache = decoder_forward_hidden_with_cache(
        dec, prefix_inputs, t_embed, cache, lm_cfg, rope, mm=mm)
    logits = lm_head(dec, hidden[:, -1, :], mm=mm)  # [B, V]

    n_steps = seq_len - PREFIX_LEN - 1
    tokens = torch.empty((batch, n_steps + 1), dtype=torch.int32, device=dev)
    token = select_token(logits)
    tokens[:, 0] = token
    if margins is not None:
        margins.append(_top2_margin(logits))

    ada_vecs = k1.ada_vectors(dec, t_embed, mm)
    # Head-major copy of the prefilled cache for the step: [L, B, Hkv, S, hd].
    k_cache = cache.k.permute(0, 1, 3, 2, 4).contiguous()
    v_cache = cache.v.permute(0, 1, 3, 2, 4).contiguous()
    del cache
    cos_t, sin_t = k1.rope_pair_vectors(
        torch.arange(seq_len, device=dev), lm_cfg.head_dim, lm_cfg.rope_theta)
    emb = dec["tok_embeddings"]["w8"]
    final_norm = dec["norm"].float()
    for i in range(n_steps):
        off = PREFIX_LEN + i
        text = embed_tokens(dec, token.long()[:, None])  # [B, 1, D]
        x = (audio_embeds[:, off:off + 1, :] + text)[:, 0, :].float()
        _, k_new, v_new, logits = step(
            x, off, fused["attn_norm"], fused["ffn_norm"], ada_vecs,
            fused["sqkv"], fused["so"], fused["s13"], fused["s2"],
            cos_t[off], sin_t[off], k_cache, v_cache,
            fused["wqkv"], fused["wo"], fused["w13"], fused["w2"],
            final_norm=final_norm, lm_codes=emb["codes"],
            lm_scale=emb["scale"], n_heads=lm_cfg.n_heads,
            n_kv=lm_cfg.n_kv_heads, head_dim=lm_cfg.head_dim,
            eps=lm_cfg.norm_eps, window=lm_cfg.sliding_window)
        # The step reads slots < off only, so appending in place at off
        # leaves its inputs as they were.
        k_cache[:, :, :, off] = k_new
        v_cache[:, :, :, off] = v_new
        token = select_token(logits)
        tokens[:, i + 1] = token
        if margins is not None:
            margins.append(_top2_margin(logits))
    return tokens


def _top2_margin(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to voxtral_tpu_torch yet ({item})")


class VoxtralModel:
    """Parameter tree + config on one device, sequential greedy decode.

    ``params``: the port's tensor tree (see ``convert.params_from_numpy``)
    with w8 decoder layers.  ``kernels=False`` runs the same path through
    the plain PyTorch versions of the kernels (for comparison on the
    card; on the CPU the kernel wrappers take the plain versions anyway).
    """

    # The w8 model computes the encoder, adapter and prefill in bf16, as
    # the JAX w8 model does, and keeps a bf16 KV cache (K1's format).
    compute_dtype = torch.bfloat16

    def __init__(self, params: Params, config: Optional[VoxtralConfig] = None,
                 device: DeviceLike = None, *, kernels: bool = True):
        disable_tf32()
        self.device = resolve_device(device)
        self.params = params
        self.config = config or VoxtralConfig.voxtral()
        wq = params["decoder"]["layers"]["attention"]["wq"]
        if not (isinstance(wq, dict) and "w8" in wq):
            _not_ported("decoding with dense, q4 or q4g weights",
                        "ROADMAP queue 1, item 9")
        self.fused_decode = k1.fuse_decode_weights(params["decoder"])
        self._mm = None if kernels else k2.w8_matmul_plain
        self._step = k1.decode_stack_step if kernels \
            else k1.decode_stack_step_plain
        # Set to True to keep the top-2 logit margins of the last call
        # in ``last_margins`` ([B, S - 38] numpy).
        self.record_margins = False
        self.last_margins: Optional[np.ndarray] = None

    @classmethod
    def from_numpy(cls, tree: Params, config: Optional[VoxtralConfig] = None,
                   device: DeviceLike = None, **kw) -> "VoxtralModel":
        """Model from the JAX package's numpy parameter tree."""
        from voxtral_tpu_torch.convert import params_from_numpy

        return cls(params_from_numpy(tree, device), config, device, **kw)

    # -- API ----------------------------------------------------------------

    def t_embed(self, delay_tokens: float = 6.0) -> torch.Tensor:
        emb = time_embedding(delay_tokens, self.config.language_model.dim)
        return torch.as_tensor(emb, device=self.device).to(self.compute_dtype)

    def _cast_mel(self, mel) -> torch.Tensor:
        return torch.as_tensor(mel, device=self.device).to(self.compute_dtype)

    def encode_audio(self, mel) -> torch.Tensor:
        return encode_audio_fn(self.params, self._cast_mel(mel), self.config,
                               self._mm)

    def decoder_seq_len(self, mel_frames: int) -> int:
        """Decoder positions for a mel length: floor(floor(T/4)/4) on even T."""
        t1 = (mel_frames + 1) // 2
        t2 = (t1 + 1) // 2
        return t2 // self.config.downsample_factor

    def transcribe_streaming(self, mel, delay_tokens: float = 6.0,
                             temperature: float = 0.0, top_k: int = 0,
                             speculative: int = 0) -> np.ndarray:
        """One mel chunk [1, n_mels, T] -> int32 tokens after the prefix."""
        if temperature > 0.0 or top_k > 0:
            _not_ported("temperature / top-k sampling",
                        "ROADMAP queue 1, item 8")
        return self.transcribe_streaming_batch(
            mel, delay_tokens, speculative=speculative)[0]

    def transcribe_streaming_batch(self, mel_batch, delay_tokens: float = 6.0,
                                   speculative: int = 0) -> np.ndarray:
        """B equal-length mel chunks [B, n_mels, T] -> int32 [B, S - 38]."""
        if speculative >= 2:
            _not_ported("speculative decode", "ROADMAP queue 1, item 8")
        mel = self._cast_mel(mel_batch)
        if self.decoder_seq_len(mel.shape[-1]) < PREFIX_LEN + 1:
            return np.zeros((mel.shape[0], 0), dtype=np.int32)
        margins = [] if self.record_margins else None
        with torch.no_grad():
            tokens = transcribe_streaming_fn(
                self.params, mel, self.t_embed(delay_tokens), self.config,
                self.fused_decode, self._mm, self._step, margins)
        if margins is not None:
            self.last_margins = torch.stack(margins, dim=1).cpu().numpy()
        return tokens.cpu().numpy()
