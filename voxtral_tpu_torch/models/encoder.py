"""Causal audio encoder (port of ``voxtral_tpu/models/encoder.py``).

mel [B, 128, T] -> conv 4x downsample -> [B, T/4, 1280]
-> 32 x (pre-LN attention + SwiGLU) -> final RMSNorm.
The stacked layers run in a Python loop (the JAX ``lax.scan``); the
streaming path's cached stack writes each layer's K/V into its cache in
place.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from voxtral_tpu_torch.config import AudioEncoderConfig
from voxtral_tpu_torch.models.layers import (
    AttentionSpec,
    KVCache,
    attention_with_cache,
    conv_downsample,
    encoder_block,
    layer_params,
    n_stacked,
    rms_norm,
    rope_tables,
    swiglu,
)

Params = dict[str, Any]


def encoder_spec(cfg: AudioEncoderConfig) -> AttentionSpec:
    return AttentionSpec(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        sliding_window=cfg.sliding_window,
        causal=cfg.causal,
    )


def encoder_forward(params: Params, mel: torch.Tensor, cfg: AudioEncoderConfig,
                    mm=None) -> torch.Tensor:
    """mel [B, n_mels, T] -> hidden [B, T/4, d_model]."""
    spec = encoder_spec(cfg)
    x = conv_downsample(mel, params["conv"]).transpose(1, 2)  # [B, T/4, D]
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    cos, sin = rope_tables(cfg.head_dim, s, cfg.rope_theta, device=x.device)
    layers = params["layers"]
    for l in range(n_stacked(layers)):
        x = encoder_block(x, layer_params(layers, l), spec, cos, sin,
                          positions, cfg.norm_eps, mm)
    return rms_norm(x, params["norm"], cfg.norm_eps)


def create_encoder_cache(cfg: AudioEncoderConfig, batch: int, max_seq: int,
                         dtype=torch.bfloat16, device=None) -> KVCache:
    return KVCache.create(cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                          cfg.head_dim, dtype, device)


def encoder_layers_with_cache(
    params: Params, x: torch.Tensor, cache: KVCache, cfg: AudioEncoderConfig,
    rope: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    pos_base: int = 0, ring: Optional[tuple[int, int]] = None, mm=None,
) -> tuple[torch.Tensor, KVCache]:
    """The layer stack over pre-conv features of NEW frames only,
    x [B, S_new, d_model], appending K/V at ``cache.length`` (the
    streaming path runs the conv over an overlapping window outside).
    ``ring``: (head, size) head+ring cache layout (see
    ``layers.attention_with_cache``).  ``cache.length`` an int tensor
    [B] (the pooled step): every row appends at its own length, in one
    batched pass, so a linear sees B * S_new rows.  Returns (normed
    hidden, cache); the cache arrays are written in place."""
    spec = encoder_spec(cfg)
    if rope is None:
        rope = rope_tables(cfg.head_dim, cache.max_seq, cfg.rope_theta,
                           device=x.device)
    cos, sin = rope
    offset = cache.length
    layers = params["layers"]
    for l in range(n_stacked(layers)):
        p = layer_params(layers, l)
        hn = rms_norm(x, p["attention_norm"], cfg.norm_eps)
        attn, _, _ = attention_with_cache(
            hn, p["attention"], spec, cos, sin, cache.k[l], cache.v[l],
            offset, mm, pos_base, ring)
        x = x + attn
        hn = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
        x = x + swiglu(hn, p["ffn"], mm)
    cache = KVCache(cache.k, cache.v, offset + x.shape[1])
    return rms_norm(x, params["norm"], cfg.norm_eps), cache


def encoder_forward_with_cache(
    params: Params, mel: torch.Tensor, cache: KVCache,
    cfg: AudioEncoderConfig,
    rope: Optional[tuple[torch.Tensor, torch.Tensor]] = None, mm=None,
) -> tuple[torch.Tensor, KVCache]:
    """Chunk-incremental encoder: the conv runs per chunk (its edges
    are not exact), attention continues from the cache.  The exact
    streaming path uses :func:`encoder_layers_with_cache` over an
    overlapping conv window."""
    x = conv_downsample(mel, params["conv"]).transpose(1, 2)
    return encoder_layers_with_cache(params, x, cache, cfg, rope, mm=mm)
