"""Causal audio encoder (port of ``voxtral_tpu/models/encoder.py``).

mel [B, 128, T] -> conv 4x downsample -> [B, T/4, 1280]
-> 32 x (pre-LN attention + SwiGLU) -> final RMSNorm.
The stacked layers run in a Python loop (the JAX ``lax.scan``).
"""

from __future__ import annotations

from typing import Any

import torch

from voxtral_tpu_torch.config import AudioEncoderConfig
from voxtral_tpu_torch.models.layers import (
    AttentionSpec,
    conv_downsample,
    encoder_block,
    layer_params,
    n_stacked,
    rms_norm,
    rope_tables,
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
