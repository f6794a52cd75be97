"""Audio-language adapter + encoder-output reshape (port of
``voxtral_tpu/models/adapter.py``): Linear(5120->3072) -> GELU ->
Linear(3072->3072), no biases.
"""

from __future__ import annotations

from typing import Any

import torch

from voxtral_tpu_torch.models.layers import gelu, linear

Params = dict[str, Any]


def reshape_encoder_output(x: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """[B, S, D] -> [B, S//factor, D*factor], truncating trailing frames."""
    b, s, d = x.shape
    new_s = s // factor
    return x[:, : new_s * factor, :].reshape(b, new_s, d * factor)


def adapter_forward(params: Params, x: torch.Tensor, mm=None) -> torch.Tensor:
    """Linear -> GELU -> Linear."""
    return linear(gelu(linear(x, params["w1"], mm=mm)), params["w2"], mm=mm)
