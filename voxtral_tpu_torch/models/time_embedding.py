"""Sinusoidal time embedding encoding the transcription delay.

A numpy copy of ``voxtral_tpu/models/time_embedding.py`` (that module
cannot be imported without jax, through ``voxtral_tpu/models/__init__``):
``[cos(t * f) ‖ sin(t * f)]`` with ``f_i = exp(-ln(theta) * i / (dim/2))``.
"""

from __future__ import annotations

import numpy as np


def time_embedding(t: float, dim: int, theta: float = 10000.0) -> np.ndarray:
    """Returns [1, 1, dim] float32: [cos(t*inv_freq) ‖ sin(t*inv_freq)]."""
    half = dim // 2
    inv_freq = np.exp(-np.log(theta) * np.arange(half, dtype=np.float64) / half)
    angle = t * inv_freq
    emb = np.concatenate([np.cos(angle), np.sin(angle)]).astype(np.float32)
    return emb.reshape(1, 1, dim)
