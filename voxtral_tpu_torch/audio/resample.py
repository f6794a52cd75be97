"""Resampling to 16 kHz (Voxtral's expected input rate).

The reference uses rubato's FFT resampler (``src/audio/resample.rs``); we
use scipy's polyphase resampler, which has equivalent quality for ASR
purposes (the mel frontend is robust to the tiny differences in
anti-aliasing filter shape).

The port's own copy of ``voxtral_tpu/audio/resample.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import math

from voxtral_tpu_torch.audio.io import AudioBuffer


def resample(audio: AudioBuffer, target_rate: int) -> AudioBuffer:
    """Resample to target_rate; returns the input unchanged if already there."""
    if audio.sample_rate == target_rate:
        return audio

    from scipy.signal import resample_poly
    import numpy as np

    g = math.gcd(audio.sample_rate, target_rate)
    up = target_rate // g
    down = audio.sample_rate // g
    out = resample_poly(audio.samples.astype(np.float64), up, down)
    return AudioBuffer(samples=out.astype(np.float32), sample_rate=target_rate)


def resample_to_16k(audio: AudioBuffer) -> AudioBuffer:
    return resample(audio, 16000)
