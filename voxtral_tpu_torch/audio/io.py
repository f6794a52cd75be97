"""WAV loading/saving with automatic format conversion.

Mirrors the reference's behavior (``voxtral-mini-realtime-rs/src/audio/io.rs``):
any bit depth / int or float WAVs are loaded, mixed to mono by averaging
channels, and normalized to [-1, 1].  ``peak_normalize(0.95)`` lifts quiet
audio so the Q4 path can resolve mel features (io.rs:59-68; the fix that
took FLEURS WER from 44.59% to 8.49%, reference CHANGELOG.md:33-37).

The port's own copy of ``voxtral_tpu/audio/io.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class AudioBuffer:
    """Mono audio samples in [-1, 1] plus sample rate."""

    samples: np.ndarray  # float32 [n]
    sample_rate: int

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def duration_secs(self) -> float:
        return len(self.samples) / self.sample_rate

    @property
    def duration_ms(self) -> float:
        return self.duration_secs * 1000.0

    def peak_normalize(self, target_peak: float = 0.95) -> "AudioBuffer":
        """Scale so max |sample| == target_peak; no-op on silence."""
        max_amp = float(np.max(np.abs(self.samples))) if len(self.samples) else 0.0
        if max_amp < 1e-10:
            return self
        self.samples = (self.samples * (target_peak / max_amp)).astype(np.float32)
        return self

    def append(self, other: "AudioBuffer") -> "AudioBuffer":
        if self.sample_rate != other.sample_rate:
            raise ValueError(
                f"Sample rate mismatch: {self.sample_rate} vs {other.sample_rate}"
            )
        self.samples = np.concatenate([self.samples, other.samples])
        return self

    def save(self, path: str | Path) -> None:
        save_wav(self, path)


def load_wav(path: str | Path) -> AudioBuffer:
    """Load a WAV file as mono float32 in [-1, 1].

    Malformed/truncated files raise ``ValueError`` with context (the
    reference gets this from hound's typed errors; a corrupt upload must
    die cleanly, not crash deeper in the pipeline)."""
    from scipy.io import wavfile

    try:
        sample_rate, data = wavfile.read(str(path))
    except ValueError as e:
        raise ValueError(f"failed to parse WAV {path}: {e}") from e
    except Exception as e:  # struct.error / EOFError from truncation
        raise ValueError(
            f"failed to parse WAV {path}: truncated or not a WAV ({e})"
        ) from e
    if sample_rate <= 0:
        raise ValueError(f"WAV {path}: invalid sample rate {sample_rate}")

    if data.dtype == np.uint8:
        samples = (data.astype(np.float32) - 128.0) / 128.0
    elif data.dtype == np.int16:
        samples = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        samples = data.astype(np.float32) / 2147483648.0
    elif data.dtype in (np.float32, np.float64):
        samples = data.astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV sample dtype: {data.dtype}")

    # Mix multi-channel to mono by averaging.
    if samples.ndim == 2:
        samples = samples.mean(axis=1)

    return AudioBuffer(samples=samples.astype(np.float32), sample_rate=int(sample_rate))


def save_wav(audio: AudioBuffer, path: str | Path) -> None:
    """Save mono float32 samples as 16-bit PCM WAV."""
    from scipy.io import wavfile

    clipped = np.clip(audio.samples, -1.0, 1.0)
    pcm = (clipped * 32767.0).astype(np.int16)
    wavfile.write(str(path), audio.sample_rate, pcm)
