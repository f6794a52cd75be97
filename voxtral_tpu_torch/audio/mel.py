"""Log-mel spectrogram frontend (vLLM/Voxtral-exact normalization).

The port's own copy of the numpy log-mel of ``voxtral_tpu/audio/mel.py``
(the port imports nothing of the JAX package).  The JAX module's
on-device mel and its native C++ backend are not copied: the device
mel is a later slice of the port (ROADMAP queue 1, item 10c).

Behavioral contract mirrors the reference (``voxtral-mini-realtime-rs/src/audio/mel.rs``):

* STFT: reflect-pad by ``n_fft/2`` on both sides (torch ``center=True``),
  periodic Hann window, and the **last frame is dropped** to match the
  Python reference's ``stft[..., :-1]`` (mel.rs:178-182, 211-213).
* 128-bin Slaney-scale mel filterbank with area normalization
  (librosa defaults; mel.rs:288-339).
* vLLM-style log normalization (mel.rs:128-165):
  1. ``log10(max(mel, 1e-10))``
  2. floor at ``global_log_mel_max - 8`` (max = 1.5 for Voxtral Realtime;
     if the config max is <= 0, the per-audio max is used instead)
  3. ``(x + 4) / 4`` — **no clamp** (vLLM doesn't clamp; Whisper does).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MelConfig:
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    win_length: Optional[int] = None
    n_mels: int = 128
    fmin: float = 0.0
    fmax: Optional[float] = None
    # Global log-mel max for normalization; <= 0 means "use per-audio max".
    log_mel_max: float = 1.5

    @classmethod
    def voxtral(cls) -> "MelConfig":
        return cls(win_length=400)


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Hz -> mel, Slaney/O'Shaughnessy scale (linear below 1 kHz)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp  # 15.0
    logstep = np.log(6.4) / 27.0
    return np.where(
        f < min_log_hz,
        f / f_sp,
        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
    )


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m < min_log_mel,
        m * f_sp,
        min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel) - min_log_mel)),
    )


def create_mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Triangular Slaney filterbank [n_mels, n_fft//2+1], area-normalized."""
    n_freqs = n_fft // 2 + 1

    mel_min = hz_to_mel(fmin)
    mel_max = hz_to_mel(fmax)
    mel_points = mel_min + (mel_max - mel_min) * np.arange(n_mels + 2) / (n_mels + 1)
    hz_points = mel_to_hz(mel_points)  # [n_mels + 2]

    fft_freqs = np.arange(n_freqs, dtype=np.float64) * sample_rate / n_fft

    f_lower = hz_points[:-2, None]  # [n_mels, 1]
    f_center = hz_points[1:-1, None]
    f_upper = hz_points[2:, None]
    freq = fft_freqs[None, :]  # [1, n_freqs]

    rising = np.where(
        (freq >= f_lower) & (freq <= f_center) & (f_center > f_lower),
        (freq - f_lower) / np.maximum(f_center - f_lower, 1e-30),
        0.0,
    )
    falling = np.where(
        (freq > f_center) & (freq <= f_upper) & (f_upper > f_center),
        (f_upper - freq) / np.maximum(f_upper - f_center, 1e-30),
        0.0,
    )
    fb = rising + falling

    # Slaney area normalization: 2 / (upper - lower) per band.
    band_width = hz_points[2:] - hz_points[:-2]
    enorm = np.where(band_width > 0, 2.0 / np.maximum(band_width, 1e-30), 0.0)
    fb = fb * enorm[:, None]

    return fb.astype(np.float32)


def hann_window_periodic(length: int) -> np.ndarray:
    """Periodic Hann: 0.5*(1 - cos(2*pi*n/N)), matches torch.hann_window."""
    n = np.arange(length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / length))).astype(np.float32)


class MelSpectrogram:
    """Mel spectrogram extractor with precomputed filterbank and window
    (the numpy rFFT path)."""

    def __init__(self, config: Optional[MelConfig] = None):
        self.config = config or MelConfig.voxtral()
        c = self.config
        fmax = c.fmax if c.fmax is not None else c.sample_rate / 2.0
        win_length = c.win_length if c.win_length is not None else c.n_fft

        self.mel_basis = create_mel_filterbank(
            c.sample_rate, c.n_fft, c.n_mels, c.fmin, fmax
        )  # [n_mels, n_freqs]
        self.window = hann_window_periodic(win_length)  # [win_length]

    @classmethod
    def voxtral(cls) -> "MelSpectrogram":
        return cls(MelConfig.voxtral())

    # -- frame accounting ---------------------------------------------------

    def num_frames(self, num_samples: int) -> int:
        """Frames for torch.stft center=True minus the dropped last frame."""
        pad = self.config.n_fft // 2
        padded_len = num_samples + 2 * pad
        return (padded_len - self.config.n_fft) // self.config.hop_length

    # -- numpy path ---------------------------------------------------------

    def _frames(self, samples: np.ndarray) -> np.ndarray:
        """Reflect-pad and frame the signal -> [n_frames, n_fft]."""
        c = self.config
        pad = c.n_fft // 2
        padded = np.pad(samples.astype(np.float32), pad, mode="reflect")
        n_frames = (len(padded) - c.n_fft) // c.hop_length
        idx = (
            np.arange(n_frames)[:, None] * c.hop_length
            + np.arange(c.n_fft)[None, :]
        )
        return padded[idx]

    def stft_power(self, samples: np.ndarray) -> np.ndarray:
        """Power spectrogram |STFT|^2 -> [n_frames, n_fft//2+1].

        Uses scipy's pocketfft in float32 (2x the speed of numpy's
        f64-only rfft; |error| ~1e-6 relative, far below the mel golden
        tolerances).
        """
        frames = self._frames(samples) * self.window[None, :]
        try:
            from scipy.fft import rfft as _rfft

            spec = _rfft(frames, axis=-1, workers=-1)
        except ImportError:  # pragma: no cover
            spec = np.fft.rfft(frames.astype(np.float64), axis=-1)
        return (spec.real**2 + spec.imag**2).astype(np.float32)

    def compute(self, samples: np.ndarray) -> np.ndarray:
        """Linear mel spectrogram [n_frames, n_mels]."""
        power = self.stft_power(samples)
        return power @ self.mel_basis.T

    def compute_log(self, samples: np.ndarray) -> np.ndarray:
        """Log mel with vLLM normalization [n_frames, n_mels]."""
        mel = self.compute(samples)
        log_mel = np.log10(np.maximum(mel, 1e-10))

        if self.config.log_mel_max > 0.0:
            log_max = self.config.log_mel_max
        else:
            log_max = float(log_mel.max())
        log_mel = np.maximum(log_mel, log_max - 8.0)

        return ((log_mel + 4.0) / 4.0).astype(np.float32)

    def compute_log_batch(self, samples: np.ndarray) -> np.ndarray:
        """compute_log transposed to model layout [1, n_mels, n_frames]."""
        return self.compute_log(samples).T[None, :, :]
