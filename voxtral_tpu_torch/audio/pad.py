"""Streaming-alignment padding.

Behavioral contract mirrors the reference (``voxtral-mini-realtime-rs/src/audio/pad.rs``):

* Left-pad **76 tokens** of silence (upstream mistral-common default is 32;
  raised so the full 38-token decoder prefix sees only silence — the Q4
  model is sensitive to speech content in the prefix, pad.rs:6-14,32-46).
* Right-pad to a token boundary plus **17 extra tokens** for conv/reshape
  alignment (pad.rs:64-74).
* 1 token = 1280 samples at 16 kHz / 12.5 Hz (pad.rs:54-57).

The port's own copy of ``voxtral_tpu/audio/pad.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from voxtral_tpu_torch.audio.io import AudioBuffer


@dataclasses.dataclass
class PadConfig:
    sample_rate: int = 16000
    # 76 tokens at 12.5 Hz = 38 decoder tokens of silence, covering the whole
    # streaming prefix (BOS + 37 pad). f32 works with the upstream 32 but Q4
    # needs the full prefix covered.
    n_left_pad_tokens: int = 76
    frame_rate: float = 12.5
    extra_right_pad_tokens: int = 17

    @classmethod
    def voxtral(cls) -> "PadConfig":
        return cls()

    def samples_per_token(self) -> int:
        return int(self.sample_rate / self.frame_rate)

    def left_pad_samples(self) -> int:
        return self.n_left_pad_tokens * self.samples_per_token()

    def right_pad_samples(self, total_samples: int) -> int:
        """Padding to reach a token boundary, plus the extra alignment pad."""
        spt = self.samples_per_token()
        remainder = total_samples % spt
        alignment_pad = 0 if remainder == 0 else spt - remainder
        return alignment_pad + self.extra_right_pad_tokens * spt


def pad_audio(audio: AudioBuffer, config: PadConfig | None = None) -> AudioBuffer:
    """Left-pad with silence and right-pad to token alignment."""
    config = config or PadConfig.voxtral()
    left = config.left_pad_samples()
    right = config.right_pad_samples(len(audio.samples) + left)
    samples = np.concatenate(
        [
            np.zeros(left, dtype=np.float32),
            audio.samples.astype(np.float32),
            np.zeros(right, dtype=np.float32),
        ]
    )
    return AudioBuffer(samples=samples, sample_rate=audio.sample_rate)


def num_audio_tokens(num_samples: int, config: PadConfig | None = None) -> int:
    config = config or PadConfig.voxtral()
    return num_samples // config.samples_per_token()
