"""Chunking long audio at the ``max_source_positions`` limit.

Mirrors the reference (``voxtral-mini-realtime-rs/src/audio/chunk.rs``): chunks of at
most ``max_mel_frames * hop_length`` samples, stepping by
``(max_mel_frames - overlap_frames) * hop_length``.  The CLI default is
1200 frames (vs the model's 1500) — kept in the JAX package's CLI.

The port's own copy of ``voxtral_tpu/audio/chunk.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass
class ChunkConfig:
    max_mel_frames: int = 1500
    hop_length: int = 160
    sample_rate: int = 16000
    overlap_frames: int = 0

    @classmethod
    def voxtral(cls) -> "ChunkConfig":
        return cls()

    def with_max_frames(self, max_frames: int) -> "ChunkConfig":
        return dataclasses.replace(self, max_mel_frames=max_frames)

    def with_overlap(self, overlap_frames: int) -> "ChunkConfig":
        return dataclasses.replace(self, overlap_frames=overlap_frames)

    def max_samples_per_chunk(self) -> int:
        return self.max_mel_frames * self.hop_length

    def step_samples(self) -> int:
        return (self.max_mel_frames - self.overlap_frames) * self.hop_length

    def max_duration_secs(self) -> float:
        return self.max_samples_per_chunk() / self.sample_rate


@dataclasses.dataclass
class AudioChunk:
    samples: np.ndarray
    start_sample: int
    end_sample: int
    index: int
    is_last: bool

    def duration_secs(self, sample_rate: int) -> float:
        return len(self.samples) / sample_rate

    def start_time(self, sample_rate: int) -> float:
        return self.start_sample / sample_rate

    def end_time(self, sample_rate: int) -> float:
        return self.end_sample / sample_rate


def iter_chunks(samples: np.ndarray, config: ChunkConfig) -> Iterator[AudioChunk]:
    position = 0
    index = 0
    n = len(samples)
    while position < n:
        start = position
        end = min(start + config.max_samples_per_chunk(), n)
        yield AudioChunk(
            samples=samples[start:end],
            start_sample=start,
            end_sample=end,
            index=index,
            is_last=end >= n,
        )
        position += config.step_samples()
        index += 1


def chunk_audio(samples: np.ndarray, config: ChunkConfig | None = None) -> List[AudioChunk]:
    return list(iter_chunks(samples, config or ChunkConfig.voxtral()))


def needs_chunking(num_samples: int, config: ChunkConfig | None = None) -> bool:
    config = config or ChunkConfig.voxtral()
    return num_samples > config.max_samples_per_chunk()


def num_chunks(num_samples: int, config: ChunkConfig | None = None) -> int:
    config = config or ChunkConfig.voxtral()
    if num_samples == 0:
        return 0
    step = config.step_samples()
    if step == 0:
        return 1
    return -(-num_samples // step)
