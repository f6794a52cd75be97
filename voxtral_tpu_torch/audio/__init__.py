"""Audio frontend: WAV io, resampling, mel spectrogram, padding, chunking.

The port's own copy of ``voxtral_tpu/audio`` (host-side numpy; the port
imports nothing of the JAX package).
"""

from voxtral_tpu_torch.audio.io import AudioBuffer, load_wav, save_wav
from voxtral_tpu_torch.audio.resample import resample, resample_to_16k
from voxtral_tpu_torch.audio.mel import MelConfig, MelSpectrogram
from voxtral_tpu_torch.audio.pad import PadConfig, pad_audio, num_audio_tokens
from voxtral_tpu_torch.audio.chunk import (
    AudioChunk,
    ChunkConfig,
    chunk_audio,
    needs_chunking,
    num_chunks,
)

__all__ = [
    "AudioBuffer",
    "load_wav",
    "save_wav",
    "resample",
    "resample_to_16k",
    "MelConfig",
    "MelSpectrogram",
    "PadConfig",
    "pad_audio",
    "num_audio_tokens",
    "AudioChunk",
    "ChunkConfig",
    "chunk_audio",
    "needs_chunking",
    "num_chunks",
]
