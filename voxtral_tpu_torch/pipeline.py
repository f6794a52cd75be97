"""One-shot transcription pipeline: samples -> text
(port of the ``transcribe_samples`` path of ``voxtral_tpu/pipeline.py``).

resample to 16 kHz -> peak_normalize(0.95) -> chunk (<= max_mel_frames)
-> pad (76 left / align + 17 right, bucketed) -> host numpy log-mel ->
model transcribe (chunks of one padded length decode as one batch) ->
decode tokens (control tokens filtered) -> join chunk texts.

The log-mel always runs on the host here: the port has no device mel
yet (ROADMAP queue 1, item 10c).  Models come from a parameter tree
(``VoxtralModel``), a SafeTensors model directory
(:meth:`TranscribePipeline.from_model_dir`, bf16 / f32 / w8) or a Q4_0
GGUF file (:meth:`TranscribePipeline.from_gguf`, q4 / q4g / w8); the
converted trees of the w8 and GGUF loads may be cached on disk
(``params_cache``, the JAX package's format).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np

from voxtral_tpu_torch.audio import (
    AudioBuffer,
    ChunkConfig,
    MelSpectrogram,
    PadConfig,
    chunk_audio,
    load_wav,
    pad_audio,
    resample_to_16k,
)
from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.device import DeviceLike, resolve_device
from voxtral_tpu_torch.models.voxtral import PREFIX_LEN, VoxtralModel
from voxtral_tpu_torch.tokenizer import VoxtralTokenizer

log = logging.getLogger("voxtral_tpu_torch")

SAMPLES_PER_POSITION = 2560  # one decoder position = 2560 samples (160 ms)


@dataclasses.dataclass(frozen=True)
class MergeCost:
    """Cost model for padding unequal chunks into one decode batch:
    a step at batch B costs ``c0_ms + c1_ms * B``, and every padded
    position the encoder sees costs ``enc_per_pos_ms``."""

    c0_ms: float
    c1_ms: float
    enc_per_pos_ms: float


@dataclasses.dataclass
class PipelineConfig:
    delay_tokens: float = 6.0
    # Chunk cap in mel frames (3000 = 30 s of audio per chunk).
    max_mel_frames: int = 3000
    # Decoder-length bucket granularity (pads only a file's final chunk).
    bucket_positions: int = 8
    peak_normalize: Optional[float] = 0.95
    # None: unequal-length chunks are never merged into one batch.  The
    # JAX pipeline's constants were measured on a TPU; none has been
    # measured on the card yet.
    merge_cost: Optional[MergeCost] = None
    # Speculative K-token decode (greedy, K >= 2): each decode pass
    # verifies K drafted tokens per chunk row in one weight pass, with
    # the same tokens as sequential decode; draft "ngram" or "pad".
    speculative: int = 0
    draft: str = "ngram"


class TranscribePipeline:
    """File transcription over a :class:`VoxtralModel`."""

    def __init__(self, model: VoxtralModel, tokenizer: VoxtralTokenizer,
                 pipeline_config: Optional[PipelineConfig] = None):
        self.model = model
        self.tokenizer = tokenizer
        self.pcfg = pipeline_config or PipelineConfig()
        self.mel = MelSpectrogram.voxtral()
        self.pad_config = PadConfig.voxtral()
        self.chunk_config = ChunkConfig.voxtral().with_max_frames(
            self.pcfg.max_mel_frames)

    @classmethod
    def from_model_dir(
        cls,
        model_dir,
        dtype: str = "bfloat16",
        pipeline_config: Optional[PipelineConfig] = None,
        params_cache=None,
        device: DeviceLike = None,
    ) -> "TranscribePipeline":
        """SafeTensors path (JAX ``TranscribePipeline.from_model_dir``): a
        directory with consolidated.safetensors, params.json and
        tekken.json (``hub.ModelPaths.from_dir``).  ``dtype``: "bfloat16"
        or "float32" (the dense tree, read straight to the device), or
        "w8" (requantized to rowwise int8 at load, on the host).
        ``params_cache``: a directory caching the w8 tree, so a warm
        start skips the requantization; dense dtypes bypass it, as in
        JAX.  ``device``: ``None`` is the card."""
        from voxtral_tpu_torch.hub import ModelPaths
        from voxtral_tpu_torch.loaders.safetensors_loader import (
            load_voxtral_params,
        )

        if dtype not in ("bfloat16", "float32", "w8"):
            raise ValueError(
                f"dtype must be bfloat16, float32 or w8, got {dtype!r}")
        device = resolve_device(device)
        paths = ModelPaths.from_dir(model_dir)
        cfg = VoxtralConfig.from_file(paths.params)
        t0 = time.time()
        if dtype == "w8":
            from voxtral_tpu_torch.convert import params_from_numpy
            from voxtral_tpu_torch.utils.quantize import quantize_params_w8

            def build():
                return quantize_params_w8(load_voxtral_params(
                    paths.weights, cfg, "float32", to_device=False))

            if params_cache:
                from voxtral_tpu_torch.loaders.param_cache import (
                    load_or_build,
                )

                params = load_or_build(params_cache, paths.weights, "w8",
                                       build, device)
            else:
                params = params_from_numpy(build(), device)
        else:
            params = load_voxtral_params(paths.weights, cfg, dtype,
                                         device=device)
        log.info("loaded safetensors weights (%s) in %.1fs on %s", dtype,
                 time.time() - t0, device)
        return cls(VoxtralModel(params, cfg, device),
                   VoxtralTokenizer.from_file(paths.tekken), pipeline_config)

    @classmethod
    def from_gguf(
        cls,
        gguf_path,
        tokenizer_path,
        pipeline_config: Optional[PipelineConfig] = None,
        config: Optional[VoxtralConfig] = None,
        weight_format: str = "q4",
        device: DeviceLike = None,
        params_cache=None,
    ) -> "TranscribePipeline":
        """Q4_0 GGUF path (JAX ``TranscribePipeline.from_gguf``).

        Architecture config: explicit ``config`` > a ``params.json`` next
        to the GGUF file > production defaults.  ``weight_format``: "q4"
        (packed, per-op decode on K3), "q4g" (exact Q4_0, K1 mode (h)) or
        "w8" (requantized at load).  ``params_cache``: a directory caching
        the repacked / requantized tree, so a warm start skips the
        conversion.  ``device``: ``None`` is the card.
        """
        from voxtral_tpu_torch.loaders.gguf_loader import Q4ModelLoader

        device = resolve_device(device)
        gguf_path = Path(gguf_path)
        if config is None:
            sidecar = gguf_path.parent / "params.json"
            if sidecar.exists():
                config = VoxtralConfig.from_file(sidecar)
                log.info("using architecture config from %s", sidecar)
        t0 = time.time()
        if params_cache:
            from voxtral_tpu_torch.loaders.param_cache import load_or_build

            loader = [None]

            def build():
                loader[0] = Q4ModelLoader.from_file(
                    gguf_path, cfg=config, weight_format=weight_format)
                return loader[0].load_numpy()

            params = load_or_build(params_cache, gguf_path, weight_format,
                                   build, device)
            cfg = loader[0].cfg if loader[0] else (
                config or VoxtralConfig.voxtral())
            model = VoxtralModel(params, cfg, device)
        else:
            loader = Q4ModelLoader.from_file(gguf_path, cfg=config,
                                             weight_format=weight_format)
            model = VoxtralModel(loader.load(device), loader.cfg, device)
        log.info("loaded GGUF Q4 weights (%s) in %.1fs on %s", weight_format,
                 time.time() - t0, device)
        return cls(model, VoxtralTokenizer.from_file(tokenizer_path),
                   pipeline_config)

    def transcribe_samples(self, samples: np.ndarray,
                           sample_rate: int = 16000) -> str:
        """Transcribe a mono float32 sample buffer."""
        texts = []
        for toks in self._chunk_tokens(samples, sample_rate):
            text = self.decode_tokens(toks).strip()
            if text:
                texts.append(text)
        return " ".join(texts)

    def transcribe_file(self, path) -> str:
        audio = load_wav(path)
        return self.transcribe_samples(audio.samples, audio.sample_rate)

    def padded_chunks(self, samples: np.ndarray,
                      sample_rate: int) -> list[AudioBuffer]:
        """The 16 kHz chunks of a sample buffer, each padded and bucketed
        as the model receives it (before any merge into one batch)."""
        audio = AudioBuffer(np.asarray(samples, dtype=np.float32), sample_rate)
        if audio.sample_rate != 16000:
            audio = resample_to_16k(audio)
        if self.pcfg.peak_normalize is not None:
            audio.peak_normalize(self.pcfg.peak_normalize)

        chunks = chunk_audio(audio.samples, self.chunk_config)
        if len(chunks) > 1:
            log.info("audio exceeds %d mel frames; %d chunks",
                     self.chunk_config.max_mel_frames, len(chunks))
        return [pad_audio_bucketed(AudioBuffer(ch.samples, 16000),
                                   self.pad_config, self.pcfg.bucket_positions)
                for ch in chunks]

    def _chunk_tokens(self, samples: np.ndarray,
                      sample_rate: int) -> list[np.ndarray]:
        """Per-chunk token arrays for a sample buffer."""
        padded = self.padded_chunks(samples, sample_rate)
        # True decode-token count per chunk (decode is causal: a chunk
        # padded with silence to join a longer batch keeps its tokens at
        # its real positions — trim after).
        tok_counts = [
            self.model.decoder_seq_len(self.mel.num_frames(len(p.samples)))
            - PREFIX_LEN
            for p in padded
        ]
        groups: dict[int, list[int]] = {}
        for idx, p in enumerate(padded):
            groups.setdefault(len(p.samples), []).append(idx)
        if len(groups) > 1 and self._merge_wins(groups, tok_counts):
            target = max(len(p.samples) for p in padded)
            padded = [AudioBuffer(np.pad(p.samples,
                                         (0, target - len(p.samples))), 16000)
                      for p in padded]
            groups = {target: list(range(len(padded)))}

        chunk_tokens: list[np.ndarray] = [np.zeros(0, np.int32)] * len(padded)
        for idxs in groups.values():
            mels = np.concatenate(
                [self.mel.compute_log_batch(padded[i].samples) for i in idxs],
                axis=0)
            batch_tokens = self.model.transcribe_streaming_batch(
                mels, delay_tokens=self.pcfg.delay_tokens,
                speculative=self.pcfg.speculative, draft=self.pcfg.draft)
            for i, toks in zip(idxs, batch_tokens):
                chunk_tokens[i] = toks[:tok_counts[i]]
        return chunk_tokens

    def _merge_wins(self, groups: dict[int, list[int]],
                    tok_counts: list[int]) -> bool:
        cost = self.pcfg.merge_cost
        if cost is None:
            return False

        def step_cost(b: int) -> float:
            return cost.c0_ms + cost.c1_ms * b

        grouped = sum(max(tok_counts[i] for i in idxs) * step_cost(len(idxs))
                      for idxs in groups.values())
        extra = sum(max(tok_counts) - tc for tc in tok_counts)
        merged = (max(tok_counts) * step_cost(len(tok_counts))
                  + cost.enc_per_pos_ms * extra)
        return merged < grouped

    def decode_tokens(self, tokens: np.ndarray) -> str:
        """Filter control tokens (< 1000) and decode."""
        return self.tokenizer.decode([int(t) for t in tokens if t >= 1000])


def pad_audio_bucketed(audio: AudioBuffer, pad_config: PadConfig,
                       bucket_positions: int) -> AudioBuffer:
    """Reference padding (76 left / align + 17 right), then extend with
    silence to the next decoder-length bucket."""
    padded = pad_audio(audio, pad_config)
    if bucket_positions <= 1:
        return padded
    bucket_samples = bucket_positions * SAMPLES_PER_POSITION
    n = len(padded.samples)
    target = -(-n // bucket_samples) * bucket_samples
    if target > n:
        padded.samples = np.concatenate(
            [padded.samples, np.zeros(target - n, dtype=np.float32)])
    return padded
