"""One-shot transcription pipeline: samples -> text
(port of ``voxtral_tpu/pipeline.py``).

resample to 16 kHz -> peak_normalize(0.95) -> chunk (<= max_mel_frames)
-> pad (76 left / align + 17 right, bucketed) -> host numpy log-mel ->
model transcribe (chunks of one padded length decode as one batch; under
``merge_cost`` unequal chunks are padded into one batch when that is
cheaper) -> decode tokens (control tokens filtered) -> join chunk texts.
Beside it: word timestamps (:meth:`TranscribePipeline.
transcribe_samples_words`) and several buffers or files decoded as
batches (:meth:`TranscribePipeline.transcribe_samples_batched`), the
batched one-shot path serving stands on.

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
from voxtral_tpu_torch.utils.profiling import span

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


# Measured on the card by chip_smoke.py (phase 12, "batched one-shot
# (w8)"): c0 / c1 the linear fit of the one-shot decode loop's wall ms
# per position at B = 1, 2, 4, 8 rows of full-width w8 (the K1 route, the
# 16 s chirp: 2.907, 2.963, 3.097, 3.688 ms), enc_per_pos_ms the host mel
# + encoder + adapter of that chirp per decoder position.  NVIDIA H100
# 80GB HBM3, 700.00 W.  Each run of the script prints its own beside it.
DEFAULT_MERGE_COST = MergeCost(c0_ms=2.7376, c1_ms=0.1137,
                               enc_per_pos_ms=0.7503)


@dataclasses.dataclass
class PipelineConfig:
    delay_tokens: float = 6.0
    # Chunk cap in mel frames (3000 = 30 s of audio per chunk).
    max_mel_frames: int = 3000
    # Decoder-length bucket granularity (pads only a file's final chunk).
    bucket_positions: int = 8
    peak_normalize: Optional[float] = 0.95
    # The cost model that decides whether unequal chunks of one buffer
    # are padded into one decode batch (None: never).
    merge_cost: Optional[MergeCost] = DEFAULT_MERGE_COST
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
        mesh=None,
    ) -> "TranscribePipeline":
        """SafeTensors path (JAX ``TranscribePipeline.from_model_dir``): a
        directory with consolidated.safetensors, params.json and
        tekken.json (``hub.ModelPaths.from_dir``).  ``dtype``: "bfloat16"
        or "float32" (the dense tree, read straight to the device), or
        "w8" (requantized to rowwise int8 at load, on the host).
        ``params_cache``: a directory caching the w8 tree, so a warm
        start skips the requantization; dense dtypes bypass it, as in
        JAX.  ``device``: ``None`` is the card (the mesh's first device
        with ``mesh``, a ``parallel.make_mesh`` grid: the model decodes
        tensor- / data-parallel, ``VoxtralModel``'s ``mesh``)."""
        from voxtral_tpu_torch.hub import ModelPaths
        from voxtral_tpu_torch.loaders.safetensors_loader import (
            load_voxtral_params,
        )

        if dtype not in ("bfloat16", "float32", "w8"):
            raise ValueError(
                f"dtype must be bfloat16, float32 or w8, got {dtype!r}")
        device = _model_device(device, mesh)
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
        return cls(VoxtralModel(params, cfg, device, mesh=mesh),
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
        mesh=None,
    ) -> "TranscribePipeline":
        """Q4_0 GGUF path (JAX ``TranscribePipeline.from_gguf``).

        Architecture config: explicit ``config`` > a ``params.json`` next
        to the GGUF file > production defaults.  ``weight_format``: "q4"
        (packed, per-op decode on K3), "q4g" (exact Q4_0, K1 mode (h)) or
        "w8" (requantized at load).  ``params_cache``: a directory caching
        the repacked / requantized tree, so a warm start skips the
        conversion.  ``device``: ``None`` is the card.  ``mesh``: as in
        :meth:`from_model_dir` (w8 and q4g: a meshed packed-q4 model
        raises, and so does a q4g model outside the g32 halves' gate,
        ``ops.decode_tp.check_tp_q4g``).
        """
        from voxtral_tpu_torch.loaders.gguf_loader import Q4ModelLoader

        device = _model_device(device, mesh)
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
            model = VoxtralModel(params, cfg, device, mesh=mesh)
        else:
            loader = Q4ModelLoader.from_file(gguf_path, cfg=config,
                                             weight_format=weight_format)
            model = VoxtralModel(loader.load(device), loader.cfg, device,
                                 mesh=mesh)
        log.info("loaded GGUF Q4 weights (%s) in %.1fs on %s", weight_format,
                 time.time() - t0, device)
        return cls(model, VoxtralTokenizer.from_file(tokenizer_path),
                   pipeline_config)

    def transcribe_samples(self, samples: np.ndarray,
                           sample_rate: int = 16000) -> str:
        """Transcribe a mono float32 sample buffer."""
        chunk_tokens = self._chunk_tokens(samples, sample_rate)
        with span("decode_tokens", chunks=len(chunk_tokens)):
            return self._text(chunk_tokens)

    def transcribe_file(self, path) -> str:
        audio = load_wav(path)
        return self.transcribe_samples(audio.samples, audio.sample_rate)

    def transcribe_samples_words(self, samples: np.ndarray,
                                 sample_rate: int = 16000) -> dict:
        """Transcribe with word-level timestamps -> ``{"text": str,
        "words": [{"word", "start", "end"}]}``, times in seconds of the
        original audio: each word starts at its [STREAMING_WORD] marker's
        position (160 ms each) less the decode delay, plus its chunk's
        start (``VoxtralTokenizer.decode_words``)."""
        chunks, padded = self._chunks(samples, sample_rate)
        delay_s = self.pcfg.delay_tokens * 0.08
        chunk_tokens = self._tokens_of(padded)
        words: list[dict] = []
        for ch, toks in zip(chunks, chunk_tokens):
            words.extend(self.tokenizer.decode_words(
                toks, delay_s=delay_s, offset_s=ch.start_time(16000)))
        return {"text": self._text(chunk_tokens), "words": words}

    def transcribe_file_words(self, path) -> dict:
        audio = load_wav(path)
        return self.transcribe_samples_words(audio.samples, audio.sample_rate)

    def transcribe_files_batched(self, paths: list,
                                 batch_size: int = 8) -> list[str]:
        """Several files -> their texts, decoded in batches (the file
        front of :meth:`transcribe_samples_batched`)."""
        audios = [load_wav(p) for p in paths]
        return self.transcribe_samples_batched(
            [(a.samples, a.sample_rate) for a in audios],
            batch_size=batch_size)

    def transcribe_samples_batched(self, buffers: list,
                                   batch_size: int = 8) -> list[str]:
        """Several sample buffers (``(samples, sample_rate)`` each) ->
        their texts.  Buffers of one padded length decode as one batch of
        at most ``batch_size`` rows: a decode step streams the same
        weights whatever its row count, so rows from different requests
        share it.  Every batch is dispatched before any is fetched.  A
        buffer longer than one chunk goes through
        :meth:`transcribe_samples`."""
        return [self._text(toks)
                for toks in self.batched_chunk_tokens(buffers, batch_size)]

    def batched_chunk_tokens(self, buffers: list,
                             batch_size: int = 8) -> list[list[np.ndarray]]:
        """The tokens behind :meth:`transcribe_samples_batched`: per
        buffer, its chunks' token arrays."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        results: list[list[np.ndarray]] = [[] for _ in buffers]
        padded: dict[int, AudioBuffer] = {}
        for i, (samples, rate) in enumerate(buffers):
            audio = self._audio_16k(samples, rate)
            chunks = chunk_audio(audio.samples, self.chunk_config)
            if len(chunks) > 1:
                results[i] = self._chunk_tokens(audio.samples, 16000)
                continue
            padded[i] = self._pad(chunks[0].samples)
        groups: dict[int, list[int]] = {}
        for i, buf in padded.items():
            groups.setdefault(len(buf.samples), []).append(i)
        pending = [(part, self._dispatch_batch(
                        [padded[i].samples for i in part]))
                   for idxs in groups.values()
                   for part in (idxs[lo:lo + batch_size]
                                for lo in range(0, len(idxs), batch_size))]
        with span("transcribe_fetch", groups=len(pending)):
            for idxs, dev_tokens in pending:
                for i, toks in zip(idxs, _fetch(dev_tokens)):
                    results[i] = [toks[:self._token_count(padded[i])]]
        return results

    def _chunks(self, samples: np.ndarray, sample_rate: int):
        """(chunks, padded): the 16 kHz chunks of a sample buffer
        (``audio.chunk_audio``) and each padded and bucketed as the model
        receives it (before any merge into one batch)."""
        chunks = chunk_audio(self._audio_16k(samples, sample_rate).samples,
                             self.chunk_config)
        if len(chunks) > 1:
            log.info("audio exceeds %d mel frames; %d chunks",
                     self.chunk_config.max_mel_frames, len(chunks))
        return chunks, [self._pad(ch.samples) for ch in chunks]

    def _audio_16k(self, samples: np.ndarray, sample_rate: int) -> AudioBuffer:
        """A sample buffer resampled to 16 kHz and peak-normalized."""
        audio = AudioBuffer(np.asarray(samples, dtype=np.float32), sample_rate)
        if audio.sample_rate != 16000:
            audio = resample_to_16k(audio)
        if self.pcfg.peak_normalize is not None:
            audio.peak_normalize(self.pcfg.peak_normalize)
        return audio

    def _pad(self, chunk: np.ndarray) -> AudioBuffer:
        """One 16 kHz chunk padded and bucketed as the model receives it."""
        return pad_audio_bucketed(AudioBuffer(chunk, 16000), self.pad_config,
                                  self.pcfg.bucket_positions)

    def padded_chunks(self, samples: np.ndarray,
                      sample_rate: int) -> list[AudioBuffer]:
        """The 16 kHz chunks of a sample buffer, each padded and bucketed
        as the model receives it (before any merge into one batch)."""
        return self._chunks(samples, sample_rate)[1]

    def _token_count(self, padded: AudioBuffer) -> int:
        """Decode tokens of a padded chunk: its own positions, whatever
        longer batch it joins (decode is causal, so a chunk padded with
        silence keeps its tokens at its real positions: trim after)."""
        return (self.model.decoder_seq_len(
            self.mel.num_frames(len(padded.samples))) - PREFIX_LEN)

    def _chunk_tokens(self, samples: np.ndarray,
                      sample_rate: int) -> list[np.ndarray]:
        """Per-chunk token arrays for a sample buffer."""
        return self._tokens_of(self.padded_chunks(samples, sample_rate))

    def _tokens_of(self, padded: list[AudioBuffer]) -> list[np.ndarray]:
        """Per-chunk token arrays for padded chunks: chunks of one length
        decode as one batch; unequal ones are padded into one batch when
        :meth:`_merge_wins`; every batch is dispatched, then fetched."""
        tok_counts = [self._token_count(p) for p in padded]
        groups: dict[int, list[int]] = {}
        for idx, p in enumerate(padded):
            groups.setdefault(len(p.samples), []).append(idx)
        if len(groups) > 1 and self._merge_wins(groups, tok_counts):
            target = max(len(p.samples) for p in padded)
            padded = [AudioBuffer(np.pad(p.samples,
                                         (0, target - len(p.samples))), 16000)
                      for p in padded]
            groups = {target: list(range(len(padded)))}
            log.info("merged %d unequal chunks into one batch", len(padded))

        pending = [(idxs, self._dispatch_batch(
                        [padded[i].samples for i in idxs]))
                   for idxs in groups.values()]
        chunk_tokens: list[np.ndarray] = [np.zeros(0, np.int32)] * len(padded)
        with span("transcribe_fetch", groups=len(pending)):
            for idxs, dev_tokens in pending:
                for i, toks in zip(idxs, _fetch(dev_tokens)):
                    chunk_tokens[i] = toks[:tok_counts[i]]
        return chunk_tokens

    def _dispatch_batch(self, sample_rows: list[np.ndarray]):
        """Queue one batch of equal-length padded sample rows: the host
        log-mel, then the model's decode without the fetch
        (``transcribe_streaming_batch_async``)."""
        n = len(sample_rows)
        with span("mel", chunks=n, samples=len(sample_rows[0])):
            mels = np.concatenate(
                [self.mel.compute_log_batch(r) for r in sample_rows], axis=0)
        with span("transcribe_dispatch", batch=n, mel_frames=mels.shape[-1]):
            return self.model.transcribe_streaming_batch_async(
                mels, delay_tokens=self.pcfg.delay_tokens,
                speculative=self.pcfg.speculative, draft=self.pcfg.draft)

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

    def _text(self, chunk_tokens: list[np.ndarray]) -> str:
        """The chunks' texts, stripped, the empty ones dropped, joined
        with spaces."""
        texts = [self.decode_tokens(toks).strip() for toks in chunk_tokens]
        return " ".join(t for t in texts if t)


def _model_device(device: DeviceLike, mesh):
    """Where a loader puts the tree: ``device``, or the mesh's first
    device when only a mesh is given (``None`` and no mesh: the card)."""
    if device is None and mesh is not None:
        return mesh.first
    return resolve_device(device)


def _fetch(tokens) -> np.ndarray:
    """A dispatched batch's tokens on the host."""
    if isinstance(tokens, np.ndarray):
        return tokens
    return tokens.cpu().numpy()


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
