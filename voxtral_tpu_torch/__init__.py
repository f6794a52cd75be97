"""voxtral_tpu_torch — the PyTorch + CUDA port of ``voxtral_tpu``.

The JAX package ``voxtral_tpu`` stays the reference; this package mirrors
its module names so each counterpart is easy to find:

    config, tokenizer, audio/
                    — the port's own copies of the JAX package's
                      framework-free modules (numpy log-mel only)
    device          — explicit device handling (``cuda`` unless the
                      caller passes ``"cpu"``), numpy <-> torch, TF32 off
    convert         — the JAX package's numpy parameter tree -> tensors
    loaders/        — GGUF reader / writer and the Q4_0 GGUF loader
    utils/quantize  — numpy random / rowwise-int8 / Q4_0 parameter trees
    models/         — layers, encoder, adapter, decoder, full model
    ops/            — w8 and q4 helpers and the hand-written Hopper
                      kernels (csrc/*.cu, built with nvcc at first use)
    pipeline, cli   — one-shot file transcription (sequential, sampled
                      or speculative decode; random w8 or GGUF weights)
    streaming       — the live session (bounded or head+ring caches,
                      sequential or speculative, checkpoints) and the
                      pool that steps several sessions as one batch
                      (bf16 or int8 caches, resident or chunked)
    utils/hbm       — device-memory admission

It imports ``torch`` and never ``jax``, and nothing of the JAX package
``voxtral_tpu``: the framework-free modules it needs are copied here.
The names a caller needs to build a pipeline or a live session are
re-exported.
"""

__version__ = "0.1.0"

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.streaming import StreamingSession, StreamPool
from voxtral_tpu_torch.tokenizer import VoxtralTokenizer

__all__ = ["StreamPool", "StreamingSession", "VoxtralConfig",
           "VoxtralTokenizer", "__version__"]
