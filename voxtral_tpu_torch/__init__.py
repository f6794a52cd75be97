"""voxtral_tpu_torch — the PyTorch + CUDA port of ``voxtral_tpu``.

The JAX package ``voxtral_tpu`` stays the reference; this package mirrors
its module names so each counterpart is easy to find:

    device          — explicit device handling, numpy <-> torch, TF32 off
    convert         — the JAX package's numpy parameter tree -> tensors
    utils/quantize  — numpy random / rowwise-int8 parameter builders
    models/         — layers, encoder, adapter, decoder, full model
    ops/            — w8 helpers and the hand-written Hopper kernels
                      (csrc/*.cu, built with nvcc at first use)
    pipeline, cli   — one-shot file transcription (sequential, sampled
                      or speculative decode)

It imports ``torch`` and never ``jax``.  Three framework-free modules of
the JAX package are reused as they are: ``voxtral_tpu.config``,
``voxtral_tpu.audio`` and ``voxtral_tpu.tokenizer``; the two names a
caller needs from them to build a pipeline are re-exported here.
"""

__version__ = "0.1.0"

from voxtral_tpu.config import VoxtralConfig
from voxtral_tpu.tokenizer import VoxtralTokenizer

__all__ = ["VoxtralConfig", "VoxtralTokenizer", "__version__"]
