"""Profiling hooks (port of ``voxtral_tpu/utils/profiling.py``; parity
with the reference's tracing-chrome sink, ``src/profiling.rs``).

Two sinks, like the reference:
* stage-level spans -> structured logs (the ``tracing_subscriber::fmt``
  analogue; always available via :func:`span`, the JAX package's log
  line under the logger ``voxtral_tpu_torch.profiling``);
* :func:`trace` -> a Chrome trace (``chrome://tracing`` or Perfetto)
  from ``torch.profiler`` with the CPU and, where there is a card, the
  CUDA activities; :func:`annotate` names a region in it and, on a card,
  an NVTX range.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Iterator, Optional

log = logging.getLogger("voxtral_tpu_torch.profiling")


@contextlib.contextmanager
def span(name: str, **fields) -> Iterator[None]:
    """Log a timed span: encode_audio / transcribe_streaming / mel etc.

    Mirrors the reference's tracing spans on the hot path
    (gguf/model.rs:784,878,909,936).  Host time: work queued on the card
    inside the span is counted only as far as the span waits for it.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed_ms = (time.perf_counter() - t0) * 1000
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        log.info("span %s elapsed_ms=%.1f %s", name, elapsed_ms, extra)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[str]:
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace to ``logdir/trace.json`` (default: ``voxtral_trace`` in the
    temporary directory).  Yields ``logdir``."""
    import torch

    logdir = logdir or os.path.join(tempfile.gettempdir(), "voxtral_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a :func:`trace` (``record_function``) and, on
    a card, an NVTX range."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
