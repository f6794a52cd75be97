"""Prometheus-format metrics registry for the serving layer (stdlib-only;
a copy of ``voxtral_tpu/serving/metrics.py``).

The reference's observability is structured ``tracing::info!`` logs with
elapsed_ms fields (reference transcribe.rs:151-179, e2e_bench.rs:62-95);
a served deployment wants the same signals as a scrapeable ``/metrics``
surface instead: request/token counters, live session gauges, and
latency histograms for the pooled decode step and the batch transcribe
path.  The metric names, types and label sets are the JAX server's.

Thread-safe; rendering follows the Prometheus text exposition format
(counters ``_total``, histograms with cumulative ``_bucket`` series plus
``_sum``/``_count``).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Optional

# Seconds-scale buckets spanning a pooled streaming step (~0.1 s) to a
# long batch transcribe (~10 s).
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _labels_str(key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Metrics:
    """Counter / gauge / histogram registry with Prometheus rendering."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, dict[tuple, float]] = defaultdict(
            lambda: defaultdict(float))
        self._gauges: dict[str, dict[tuple, float]] = defaultdict(dict)
        self._hists: dict[str, dict[tuple, dict]] = defaultdict(dict)
        self._help: dict[str, tuple[str, str]] = {}  # name -> (type, help)

    def describe(self, name: str, typ: str, help_text: str) -> None:
        self._help[name] = (typ, help_text)

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._counters[name][_labels_key(labels)] += value

    def set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[name][_labels_key(labels)] = value

    def observe(self, name: str, value: float,
                buckets: tuple = DEFAULT_BUCKETS, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            h = self._hists[name].get(key)
            if h is None:
                h = {"buckets": buckets,
                     "counts": [0] * (len(buckets) + 1),
                     "sum": 0.0, "count": 0}
                self._hists[name][key] = h
            for i, b in enumerate(h["buckets"]):
                if value <= b:
                    h["counts"][i] += 1
            h["counts"][-1] += 1  # +Inf
            h["sum"] += value
            h["count"] += 1

    def render(self) -> str:
        """Prometheus text exposition of every registered series."""
        out: list[str] = []

        def header(name: str, default_type: str) -> None:
            typ, help_text = self._help.get(name, (default_type, ""))
            if help_text:
                out.append(f"# HELP {name} {help_text}")
            out.append(f"# TYPE {name} {typ}")

        with self._lock:
            for name in sorted(self._counters):
                header(name, "counter")
                for key, val in sorted(self._counters[name].items()):
                    out.append(f"{name}{_labels_str(key)} {_fmt(val)}")
            for name in sorted(self._gauges):
                header(name, "gauge")
                for key, val in sorted(self._gauges[name].items()):
                    out.append(f"{name}{_labels_str(key)} {_fmt(val)}")
            for name in sorted(self._hists):
                header(name, "histogram")
                for key, h in sorted(self._hists[name].items()):
                    cum = 0
                    for i, b in enumerate(h["buckets"]):
                        cum = h["counts"][i]
                        out.append(
                            f"{name}_bucket"
                            f"{_labels_str(key, f'le=\"{_fmt(b)}\"')} {cum}")
                    out.append(
                        f"{name}_bucket"
                        f"{_labels_str(key, 'le=\"+Inf\"')} "
                        f"{h['counts'][-1]}")
                    out.append(f"{name}_sum{_labels_str(key)} "
                               f"{_fmt(h['sum'])}")
                    out.append(f"{name}_count{_labels_str(key)} "
                               f"{h['count']}")
        return "\n".join(out) + "\n"


def _fmt(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(float(v))


_timer_local = threading.local()


class Timer:
    """``with metrics.time("x"):`` convenience observer."""

    def __init__(self, metrics: Metrics, name: str,
                 labels: Optional[dict] = None):
        self.metrics = metrics
        self.name = name
        self.labels = labels or {}

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self.metrics.observe(self.name, time.perf_counter() - self._t0,
                             **self.labels)
        return False
