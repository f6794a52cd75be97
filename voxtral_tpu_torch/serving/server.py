"""HTTP transcription server (stdlib-only; port of
``voxtral_tpu/serving/server.py``).

Endpoints (worker-protocol shape mirroring ``web/worker.js:15-38``):

    GET  /healthz                    -> {"status": "ok", "backend": the
                                        model's torch device type, ...}
    GET  /metrics                    -> Prometheus text (counters/gauges/
                                        latency histograms, serving/metrics.py)
    GET  /                           -> browser mic demo (static HTML)
    POST /transcribe                 -> body: WAV file bytes; resp {text, ...}
    POST /transcribe_pcm?rate=16000  -> body: raw little-endian f32 mono PCM
    POST /stream/start               -> {"session": id}
    POST /stream/<id>/feed           -> raw f32 PCM; resp {"delta": new text}
    POST /stream/<id>/finish         -> {"delta", "text", "tokens"}
    POST /v1/audio/transcriptions    -> OpenAI-compatible (multipart WAV
                                        upload; response_format json |
                                        text | verbose_json with word
                                        timings; stream=true -> SSE
                                        transcript.text.delta/.done
                                        events; OpenAI-shaped errors)
    GET  /v1/models                  -> OpenAI-compatible model listing

The routes, replies, metrics and error shapes are the JAX server's.
Model access is serialized with one lock: every handler thread and the
pool's pump thread run model work only under it, so one thread at a time
launches on the card.  The kernel wrappers launch on PyTorch's current
stream, which is per thread; no thread here sets one, so every thread
launches on the card's default stream, in lock order.  ``prewarm``
builds the kernel library (one ``nvcc`` per source) and runs each
serving path once before the server takes traffic.  A solo session is
admitted only when its caches fit beside those the server already holds
(the pool's and the other solo sessions'): :func:`_new_session` raises
:class:`~voxtral_tpu_torch.utils.hbm.HBMBudgetError`, which the routes
answer with 503.  The reference's chunk-size panic hint
(transcribe.rs:327-349) maps to clean HTTP 4xx/5xx JSON errors.  Audio
decoding is WAV-only; greedy decode means ``temperature`` is accepted
for wire compatibility but ignored.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np

from voxtral_tpu_torch.pipeline import TranscribePipeline
from voxtral_tpu_torch.serving.metrics import Metrics, Timer

log = logging.getLogger("voxtral_tpu_torch.serving")

_STATIC_DIR = Path(__file__).parent / "static"

# Advertised under GET /v1/models and echoed by /v1/audio/transcriptions.
OPENAI_MODEL_ID = "voxtral-mini-realtime"


def parse_multipart(content_type: str, body: bytes) -> dict:
    """Parse a multipart/form-data body into {field: (filename, bytes)}.

    Stdlib-only (``email.parser`` — the supported replacement for the
    removed ``cgi`` module): the request body is re-framed as a MIME
    document by prepending the Content-Type header, then walked part by
    part.  Raises ``ValueError`` on anything that isn't well-formed
    multipart (callers map that to HTTP 400)."""
    if "multipart/form-data" not in content_type:
        raise ValueError("Content-Type must be multipart/form-data")
    from email.parser import BytesParser
    from email.policy import HTTP

    head = (f"Content-Type: {content_type}\r\n"
            "MIME-Version: 1.0\r\n\r\n").encode()
    msg = BytesParser(policy=HTTP).parsebytes(head + body)
    if not msg.is_multipart():
        raise ValueError("body is not multipart (missing/odd boundary?)")
    parts: dict = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True)
        parts[name] = (part.get_filename(), payload or b"")
    return parts


class _State:
    # Abandoned streaming sessions hold preallocated device KV caches;
    # evict on idle TTL and cap concurrency so they can't exhaust HBM.
    SESSION_TTL_S = 300.0
    MAX_SESSIONS = 16
    COALESCE_S = 0.02  # batching window for concurrent /stream feeds

    def __init__(self, pipeline: TranscribePipeline, step_positions: int = 8,
                 pool_streams: int = 0, pool_unbounded: bool = False,
                 pool_kv: str = "auto", state_dir: Optional[str] = None,
                 speculative: int = 0, draft: str = "pad"):
        self.pipeline = pipeline
        self.step_positions = step_positions
        self.speculative = speculative
        self.draft = draft
        self.state_dir = Path(state_dir) if state_dir else None
        self.lock = threading.Lock()
        self.sessions: dict[str, object] = {}
        self.last_access: dict[str, float] = {}

        # Scrapeable observability (the reference's tracing::info! fields
        # as a Prometheus surface): request/token counters, session
        # gauges, pump/transcribe latency histograms.
        self.metrics = Metrics()
        m = self.metrics
        m.describe("voxtral_requests_total", "counter",
                   "HTTP requests by endpoint and status class")
        m.describe("voxtral_audio_seconds_total", "counter",
                   "audio seconds accepted by path (stream/batch)")
        m.describe("voxtral_tokens_total", "counter",
                   "decoded tokens emitted to clients")
        m.describe("voxtral_sessions_started_total", "counter",
                   "streaming sessions opened")
        m.describe("voxtral_sessions_closed_total", "counter",
                   "streaming sessions closed, by reason")
        m.describe("voxtral_stream_overruns_total", "counter",
                   "pooled bounded sessions that hit max duration")
        m.describe("voxtral_sessions_restored_total", "counter",
                   "drained sessions resumed from state_dir at startup")
        m.describe("voxtral_pump_seconds", "histogram",
                   "coalesced pool pump duration (one batched decode)")
        m.describe("voxtral_transcribe_seconds", "histogram",
                   "batch transcribe wall time")
        m.describe("voxtral_sessions_active", "gauge",
                   "currently open streaming sessions")
        m.describe("voxtral_pool_free_slots", "gauge",
                   "free StreamPool slots (absent if pooling is off)")
        m.describe("voxtral_transcribe_coalesced_total", "counter",
                   "whole-file requests served by a shared batched decode")
        m.describe("voxtral_spec_passes_total", "gauge",
                   "speculative verification passes (device-accumulated)")
        m.describe("voxtral_spec_accepted_rows_total", "gauge",
                   "verify rows accepted across speculative passes")
        m.describe("voxtral_spec_tokens_per_pass", "gauge",
                   "accepted rows / passes (K = upper bound per slot)")

        self.prewarm_report: Optional[dict] = None
        # Optional StreamPool: concurrent sessions share one BATCHED decode
        # step (HBM-bound weights are streamed once for all of them).  A
        # dedicated pump thread coalesces feeds arriving within COALESCE_S.
        self.pool = None
        self._pump_cv = threading.Condition()
        self._feed_pending = False
        self._closed = False
        self._pump_seq = 0
        # Whole-file /transcribe coalescing: concurrent POSTs elect a
        # leader that waits COALESCE_S, then runs ONE batched decode for
        # the whole group (transcribe_samples_batched — an extra batch
        # row costs ~0.07 ms/step vs the full weight stream per file).
        self._batch_cv = threading.Condition()
        self._batch_queue: list[dict] = []
        self._batch_leader = False
        if pool_streams > 0:
            from voxtral_tpu_torch.streaming import StreamPool

            self.pool = StreamPool(
                pipeline.model, max_streams=pool_streams,
                step_positions=step_positions,
                delay_tokens=pipeline.pcfg.delay_tokens,
                unbounded=pool_unbounded,
                kv_dtype=pool_kv,
                speculative=speculative,
                draft=draft,
            )
            threading.Thread(target=self._pump_loop, daemon=True).start()
        self._restore_drained()

    def prewarm(self) -> dict:
        """Run the serving paths once BEFORE taking traffic.

        On a card the first call builds the kernel library (one ``nvcc``
        per source, about a minute) and every path allocates its
        workspace; a request that met either would wait for it, or fail
        mid-request where the workspace does not fit beside everything
        already resident.  Warming at boot turns both into a
        startup-time, operator-visible event.  Covers: the build, the
        full-chunk whole-file path (what every non-final chunk of a long
        upload uses), one short final-chunk bucket, and a streaming
        session step + finish-flush.  The report keeps the JAX server's
        three keys; the build's seconds are logged.
        """
        if self.pipeline.model.device.type == "cuda":
            from voxtral_tpu_torch.ops import _build

            t0 = time.time()
            _build.library()
            log.info("kernel library ready in %.1f s", time.time() - t0)
        report = {}
        frames = self.pipeline.pcfg.max_mel_frames
        t0 = time.time()
        # 1 mel frame = 10 ms hop; +1600 samples so padding can't round
        # the chunk count down below a full chunk.
        full = np.zeros(frames * 160 + 1600, np.float32)
        with self.lock:
            self.pipeline.transcribe_samples(full, 16000)
        report["full_chunk_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        with self.lock:
            self.pipeline.transcribe_samples_batched(
                [(np.zeros(32000, np.float32), 16000)])
        report["short_bucket_s"] = round(time.time() - t0, 1)
        t0 = time.time()
        session = _new_session(self)
        step_samples = np.zeros(
            int(self.step_positions * 0.16 * 16000) + 2560, np.float32)
        if getattr(session, "_pool", None) is not None:
            with self.lock:
                session.feed(step_samples, pump=False)
            self.pump_and_wait()
            with self.lock:
                session._emit()
                session.finish()
        else:
            with self.lock:
                session.feed(step_samples)
                session.finish()
        report["session_s"] = round(time.time() - t0, 1)
        self.prewarm_report = report
        log.info("prewarm done: %s", report)
        return report

    def transcribe_coalesced(self, samples, rate) -> str:
        """Leader-elected request coalescing for concurrent whole-file
        POSTs: the first thread in an empty window becomes the leader,
        sleeps ``COALESCE_S`` to let concurrent uploads join, then runs
        one ``transcribe_samples_batched`` for the group under the model
        lock; followers just wait on their event.  A lone request pays
        only the window (20 ms, ~3% of a 16 s transcribe)."""
        import time as _time

        req = {"samples": samples, "rate": rate,
               "event": threading.Event(), "result": None, "error": None}
        with self._batch_cv:
            self._batch_queue.append(req)
            leader = not self._batch_leader
            if leader:
                self._batch_leader = True
        if leader:
            _time.sleep(self.COALESCE_S)
            with self._batch_cv:
                batch = self._batch_queue
                self._batch_queue = []
                self._batch_leader = False
            try:
                with self.lock, Timer(self.metrics,
                                      "voxtral_transcribe_seconds"):
                    texts = self.pipeline.transcribe_samples_batched(
                        [(r["samples"], r["rate"]) for r in batch])
                for r, t in zip(batch, texts):
                    r["result"] = t
                if len(batch) > 1:
                    self.metrics.inc("voxtral_transcribe_coalesced_total",
                                     len(batch))
            except Exception as e:
                for r in batch:
                    r["error"] = e
            finally:
                for r in batch:
                    r["event"].set()
        req["event"].wait()
        if req["error"] is not None:
            raise req["error"]
        return req["result"]

    # -- drain / restore -----------------------------------------------------

    def drain(self) -> int:
        """Snapshot every live streaming session to ``state_dir`` so a
        replacement process can resume them mid-stream (same session
        ids) — graceful shutdown without dropping live streams.
        Returns the number of sessions drained."""
        if self.state_dir is None:
            raise ValueError("drain() needs make_server(state_dir=...)")
        self.state_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        with self.lock:
            for sid, sess in list(self.sessions.items()):
                try:
                    if getattr(sess, "_finished", False):
                        continue
                    sess.save(self.state_dir / f"{sid}.npz")
                    n += 1
                    self.metrics.inc("voxtral_sessions_closed_total",
                                     reason="drained")
                except Exception:
                    log.exception("draining session %s", sid)
            self.sessions.clear()
            self.last_access.clear()
        log.info("drained %d session(s) to %s", n, self.state_dir)
        return n

    def _restore_drained(self) -> None:
        """Resume sessions a previous process drained to ``state_dir``
        (pool slots first, solo past capacity — same policy as
        ``_new_session``).  Consumed snapshots are deleted; unreadable
        ones are renamed ``.bad`` so a crash loop cannot re-poison."""
        if self.state_dir is None or not self.state_dir.is_dir():
            return
        from voxtral_tpu_torch.streaming import StreamingSession

        for f in sorted(self.state_dir.glob("*.npz")):
            sid = f.stem
            pool = self.pool
            if pool is not None and pool.free_slots == 0:
                pool = None
            try:
                try:
                    sess = StreamingSession.load(
                        self.pipeline.model, f, self.pipeline.tokenizer,
                        pool=pool,
                    )
                except ValueError:
                    if pool is None:
                        raise
                    # Checkpoint geometry doesn't fit the pool (e.g. a
                    # bounded solo overflow session drained from an
                    # unbounded-pool server) — a solo restore still
                    # resumes the stream.
                    sess = StreamingSession.load(
                        self.pipeline.model, f, self.pipeline.tokenizer,
                    )
            except Exception:
                log.exception("restoring drained session %s", sid)
                f.rename(f.with_suffix(".bad"))
                continue
            self.sessions[sid] = sess
            self.last_access[sid] = time.time()
            self.metrics.inc("voxtral_sessions_restored_total")
            f.unlink()
            log.info("restored drained session %s (%d positions)",
                     sid, sess.positions_done)

    def _pump_loop(self) -> None:
        while True:
            with self._pump_cv:
                while not (self._feed_pending or self._closed):
                    self._pump_cv.wait()
                if self._closed:
                    return
                self._feed_pending = False
            time.sleep(self.COALESCE_S)  # let concurrent feeds land
            try:
                with self.lock, Timer(self.metrics, "voxtral_pump_seconds"):
                    self.pool.pump()
            except Exception:
                log.exception("pool pump failed")
            with self._pump_cv:
                self._pump_seq += 1
                self._pump_cv.notify_all()

    def close(self) -> None:
        """Stop the pump thread (the pool and its caches are then freed
        with the state)."""
        with self._pump_cv:
            self._closed = True
            self._pump_cv.notify_all()

    def pump_and_wait(self) -> None:
        """Signal the pump thread and block until the next pump completes."""
        with self._pump_cv:
            seq = self._pump_seq
            self._feed_pending = True
            self._pump_cv.notify_all()
            while self._pump_seq == seq:
                self._pump_cv.wait(timeout=5.0)

    def evict_idle(self) -> None:
        now = time.time()
        for sid, ts in list(self.last_access.items()):
            if now - ts > self.SESSION_TTL_S:
                session = self.sessions.pop(sid, None)
                self.last_access.pop(sid, None)
                if session is not None and getattr(session, "_pool", None):
                    try:
                        session.finish()
                    except Exception:
                        log.exception("evicting pooled session %s", sid)
                self.metrics.inc("voxtral_sessions_closed_total",
                                 reason="evicted")
                log.info("evicted idle session %s", sid)


def _new_session(state: _State):
    from voxtral_tpu_torch.streaming import StreamingSession

    pool = state.pool
    if pool is not None and pool.free_slots == 0:
        pool = None  # fall back to a solo session
    if pool is None:
        _admit_solo(state)
    return StreamingSession(
        state.pipeline.model,
        state.pipeline.tokenizer,
        delay_tokens=state.pipeline.pcfg.delay_tokens,
        step_positions=state.step_positions,
        pool=pool,
        # Pooled sessions decode via the pool (which carries its own
        # speculative config); solo fallbacks get the session flag.
        speculative=(state.speculative if pool is None else 0),
        draft=state.draft,
    )


def _admit_solo(state: _State) -> None:
    """Raise HBMBudgetError unless a new solo session's caches fit beside
    the caches the server holds: the pool's and its live solo sessions'
    (a session's own admission, ``check_hbm``, counts the weights and
    its own caches alone).  On a mesh each session's own per-shard
    admission stands."""
    from voxtral_tpu_torch.streaming import solo_cache_bytes
    from voxtral_tpu_torch.utils.hbm import check_hbm

    model = state.pipeline.model
    plan = getattr(model, "parallel", None)
    if plan is not None and plan.dp * plan.tp > 1:
        return
    solo = [s for s in state.sessions.values() if s._pool is None]
    held = sum(s.cache_bytes for s in solo)
    if state.pool is not None:
        held += state.pool.cache_bytes
    check_hbm(model, held + solo_cache_bytes(model, state.step_positions),
              f"{len(solo) + 1} solo streaming sessions beside the "
              "server's other caches")


class VoxtralHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, state: _State):
        self.state = state
        super().__init__(addr, _Handler)

    def drain(self) -> int:
        """Snapshot live streaming sessions to ``state_dir`` (see
        ``make_server``); call after ``shutdown()`` on graceful exit."""
        return self.state.drain()

    def server_close(self) -> None:
        """Close the socket and stop the pool's pump thread (``drain``
        still works after it)."""
        super().server_close()
        self.state.close()


class _BodyTooLarge(Exception):
    def __init__(self, length: int):
        super().__init__(f"body too large: {length}")
        self.length = length


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # -- helpers ------------------------------------------------------------

    def _json(self, code: int, payload: dict) -> None:
        self._last_status = code
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            # close_connection alone only drops the socket after the
            # response; advertise it so clients don't reuse the pipe.
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    # Largest accepted request body (f32 PCM: ~67 min of 16 kHz audio).
    # Without a cap, one request's Content-Length allocates unbounded
    # server memory before any audio validation runs.
    MAX_BODY_BYTES = 256 * 2**20

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        if length > self.MAX_BODY_BYTES:
            raise _BodyTooLarge(length)
        return self.rfile.read(length)

    @property
    def state(self) -> _State:
        return self.server.state  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # route to logging, not stderr spam
        log.debug("%s - %s", self.address_string(), fmt % args)

    # -- GET ----------------------------------------------------------------

    def do_GET(self):
        if self.path == "/healthz":
            payload = {
                "status": "ok",
                "backend": self.state.pipeline.model.device.type,
                "sessions": len(self.state.sessions),
            }
            if self.state.prewarm_report is not None:
                payload["prewarm"] = self.state.prewarm_report
            self._json(200, payload)
        elif self.path == "/metrics":
            state = self.state
            m = state.metrics
            # Racy-but-lock-free gauge reads: taking state.lock here
            # would block scrapes behind a long transcribe — the exact
            # moment observability matters most.
            m.set("voxtral_sessions_active", len(state.sessions))
            if state.pool is not None:
                m.set("voxtral_pool_free_slots", state.pool.free_slots)
                spec = state.pool.spec_metrics()
                if spec is not None:
                    m.set("voxtral_spec_passes_total", spec["passes"])
                    m.set("voxtral_spec_accepted_rows_total",
                          spec["accepted_rows"])
                    m.set("voxtral_spec_tokens_per_pass",
                          spec["tokens_per_pass"])
            body = m.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/v1/models":
            self._json(200, {
                "object": "list",
                "data": [{
                    "id": OPENAI_MODEL_ID,
                    "object": "model",
                    "owned_by": "voxtral_tpu",
                }],
            })
        elif self.path in ("/", "/index.html"):
            page = (_STATIC_DIR / "index.html").read_bytes()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)
        else:
            self._json(404, {"error": f"not found: {self.path}"})

    # -- POST ---------------------------------------------------------------

    def do_POST(self):
        endpoint = self.path.split("?")[0]
        if endpoint.startswith("/stream/") and endpoint.count("/") == 3:
            endpoint = "/stream/<id>/" + endpoint.rsplit("/", 1)[1]
        if endpoint not in ("/transcribe", "/transcribe_pcm",
                           "/stream/start", "/stream/<id>/feed",
                           "/stream/<id>/finish",
                           "/v1/audio/transcriptions"):
            # Coalesce unknown client-supplied paths into one label —
            # per-path labels would let untrusted input grow the metric
            # series (and server memory) without bound.
            endpoint = "other"
        try:
            self._last_status = 200
            self._route_post()
            status = f"{self._last_status // 100}xx"
            self.state.metrics.inc("voxtral_requests_total",
                                   endpoint=endpoint, status=status)
        except _BodyTooLarge as e:
            self.state.metrics.inc("voxtral_requests_total",
                                   endpoint=endpoint, status="4xx")
            # The oversized body was never read: keeping the HTTP/1.1
            # connection alive would parse the in-flight body bytes as
            # request lines (protocol desync) — drop the socket.
            self.close_connection = True
            self._json(413, {
                "error": f"request body {e.length} bytes exceeds "
                f"{_Handler.MAX_BODY_BYTES} limit"
            })
        except Exception as e:  # surface as JSON, never a hung socket
            log.exception("request failed")
            self.state.metrics.inc("voxtral_requests_total",
                                   endpoint=endpoint, status="5xx")
            self._json(500, {"error": str(e)})

    def _route_post(self):
        path = self.path.split("?")[0]
        if path == "/transcribe":
            self._transcribe_wav()
        elif path == "/transcribe_pcm":
            self._transcribe_pcm()
        elif path == "/v1/audio/transcriptions":
            self._openai_transcriptions()
        elif path == "/stream/start":
            from voxtral_tpu_torch.utils.hbm import HBMBudgetError

            with self.state.lock:
                self.state.evict_idle()
                if len(self.state.sessions) >= self.state.MAX_SESSIONS:
                    self._json(429, {
                        "error": "too many active sessions "
                        f"(max {self.state.MAX_SESSIONS})"
                    })
                    return
                sid = uuid.uuid4().hex[:12]
                try:
                    self.state.sessions[sid] = _new_session(self.state)
                except HBMBudgetError as e:
                    # Admission control (utils/hbm.py): refuse cleanly
                    # instead of dying in a device OOM mid-request.
                    self.state.sessions.pop(sid, None)
                    self._json(503, {"error": str(e)})
                    return
                self.state.last_access[sid] = time.time()
            self.state.metrics.inc("voxtral_sessions_started_total")
            self._json(200, {"session": sid})
        elif path.startswith("/stream/"):
            parts = path.strip("/").split("/")
            if len(parts) != 3 or parts[2] not in ("feed", "finish"):
                self._json(404, {"error": f"bad stream endpoint: {path}"})
                return
            sid, action = parts[1], parts[2]
            if action == "feed":
                samples = np.frombuffer(self._read_body(), dtype=np.float32)
                self.state.metrics.inc("voxtral_audio_seconds_total",
                                       samples.size / 16000.0,
                                       path="stream")
                with self.state.lock:
                    session = self.state.sessions.get(sid)
                    if session is None:
                        self._json(404, {"error": f"unknown session: {sid}"})
                        return
                    self.state.last_access[sid] = time.time()
                    pooled = getattr(session, "_pool", None) is not None
                    if pooled:
                        session.feed(samples, pump=False)
                    else:
                        delta = session.feed(samples)
                        positions = session.positions_done
                        endpoint = session.endpoint()
                        if endpoint:
                            session.consume_endpoint()
                if pooled:
                    # Coalesce: the pump thread batches every session's
                    # ready step into ONE batched decode step.
                    self.state.pump_and_wait()
                    with self.state.lock:
                        if session.overrun:
                            self.state.metrics.inc(
                                "voxtral_stream_overruns_total")
                            self._json(400, {
                                "error": "stream exceeded max duration"
                            })
                            return
                        delta = session._emit()
                        positions = session.positions_done
                        endpoint = session.endpoint()
                        if endpoint:
                            session.consume_endpoint()
                reply = {"delta": delta, "positions": positions,
                         "endpoint": endpoint}
                if self._want_timestamps():
                    with self.state.lock:  # pump thread appends tokens
                        reply["words"] = session.words
                self._json(200, reply)
            else:
                with self.state.lock:
                    session = self.state.sessions.pop(sid, None)
                    self.state.last_access.pop(sid, None)
                    if session is None:
                        self._json(404, {"error": f"unknown session: {sid}"})
                        return
                    delta = session.finish()
                self.state.metrics.inc("voxtral_sessions_closed_total",
                                       reason="finished")
                self.state.metrics.inc("voxtral_tokens_total",
                                       len(session.tokens))
                reply = {
                    "delta": delta,
                    "text": session.text,
                    "tokens": len(session.tokens),
                }
                if self._want_timestamps():
                    reply["words"] = session.words
                self._json(200, reply)
        else:
            self._json(404, {"error": f"not found: {path}"})

    def _want_timestamps(self) -> bool:
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        return q.get("timestamps", ["0"])[0] in ("1", "true")

    def _transcribe_wav(self):
        from voxtral_tpu_torch.audio.io import load_wav

        body = self._read_body()
        if len(body) < 44:
            self._json(400, {"error": "body is not a WAV file"})
            return
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(body)
            f.flush()
            try:
                audio = load_wav(f.name)
            except Exception as e:
                self._json(400, {"error": f"failed to parse WAV: {e}"})
                return
        self._transcribe_reply(audio.samples, audio.sample_rate)

    def _transcribe_pcm(self):
        from urllib.parse import parse_qs, urlparse

        query = parse_qs(urlparse(self.path).query)
        try:
            rate = int(query.get("rate", ["16000"])[0])
        except ValueError:
            self._json(400, {"error": "rate must be an integer"})
            return
        if not (1 <= rate <= 1_000_000):
            self._json(400, {"error": f"implausible sample rate {rate}"})
            return
        body = self._read_body()
        if len(body) % 4:
            self._json(400, {"error": "PCM body length must be a "
                             "multiple of 4 (float32 little-endian)"})
            return
        samples = np.frombuffer(body, dtype=np.float32)
        if samples.size == 0:
            self._json(400, {"error": "empty PCM body"})
            return
        if not np.all(np.isfinite(samples)):
            self._json(400, {"error": "PCM body contains NaN/Inf "
                             "(not float32 audio?)"})
            return
        self._transcribe_reply(samples, rate)

    def _transcribe_reply(self, samples, rate):
        """Shared transcribe + response for the WAV/PCM endpoints;
        ``?timestamps=1`` adds delay-corrected word timings derived from
        the model's [STREAMING_WORD] markers."""
        timestamps = self._want_timestamps()
        t0 = time.time()
        if timestamps:
            with self.state.lock, Timer(self.state.metrics,
                                        "voxtral_transcribe_seconds"):
                result = self.state.pipeline.transcribe_samples_words(
                    samples, rate)
        else:
            # Concurrent whole-file POSTs coalesce into ONE batched
            # decode (weights stream once for the group).
            result = {"text": self.state.transcribe_coalesced(
                samples, rate)}
        self.state.metrics.inc("voxtral_audio_seconds_total",
                               len(samples) / rate, path="batch")
        self._json(200, {
            **result,
            "audio_seconds": round(len(samples) / rate, 2),
            "wall_seconds": round(time.time() - t0, 2),
        })

    # -- OpenAI-compatible surface -------------------------------------------

    def _openai_error(self, status: int, message: str,
                      param: Optional[str] = None):
        """OpenAI error envelope so stock clients raise their native
        typed exceptions instead of choking on an unfamiliar shape."""
        self._json(status, {"error": {
            "message": message,
            "type": ("invalid_request_error" if status < 500
                     else "server_error"),
            "param": param,
            "code": None,
        }})

    def _openai_transcriptions(self):
        """``POST /v1/audio/transcriptions`` — the OpenAI speech-to-text
        wire contract on top of the same coalesced/word-timing machinery
        as ``/transcribe``.  Beyond reference parity: the reference's
        dev server (``serve.mjs:41-104``) speaks only its own worker
        protocol.  WAV input only; ``temperature`` accepted but ignored
        (decode is greedy); ``language`` accepted ("en" or empty only —
        the model is English)."""
        ctype = self.headers.get("Content-Type", "")
        body = self._read_body()
        try:
            parts = parse_multipart(ctype, body)
        except ValueError as e:
            self._openai_error(400, str(e))
            return
        if "file" not in parts:
            self._openai_error(400, "missing required field: file", "file")
            return
        fmt_raw = parts.get("response_format", (None, b"json"))[1]
        fmt = fmt_raw.decode("utf-8", "replace").strip() or "json"
        if fmt not in ("json", "text", "verbose_json"):
            self._openai_error(
                400, f"response_format {fmt!r} not supported "
                "(json | text | verbose_json)", "response_format")
            return
        lang = parts.get("language", (None, b""))[1].decode(
            "utf-8", "replace").strip().lower()
        if lang not in ("", "en", "english"):
            self._openai_error(
                400, f"language {lang!r} not supported (English model)",
                "language")
            return
        stream = parts.get("stream", (None, b""))[1].decode(
            "utf-8", "replace").strip().lower() in ("true", "1")
        if stream and fmt != "json":
            self._openai_error(
                400, "stream=true supports only response_format=json",
                "stream")
            return
        filename, wav = parts["file"]
        if len(wav) < 44:
            self._openai_error(
                400, f"file {filename!r} is not a WAV file (only WAV is "
                "supported — no mp3/ogg codecs in this runtime)", "file")
            return
        import tempfile

        from voxtral_tpu_torch.audio.io import load_wav

        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(wav)
            f.flush()
            try:
                audio = load_wav(f.name)
            except Exception as e:
                self._openai_error(
                    400, f"failed to parse {filename!r} as WAV: {e} "
                    "(only WAV is supported)", "file")
                return
        samples, rate = audio.samples, audio.sample_rate
        duration = len(samples) / rate
        if stream:
            self._openai_stream_sse(samples, rate)
            return
        if fmt == "verbose_json":
            with self.state.lock, Timer(self.state.metrics,
                                        "voxtral_transcribe_seconds"):
                result = self.state.pipeline.transcribe_samples_words(
                    samples, rate)
            payload = {
                "task": "transcribe",
                "language": "english",
                "duration": round(duration, 3),
                "text": result["text"],
                "words": [{"word": w["word"],
                           "start": round(w["start"], 3),
                           "end": round(w["end"], 3)}
                          for w in result["words"]],
                # One whole-utterance segment: clients that only read
                # segments still get the full text + bounds.
                "segments": [{
                    "id": 0, "start": 0.0, "end": round(duration, 3),
                    "text": result["text"],
                }] if result["text"] else [],
            }
        else:
            text = self.state.transcribe_coalesced(samples, rate)
            payload = {"text": text}
        self.state.metrics.inc("voxtral_audio_seconds_total",
                               duration, path="batch")
        if fmt == "text":
            data = (payload["text"] + "\n").encode()
            self.send_response(200)
            self._last_status = 200
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._json(200, payload)

    def _openai_stream_sse(self, samples, rate):
        """``stream=true``: incremental transcription of the upload as
        Server-Sent Events (``transcript.text.delta`` per new text,
        ``transcript.text.done`` at the end — the OpenAI streaming
        transcription event shapes).  Rides the same StreamingSession /
        StreamPool machinery as ``/stream``, feeding the file in 1 s
        slices, so pooled serving coalesces SSE uploads with live mic
        sessions into one batched decode."""
        from voxtral_tpu_torch.audio import AudioBuffer, resample_to_16k
        from voxtral_tpu_torch.utils.hbm import HBMBudgetError

        if rate != 16000:
            samples = resample_to_16k(
                AudioBuffer(np.asarray(samples, np.float32), rate)).samples
        state = self.state
        with state.lock:
            state.evict_idle()
            if len(state.sessions) >= state.MAX_SESSIONS:
                self._openai_error(
                    429, f"too many active sessions "
                    f"(max {state.MAX_SESSIONS})")
                return
            try:
                session = _new_session(state)
            except HBMBudgetError as e:
                self._json(503, {"error": {
                    "message": str(e), "type": "server_error",
                    "param": None, "code": None}})
                return
        state.metrics.inc("voxtral_sessions_started_total")
        self.send_response(200)
        self._last_status = 200
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True

        def emit(obj):
            self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
            self.wfile.flush()

        pooled = getattr(session, "_pool", None) is not None
        finished = False
        try:
            for i in range(0, len(samples), 16000):
                chunk = np.ascontiguousarray(samples[i:i + 16000],
                                             dtype=np.float32)
                state.metrics.inc("voxtral_audio_seconds_total",
                                  chunk.size / 16000.0, path="stream")
                if pooled:
                    with state.lock:
                        session.feed(chunk, pump=False)
                    state.pump_and_wait()
                    with state.lock:
                        if session.overrun:
                            state.metrics.inc(
                                "voxtral_stream_overruns_total")
                            emit({"type": "error", "error": {
                                "message": "stream exceeded max duration",
                                "type": "invalid_request_error",
                                "param": "file", "code": None}})
                            return
                        delta = session._emit()
                else:
                    with state.lock:
                        delta = session.feed(chunk)
                if delta:
                    emit({"type": "transcript.text.delta", "delta": delta})
            with state.lock:
                delta = session.finish()
            finished = True
            if delta:
                emit({"type": "transcript.text.delta", "delta": delta})
            emit({"type": "transcript.text.done", "text": session.text})
            state.metrics.inc("voxtral_tokens_total", len(session.tokens))
            state.metrics.inc("voxtral_sessions_closed_total",
                              reason="finished")
        finally:
            if not finished:
                # Client went away (or emit failed) mid-stream: finish()
                # under the lock so a pooled slot is always detached.
                with state.lock:
                    try:
                        session.finish()
                    except Exception:  # slot release is best-effort here
                        log.exception("SSE cleanup finish failed")
                state.metrics.inc("voxtral_sessions_closed_total",
                                  reason="disconnected")


def make_server(
    pipeline: TranscribePipeline,
    host: str = "127.0.0.1",
    port: int = 8080,
    step_positions: int = 8,
    pool_streams: int = 0,
    pool_unbounded: bool = False,
    pool_kv: str = "auto",
    state_dir: Optional[str] = None,
    speculative: int = 0,
    draft: str = "pad",
    prewarm: bool = False,
) -> VoxtralHTTPServer:
    """``state_dir`` enables drain/restore: :meth:`VoxtralHTTPServer.
    drain` snapshots live streaming sessions there on shutdown, and the
    next ``make_server`` with the same dir resumes them under their
    original session ids (mid-stream, token-identical).  ``prewarm``
    builds the kernels and runs the serving paths before the server is
    returned (boot blocks; first requests are warm; a workspace OOM
    surfaces at startup instead of mid-request)."""
    srv = VoxtralHTTPServer(
        (host, port),
        _State(pipeline, step_positions, pool_streams, pool_unbounded,
               pool_kv, state_dir, speculative, draft),
    )
    if prewarm:
        srv.state.prewarm()
    return srv


def main(argv: Optional[list[str]] = None) -> int:
    """``voxtral-serve-torch``: the JAX server's flags, plus the port
    CLI's ``--dtype`` (``--model`` / ``--random-weights`` weights) and
    ``--device`` (default ``cuda``: without a card it exits with an
    error; ``--device cpu`` runs the kernels' plain versions).  ``--tp``
    / ``--dp`` make the port CLI's mesh, with its refusals."""
    import argparse
    import sys

    from voxtral_tpu_torch.cli import ArgError, device_and_mesh, load_pipeline
    from voxtral_tpu_torch.pipeline import PipelineConfig

    ap = argparse.ArgumentParser(prog="voxtral-serve-torch")
    ap.add_argument("--model", metavar="DIR",
                    help="SafeTensors model directory (in --dtype)")
    ap.add_argument("--gguf", help="Q4_0 GGUF checkpoint (needs --tokenizer)")
    ap.add_argument("--tokenizer")
    ap.add_argument("--random-weights", action="store_true",
                    help="random weights (seed 0) in --dtype")
    ap.add_argument("--params",
                    help="params.json overriding the architecture")
    ap.add_argument("--dtype", choices=["bfloat16", "float32", "w8"],
                    default="bfloat16",
                    help="--model / --random-weights weights, as the "
                    "port's CLI")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--platform", help=argparse.SUPPRESS)
    ap.add_argument("--pool-streams", type=int, default=4,
                    help="coalesce up to N concurrent /stream sessions into "
                    "batched decode steps (0 disables pooling)")
    ap.add_argument("--pool-unbounded", action="store_true",
                    help="pooled sessions use head+ring KV caches: streams "
                    "never hit a max duration (bounded only by the ~43 min "
                    "RoPE tables)")
    ap.add_argument("--pool-kv", default="auto",
                    choices=["auto", "model", "int8"],
                    help="pooled KV cache dtype: int8 halves the cache "
                    "bytes (auto = the model's dtype where a rung admits "
                    "it, else int8)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ways (mesh model axis)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ways (mesh data axis)")
    ap.add_argument("--speculative", type=int, default=0,
                    help="K>=2: streaming sessions/pools AND whole-file "
                    "/transcribe verify K drafted tokens per decode weight "
                    "pass (the same greedy tokens; needs fused weights)")
    ap.add_argument("--state-dir",
                    help="drain live streaming sessions here on "
                    "SIGTERM/SIGINT and resume any found at startup "
                    "(graceful restart without dropping streams)")
    ap.add_argument("--draft-policy", choices=["pad", "ngram"],
                    default="ngram",
                    help="speculative draft source: ngram = bigram table "
                    "trained on the device by every pass; pad = static "
                    "[STREAMING_PAD] drafts")
    ap.add_argument("--weight-format", choices=["q4", "q4g", "w8"],
                    default="w8",
                    help="GGUF weights: w8 (rowwise int8, fastest), q4g "
                    "(exact Q4_0 numerics on the fused step), q4 (packed "
                    "int4 on the per-op step, least memory)")
    ap.add_argument("--params-cache", metavar="DIR",
                    help="cache converted/quantized weight trees so "
                    "serving restarts skip GGUF repack / w8 requant")
    ap.add_argument("--prewarm", action="store_true",
                    help="build the kernels and run the serving paths "
                    "before accepting traffic (timings in /healthz)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    def error(msg: str) -> int:
        print(f"error: {msg}", file=sys.stderr)
        return 2

    if args.platform is not None:
        return error("--platform is not ported to voxtral_tpu_torch: the "
                     "port takes --device")
    if args.gguf and not (args.tokenizer or args.random_weights):
        return error("--gguf requires --tokenizer")
    if not (args.random_weights or args.gguf or args.model):
        return error("need --model, --gguf or --random-weights")
    pcfg = PipelineConfig()
    if args.speculative >= 2:
        # Whole-file /transcribe (+ the OpenAI endpoint) rides the same
        # speculative verify as the stream pool: K drafted tokens per
        # decode weight pass, the same greedy tokens.
        pcfg.speculative = args.speculative
        pcfg.draft = args.draft_policy
    try:
        device, mesh = device_and_mesh(args)
        pipeline = load_pipeline(args, pcfg, device, mesh)
    except ArgError as exc:
        return error(str(exc))

    server = make_server(pipeline, args.host, args.port,
                         pool_streams=args.pool_streams,
                         pool_unbounded=args.pool_unbounded,
                         pool_kv=args.pool_kv,
                         state_dir=args.state_dir,
                         speculative=args.speculative,
                         draft=args.draft_policy,
                         prewarm=args.prewarm)
    log.info("serving on http://%s:%d", *server.server_address[:2])
    if args.state_dir:
        import signal

        # SIGTERM (the orchestrator's stop signal) exits serve_forever
        # so the drain below runs before the process dies.
        signal.signal(signal.SIGTERM,
                      lambda *_: threading.Thread(
                          target=server.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    if args.state_dir:
        server.drain()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
