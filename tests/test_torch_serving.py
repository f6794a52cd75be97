"""HTTP serving: the port's server (``voxtral_tpu_torch.serving``) against
the JAX one (``voxtral_tpu.serving``).

Both serve the same tiny w8 tree (``tests/test_torch_streaming.py``'s:
JAX on its generic route, the port on K1's plain version on the CPU)
with a text tokenizer (id i -> ``"w<i> "``), so that every text carries
its tokens, and the same script of requests goes to both: whole-file
WAV and PCM uploads with and without word timings, three interleaved
live streams (on a pooled server two in the pool and one solo), the
OpenAI formats and their SSE stream, and every error path.  The replies
must be equal field for field apart from wall times and session ids;
the metric names and label sets of ``/metrics`` too.  The signals are
noise whose top-2 logit margins on the port's side stay above
MIN_MARGIN (asserted), so a near tie would show as such.  Drain and
restore go through a second pair of servers on one ``state_dir`` each.
The port's own cases follow ``tests/test_serving.py``'s; the client,
the CLI's ``--server``, ``utils.wer`` and ``utils.profiling`` close the
file.  On the card (``cuda``) the same script runs through the kernels
and through their plain versions, with equal replies.
"""

import http.client
import io
import json
import logging
import re
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_model import (  # noqa: F401  (one_torch_thread: autouse)
    FINAL_NORM_GAIN,
    SCALE,
    SEED,
    dense_params,
    one_torch_thread,
    tiny_config,
)

SR = 16000
# JAX's generic route and the port's K1 step move this tree's logits by
# up to about 0.23 (a stream of noise(2.5, 30) parts at a port margin of
# 0.228); the signals below keep every margin above 0.3 on the port's
# side, one-shot and live (asserted), and give JAX's tokens.
MIN_MARGIN = 0.3


def noise(secs: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=int(secs * SR))
            * 0.25).astype(np.float32)


# Whole-file uploads, the three live streams, the SSE upload.
FILE_A, FILE_B = noise(4, 7), noise(2.5, 64)
STREAMS = (noise(4, 14), noise(2.5, 64), noise(4, 33))
SSE = noise(4, 7)


def wav_bytes(sig: np.ndarray, rate: int = SR) -> bytes:
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, rate, sig.astype(np.float32))
    return buf.getvalue()


def text_tokenizer(cls, vocab: int):
    """Control ids 1 / 32 / 33 and ``"w<i> "`` for every text id."""
    return cls([f"w{i} ".encode() for i in range(vocab - 1000)],
               {1: "<s>", 32: "[STREAMING_PAD]", 33: "[STREAMING_WORD]"},
               vocab)


def request(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr[:2], timeout=300)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    out = resp.status, data, dict(resp.getheaders())
    conn.close()
    return out


def multipart(fields: dict) -> tuple:
    """{name: bytes | (filename, bytes)} -> (body, content type)."""
    boundary = "voxtraltestboundary42"
    out = io.BytesIO()
    for name, value in fields.items():
        out.write(f"--{boundary}\r\n".encode())
        if isinstance(value, tuple):
            out.write(f'Content-Disposition: form-data; name="{name}"; '
                      f'filename="{value[0]}"\r\n'
                      "Content-Type: application/octet-stream\r\n\r\n"
                      .encode())
            out.write(value[1])
        else:
            out.write(f'Content-Disposition: form-data; name="{name}"'
                      "\r\n\r\n".encode())
            out.write(value)
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


def sse_events(data: bytes) -> list:
    return [json.loads(b[len("data: "):])
            for b in (x.strip() for x in data.decode().split("\n\n"))
            if b.startswith("data: ")]


_TMP_WAV = re.compile(r"\S*/tmp[^/\s]*\.wav")
_SESSION_ID = re.compile(r"\b[0-9a-f]{12}\b")


def reply(status: int, data: bytes, headers: dict):
    """(status, body) with what may differ between two servers taken
    out: wall times, session ids, temporary file names in messages."""
    ctype = headers.get("Content-Type", "")
    if ctype.startswith("application/json"):
        body = json.loads(data)
        body.pop("wall_seconds", None)
        text = _SESSION_ID.sub("<id>", _TMP_WAV.sub("<wav>", json.dumps(body)))
        body = json.loads(text)
    elif ctype.startswith("text/event-stream"):
        body = sse_events(data)
    else:
        body = data.decode()
    return status, body


def metric_series(text: str) -> dict:
    """Prometheus text -> {series (name and labels): value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, val = line.rpartition(" ")
            out[name] = float(val)
    return out


# Series whose values a request script sets exactly (the rest time it).
EXACT_SERIES = ("voxtral_requests_total", "voxtral_tokens_total",
                "voxtral_sessions_started_total",
                "voxtral_sessions_closed_total",
                "voxtral_audio_seconds_total", "voxtral_sessions_active",
                "voxtral_pool_free_slots",
                "voxtral_sessions_restored_total")


def exact(series: dict) -> dict:
    return {k: v for k, v in series.items() if k.startswith(EXACT_SERIES)}


def pieces(sig: np.ndarray, n: int) -> list:
    cuts = np.linspace(0, len(sig), n + 1).astype(int)[1:-1] + 777
    return np.split(sig, cuts)


def script(addr) -> list:
    """The request script: [(label, status, body), ...]."""
    out = []

    def rec(label, method, path, body=None, headers=None):
        status, data, hdrs = request(addr, method, path, body, headers)
        out.append((label, *reply(status, data, hdrs)))
        return json.loads(data) if hdrs.get("Content-Type", "").startswith(
            "application/json") else None

    rec("healthz", "GET", "/healthz")
    rec("models", "GET", "/v1/models")
    rec("wav", "POST", "/transcribe", wav_bytes(FILE_A))
    rec("wav words", "POST", "/transcribe?timestamps=1", wav_bytes(FILE_B))
    rec("pcm", "POST", "/transcribe_pcm?rate=16000", FILE_B.tobytes())
    rec("pcm words", "POST", "/transcribe_pcm?rate=16000&timestamps=true",
        FILE_A.tobytes())
    # Three live streams fed in turns; on a pooled server (two slots)
    # the third is solo.
    sids = [rec(f"start {i}", "POST", "/stream/start")["session"]
            for i in range(3)]
    parts = [pieces(s, 4) for s in STREAMS]
    for j in range(4):
        for i, sid in enumerate(sids):
            q = "?timestamps=1" if i == 1 else ""
            rec(f"feed {i}.{j}", "POST", f"/stream/{sid}/feed{q}",
                parts[i][j].tobytes())
    for i, sid in enumerate(sids):
        rec(f"finish {i}", "POST", f"/stream/{sid}/finish?timestamps=1")
        rec(f"gone {i}", "POST", f"/stream/{sid}/feed", b"")
    # The OpenAI surface.
    for fmt in (b"json", b"text", b"verbose_json"):
        body, ctype = multipart({"file": ("a.wav", wav_bytes(FILE_B)),
                                 "response_format": fmt, "language": b"en",
                                 "model": b"voxtral-mini-realtime"})
        rec(f"openai {fmt.decode()}", "POST", "/v1/audio/transcriptions",
            body, {"Content-Type": ctype})
    body, ctype = multipart({"file": ("s.wav", wav_bytes(SSE)),
                             "stream": b"true"})
    rec("sse", "POST", "/v1/audio/transcriptions", body,
        {"Content-Type": ctype})
    for label, fields in (
            ("openai no file", {"model": b"x"}),
            ("openai srt", {"file": ("t.wav", wav_bytes(FILE_B)),
                            "response_format": b"srt"}),
            ("openai fr", {"file": ("t.wav", wav_bytes(FILE_B)),
                           "language": b"fr"}),
            ("openai mp3", {"file": ("t.mp3", b"\xff\xfb" + b"0" * 100)}),
            ("openai bad wav", {"file": ("t.wav", b"RIFF" + b"0" * 100)}),
            ("openai sse verbose", {"file": ("t.wav", wav_bytes(FILE_B)),
                                    "stream": b"true",
                                    "response_format": b"verbose_json"})):
        body, ctype = multipart(fields)
        rec(label, "POST", "/v1/audio/transcriptions", body,
            {"Content-Type": ctype})
    rec("openai not multipart", "POST", "/v1/audio/transcriptions", b"{}")
    # Error paths.
    rec("get 404", "GET", "/nope")
    rec("post 404", "POST", "/nope", b"")
    rec("tiny wav", "POST", "/transcribe", b"tiny")
    rec("bad wav", "POST", "/transcribe", b"RIFF" + b"\0" * 60)
    rec("unknown session", "POST", "/stream/unknown/feed", b"")
    rec("unknown finish", "POST", "/stream/unknown/finish", b"")
    rec("bad stream action", "POST", "/stream/x/y", b"")
    rec("empty pcm", "POST", "/transcribe_pcm", b"")
    rec("odd pcm", "POST", "/transcribe_pcm", b"\0" * 6)
    rec("nan pcm", "POST", "/transcribe_pcm",
        np.array([0.1, np.nan], np.float32).tobytes())
    rec("rate text", "POST", "/transcribe_pcm?rate=abc", b"\0" * 8)
    rec("rate 0", "POST", "/transcribe_pcm?rate=0", b"\0" * 8)
    rec("healthz after", "GET", "/healthz")
    return out


def assert_same(got: list, ref: list) -> None:
    assert [g[0] for g in got] == [r[0] for r in ref]
    for g, r in zip(got, ref):
        assert g == r, f"{g[0]}: port {g[1:]} != JAX {r[1:]}"


# -- fixtures -------------------------------------------------------------------


@pytest.fixture(scope="module")
def w8_tree():
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    return quantize_params_w8(dense_params(tiny_config(), SEED, SCALE,
                                           FINAL_NORM_GAIN))


@pytest.fixture(scope="module")
def pipelines(w8_tree):
    """(JAX pipeline on its generic route, port pipeline on the CPU),
    one tiny w8 tree, text tokenizers."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.pipeline import TranscribePipeline as JaxPipeline
    from voxtral_tpu.tokenizer import VoxtralTokenizer as JaxTokenizer
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.pipeline import TranscribePipeline
    from voxtral_tpu_torch.tokenizer import VoxtralTokenizer

    cfg, tree = tiny_config(), w8_tree
    vocab = cfg.language_model.vocab_size
    jmodel = JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg)
    model = VoxtralModel.from_numpy(tree, cfg, "cpu")
    return (JaxPipeline(jmodel, text_tokenizer(JaxTokenizer, vocab)),
            TranscribePipeline(model, text_tokenizer(VoxtralTokenizer, vocab)))


def serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def servers(pipelines):
    """{pool_streams: (JAX server, port server)} for 0 and 2."""
    from voxtral_tpu.serving import make_server as jax_make_server
    from voxtral_tpu_torch.serving import make_server

    jpipe, pipe = pipelines
    out = {pool: (serve(jax_make_server(jpipe, "127.0.0.1", 0,
                                        pool_streams=pool)),
                  serve(make_server(pipe, "127.0.0.1", 0, pool_streams=pool)))
           for pool in (0, 2)}
    yield out
    for pair in out.values():
        for srv in pair:
            srv.shutdown()
            srv.server_close()


@pytest.fixture(scope="module")
def scripted(servers):
    """{pool_streams: (JAX replies, port replies)} of the script."""
    return {pool: (script(j.server_address), script(t.server_address))
            for pool, (j, t) in servers.items()}


# -- the port against JAX -------------------------------------------------------


def test_signals_clear_near_ties(pipelines):
    """Every signal of the script decodes on the port's side with top-2
    margins above MIN_MARGIN, one-shot and as a live stream."""
    from voxtral_tpu_torch.streaming import StreamingSession

    pipe = pipelines[1]
    model = pipe.model
    model.record_margins = True
    try:
        for sig in (FILE_A, FILE_B, SSE):
            pipe.transcribe_samples(sig)
            assert min(model.last_margins[0]) > MIN_MARGIN
        for sig in (*STREAMS, SSE):
            s = StreamingSession(model, pipe.tokenizer)
            s.feed(sig)
            s.finish()
            assert min(s.margins) > MIN_MARGIN
    finally:
        model.record_margins = False


@pytest.mark.parametrize("pool", [0, 2])
def test_replies_match_jax(scripted, pool):
    jax_replies, replies = scripted[pool]
    assert_same(replies, jax_replies)
    by = {label: (status, body) for label, status, body in replies}
    # The script exercises what it should: texts carry tokens, words
    # come back, the SSE deltas join to its done text, the errors are
    # errors.
    assert by["wav"][1]["text"] and by["finish 0"][1]["tokens"] > 0
    assert all(set(w) == {"word", "start", "end"}
               for w in by["pcm words"][1]["words"])
    events = by["sse"][1]
    assert events[-1]["type"] == "transcript.text.done"
    assert "".join(e["delta"] for e in events[:-1]) == events[-1]["text"]
    assert by["openai text"][1].endswith("\n")
    assert by["gone 0"][0] == by["get 404"][0] == 404
    assert by["openai no file"][1]["error"]["param"] == "file"
    assert by["healthz"][1]["backend"] == "cpu"


@pytest.mark.parametrize("pool", [0, 2])
def test_metrics_match_jax(scripted, servers, pool):
    """The series /metrics exposes after the script, by name and label
    set, and the values of those the script sets exactly."""
    got, ref = (metric_series(request(srv.server_address, "GET",
                                      "/metrics")[1].decode())
                for srv in servers[pool][::-1])
    assert set(got) == set(ref)
    assert exact(got) == exact(ref)
    if pool:
        assert got["voxtral_pool_free_slots"] == 2
        assert got["voxtral_pump_seconds_count"] >= 1


def test_stream_texts_equal_a_direct_session(scripted, pipelines):
    """Each /stream text equals a direct session fed the same pieces
    (pooled and solo, the pool's tokens independent of its other
    slots); the SSE text equals a solo session fed 1 s slices."""
    from voxtral_tpu_torch.streaming import StreamingSession

    pipe = pipelines[1]
    for pool in (0, 2):
        by = {label: body for label, _, body in scripted[pool][1]}
        for i, sig in enumerate(STREAMS):
            s = StreamingSession(pipe.model, pipe.tokenizer)
            for p in pieces(sig, 4):
                s.feed(p)
            s.finish()
            assert by[f"finish {i}"]["text"] == s.text
            assert by[f"finish {i}"]["tokens"] == len(s.tokens)
        s = StreamingSession(pipe.model, pipe.tokenizer)
        for lo in range(0, len(SSE), SR):
            s.feed(SSE[lo:lo + SR])
        s.finish()
        assert by["sse"][-1]["text"] == s.text


@pytest.mark.parametrize("pool", [0, 2])
def test_drain_restore_matches_jax(pipelines, tmp_path, pool):
    """A stream drained mid-way by one server and resumed by a second on
    the same ``state_dir``: the port's replies equal JAX's, and its text
    equals the uninterrupted stream's."""
    from voxtral_tpu.serving import make_server as jax_make_server
    from voxtral_tpu_torch.serving import make_server
    from voxtral_tpu_torch.streaming import StreamingSession

    sig = STREAMS[0]
    results = []
    for name, make, pipe in (("jax", jax_make_server, pipelines[0]),
                             ("port", make_server, pipelines[1])):
        sd = str(tmp_path / name)
        out = []
        a = serve(make(pipe, "127.0.0.1", 0, pool_streams=pool,
                       state_dir=sd))
        try:
            st, data, _ = request(a.server_address, "POST", "/stream/start")
            sid = json.loads(data)["session"]
            out.append(reply(*request(a.server_address, "POST",
                                      f"/stream/{sid}/feed",
                                      sig[:30000].tobytes())))
        finally:
            a.shutdown()
            a.server_close()
        out.append(a.drain())
        assert (tmp_path / name / f"{sid}.npz").exists()
        b = serve(make(pipe, "127.0.0.1", 0, pool_streams=pool,
                       state_dir=sd))
        try:
            assert not (tmp_path / name / f"{sid}.npz").exists()
            for path, body in ((f"/stream/{sid}/feed", sig[30000:]),
                               (f"/stream/{sid}/finish?timestamps=1",
                                b"")):
                out.append(reply(*request(
                    b.server_address, "POST", path,
                    body if isinstance(body, bytes) else body.tobytes())))
            m = metric_series(request(b.server_address, "GET",
                                      "/metrics")[1].decode())
            out.append(exact(m))
        finally:
            b.shutdown()
            b.server_close()
        results.append(out)
    assert results[1] == results[0]
    assert results[1][-1]["voxtral_sessions_restored_total"] == 1
    pipe = pipelines[1]
    s = StreamingSession(pipe.model, pipe.tokenizer)
    s.feed(sig)
    s.finish()
    assert results[1][-2][1]["text"] == s.text


def test_index_page_is_jax_bytes(servers):
    from pathlib import Path

    status, data, hdrs = request(servers[0][1].server_address, "GET", "/")
    assert status == 200 and hdrs["Content-Type"].startswith("text/html")
    page = Path("voxtral_tpu/serving/static/index.html").read_bytes()
    assert data == page
    assert request(servers[0][1].server_address, "GET",
                   "/index.html")[1] == page


# -- the port's counterparts of tests/test_serving.py ----------------------------


def test_body_size_cap(servers):
    """A declared Content-Length above the cap -> 413 from the header
    alone, as JAX's."""
    for srv in servers[0]:
        conn = http.client.HTTPConnection(*srv.server_address, timeout=300)
        conn.putrequest("POST", "/transcribe_pcm?rate=16000")
        conn.putheader("Content-Length", str(10 * 2**30))
        conn.endheaders()
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        assert resp.status == 413 and b"exceeds" in data


def test_body_cap_closes_connection(servers, monkeypatch):
    from voxtral_tpu.serving.server import _Handler as JaxHandler
    from voxtral_tpu_torch.serving.server import _Handler

    got = []
    for cls, srv in zip((JaxHandler, _Handler), servers[0]):
        monkeypatch.setattr(cls, "MAX_BODY_BYTES", 1024)
        conn = http.client.HTTPConnection(*srv.server_address, timeout=300)
        conn.request("POST", "/transcribe_pcm?rate=16000",
                     body=b"\0" * 4096)
        resp = conn.getresponse()
        got.append((resp.status, json.loads(resp.read()),
                    (resp.getheader("Connection") or "").lower(),
                    resp.will_close))
        conn.close()
    assert got[1] == got[0] == (413, got[0][1], "close", True)


def test_too_many_sessions_429(servers, monkeypatch):
    got = []
    for srv in servers[0]:
        monkeypatch.setattr(srv.state, "MAX_SESSIONS", 1)
        addr = srv.server_address
        sid = json.loads(request(addr, "POST", "/stream/start")[1])["session"]
        got.append(reply(*request(addr, "POST", "/stream/start")))
        body, ctype = multipart({"file": ("s.wav", wav_bytes(SSE)),
                                 "stream": b"true"})
        got.append(reply(*request(addr, "POST", "/v1/audio/transcriptions",
                                  body, {"Content-Type": ctype})))
        assert request(addr, "POST", f"/stream/{sid}/finish")[0] == 200
    assert got[2:] == got[:2]
    assert got[0][0] == got[1][0] == 429


def test_hbm_budget_503(servers, monkeypatch):
    """/stream/start and the SSE route under an exhausted budget -> 503
    on both servers, the session never made; with the budget lifted the
    same route works."""
    got = []
    for srv in servers[0]:
        addr = srv.server_address
        monkeypatch.setenv("VOXTRAL_HBM_BYTES", "1")
        status, data, _ = request(addr, "POST", "/stream/start")
        body, ctype = multipart({"file": ("s.wav", wav_bytes(SSE)),
                                 "stream": b"true"})
        sse = request(addr, "POST", "/v1/audio/transcriptions", body,
                      {"Content-Type": ctype})
        got.append((status, set(json.loads(data)), sse[0],
                     set(json.loads(sse[1])["error"])))
        monkeypatch.delenv("VOXTRAL_HBM_BYTES")
        status, data, _ = request(addr, "POST", "/stream/start")
        assert status == 200
        sid = json.loads(data)["session"]
        assert request(addr, "POST", f"/stream/{sid}/finish")[0] == 200
    assert got[1] == got[0] == (503, {"error"}, 503,
                                {"message", "type", "param", "code"})


def test_solo_sessions_admitted_beside_the_held_caches(servers, monkeypatch):
    """The port admits a solo session only if its caches fit beside
    those the server holds: with room for one, the second is refused
    with 503 (each fits alone), and admitted again once the first is
    finished."""
    from voxtral_tpu_torch.streaming import solo_cache_bytes
    from voxtral_tpu_torch.utils import hbm

    srv = servers[0][1]
    model, addr = srv.state.pipeline.model, srv.server_address
    one = solo_cache_bytes(model, srv.state.step_positions)
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(
        hbm.model_hbm_bytes(model) + hbm.WORKSPACE_BYTES + one + one // 2))
    first = json.loads(request(addr, "POST", "/stream/start")[1])["session"]
    assert srv.state.sessions[first].cache_bytes == one
    status, data, _ = request(addr, "POST", "/stream/start")
    assert status == 503 and "2 solo streaming sessions" in json.loads(
        data)["error"]
    assert request(addr, "POST", f"/stream/{first}/finish")[0] == 200
    status, data, _ = request(addr, "POST", "/stream/start")
    assert status == 200
    sid = json.loads(data)["session"]
    assert request(addr, "POST", f"/stream/{sid}/finish")[0] == 200


def test_transcribe_coalesces_concurrent_posts(servers):
    """Concurrent whole-file POSTs share one batched decode: all succeed
    with the text of one at a time, and the coalesced counter moves."""
    srv = servers[0][1]
    addr = srv.server_address
    results = [None] * 4
    alone = json.loads(request(addr, "POST", "/transcribe_pcm?rate=16000",
                               FILE_B.tobytes())[1])["text"]

    def post(i):
        results[i] = request(addr, "POST", "/transcribe_pcm?rate=16000",
                             FILE_B.tobytes())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [r[0] for r in results] == [200] * 4
    assert {json.loads(r[1])["text"] for r in results} == {alone}
    m = metric_series(request(addr, "GET", "/metrics")[1].decode())
    assert m["voxtral_transcribe_coalesced_total"] >= 2


def test_prewarm_report(pipelines):
    """make_server(prewarm=True) runs the serving paths before returning:
    JAX's three report keys, in /healthz, and no pool slot leaked."""
    from voxtral_tpu_torch.serving import make_server

    srv = serve(make_server(pipelines[1], "127.0.0.1", 0, pool_streams=2,
                            prewarm=True))
    try:
        assert set(srv.state.prewarm_report) == {
            "full_chunk_s", "short_bucket_s", "session_s"}
        assert srv.state.pool.free_slots == 2
        status, data, _ = request(srv.server_address, "GET", "/healthz")
        assert json.loads(data)["prewarm"] == srv.state.prewarm_report
    finally:
        srv.shutdown()
        srv.server_close()


def test_pump_failure_is_logged_and_swallowed(servers, monkeypatch, caplog):
    """A failing pool pump is logged at ERROR on the server's logger and
    the feed still answers (JAX's behaviour); the next pump works."""
    srv = servers[2][1]
    addr = srv.server_address
    sid = json.loads(request(addr, "POST", "/stream/start")[1])["session"]
    pool = srv.state.pool

    def broken():
        raise RuntimeError("pump broke")

    monkeypatch.setattr(pool, "pump", broken)
    with caplog.at_level(logging.ERROR, logger="voxtral_tpu_torch.serving"):
        status, data, _ = request(addr, "POST", f"/stream/{sid}/feed",
                                  STREAMS[0][:8000].tobytes())
    assert status == 200 and json.loads(data)["delta"] == ""
    assert any(r.levelno == logging.ERROR and "pool pump failed" in
               r.getMessage() for r in caplog.records)
    monkeypatch.undo()
    assert request(addr, "POST", f"/stream/{sid}/finish")[0] == 200


# -- the client and the CLI ----------------------------------------------------


def test_client(servers):
    from voxtral_tpu_torch.client import ServerError, VoxtralClient

    for pool in (0, 2):
        srv = servers[pool][1]
        c = VoxtralClient("http://%s:%d" % srv.server_address[:2])
        assert c.healthz()["status"] == "ok"
        assert c.models()[0]["id"] == "voxtral-mini-realtime"
        wav = wav_bytes(FILE_B)
        text = c.transcribe(wav)["text"]
        assert c.transcribe(wav, timestamps=True)["text"] == text
        assert c.transcribe_pcm(FILE_B)["text"] == text
        assert c.transcriptions(wav) == {"text": text}
        assert c.transcriptions(wav, response_format="text") == text
        assert c.transcriptions(
            wav, response_format="verbose_json")["task"] == "transcribe"
        # A session's text keeps its trailing space; the file's is stripped.
        assert "".join(c.stream_file(wav_bytes(SSE))).strip() == (
            c.transcriptions(wav_bytes(SSE))["text"])
        with c.open_stream(timestamps=True) as s:
            for p in pieces(STREAMS[1], 3):
                s.feed(p)
            s.finish()
            assert s.finished and s.text
        assert request(srv.server_address, "POST",
                       f"/stream/{s.session_id}/feed", b"")[0] == 404
        with pytest.raises(ServerError) as e:
            c.transcribe(b"not a wav")
        assert e.value.status == 400
    with pytest.raises(ValueError):
        VoxtralClient("https://example.com")  # TLS refused up front
    m = metric_series(request(servers[2][1].server_address, "GET",
                              "/metrics")[1].decode())
    assert m["voxtral_pool_free_slots"] == 2


def test_cli_server_prints_what_local_decoding_prints(servers, pipelines,
                                                      tmp_path, capsys):
    from voxtral_tpu_torch import cli

    pipe, srv = pipelines[1], servers[0][1]
    url = "http://%s:%d" % srv.server_address[:2]
    paths = []
    for i, sig in enumerate((FILE_A, FILE_B)):
        paths.append(tmp_path / f"{i}.wav")
        paths[-1].write_bytes(wav_bytes(sig))
    argv = ["--server", url, "--audio", str(paths[0]), "--audio",
            str(tmp_path / "missing.wav"), "--audio", str(paths[1])]
    assert cli.main(argv) == 1  # the missing file
    out = capsys.readouterr()
    assert out.out.splitlines() == [pipe.transcribe_file(paths[0]), "",
                                    pipe.transcribe_file(paths[1])]
    assert "audio file not found" in out.err
    assert cli.main(["--server", url, "--timestamps", "--audio",
                     str(paths[0])]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line == {"file": str(paths[0]),
                    **pipe.transcribe_file_words(paths[0])}
    assert cli.main(["--server", "https://x", "--audio",
                     str(paths[0])]) == 2


def test_serve_main_needs_a_card(monkeypatch, capsys):
    """``serving.server.main`` without a card and without ``--device cpu``
    exits non-zero naming it; ``--platform`` is refused."""
    from voxtral_tpu_torch.serving import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--random-weights", "--dtype", "w8", "--params",
            "tests/fixtures/params_tiny.json"]
    assert server.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert server.main([*argv, "--platform", "cpu"]) == 2
    assert "--device" in capsys.readouterr().err
    assert server.main(["--device", "cpu"]) == 2
    assert server.main(["--gguf", "x.gguf", "--device", "cpu"]) == 2


# -- utils.wer and utils.profiling ---------------------------------------------


WER_PAIRS = [
    ("Hello, world!", "hello world"),
    ("the cat sat on the mat", "the cat sat on mat"),
    ("Don't stop.", "dont  STOP"),
    ("", ""), ("", "extra words"), ("a b c", ""),
    ("end.Start of it", "endstart of it"),
    ("Voilà — ça va?", "voila ca va"),
]


def test_wer_matches_jax():
    from voxtral_tpu.utils import wer as jwer
    from voxtral_tpu_torch.utils import wer

    for ref, hyp in WER_PAIRS:
        for norm in (True, False):
            assert wer.wer(ref, hyp, norm) == jwer.wer(ref, hyp, norm)
            assert wer.cer(ref, hyp, norm) == jwer.cer(ref, hyp, norm)
        assert wer.normalize_text(ref) == jwer.normalize_text(ref)
    refs, hyps = zip(*WER_PAIRS)
    assert wer.aggregate_wer(list(refs), list(hyps)) == jwer.aggregate_wer(
        list(refs), list(hyps))


def test_span_logs_jax_line(caplog):
    from voxtral_tpu.utils import profiling as jprof
    from voxtral_tpu_torch.utils import profiling

    with caplog.at_level(logging.INFO):
        with jprof.span("mel", chunks=2, samples=32000):
            pass
        with profiling.span("mel", chunks=2, samples=32000):
            pass
    jline, line = (r.getMessage() for r in caplog.records[-2:])
    assert caplog.records[-1].name == "voxtral_tpu_torch.profiling"

    def strip(s):
        return re.sub(r"elapsed_ms=[0-9.]+", "elapsed_ms=<t>", s)

    assert strip(line) == strip(jline) == (
        "span mel elapsed_ms=<t> chunks=2 samples=32000")


def test_pipeline_spans_at_jax_sites(pipelines, caplog):
    """One transcribe logs the spans JAX's logs, in JAX's order (JAX's
    encode_audio is a model method neither pipeline calls)."""
    names = []
    for pipe, logger in zip(pipelines, ("voxtral_tpu.profiling",
                                        "voxtral_tpu_torch.profiling")):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=logger):
            pipe.transcribe_samples(FILE_B)
        names.append([r.getMessage().split()[1] for r in caplog.records
                      if r.name == logger])
    assert names[1] == names[0] == ["mel", "transcribe_dispatch",
                                    "transcribe_fetch", "decode_tokens"]


def test_trace_writes_a_chrome_trace(tmp_path):
    from voxtral_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "t")) as logdir:
        with profiling.annotate("voxtral_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert logdir == str(tmp_path / "t")
    assert any(e.get("name") == "voxtral_region"
               for e in trace["traceEvents"])


# -- the card ---------------------------------------------------------------------


@pytest.mark.cuda
def test_server_kernels_match_plain_on_card(pipelines, w8_tree):
    """The script through a port server on the card (the kernels) and
    through one whose model runs their plain versions: equal replies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.pipeline import TranscribePipeline
    from voxtral_tpu_torch.serving import make_server

    cpu = pipelines[1]
    model = VoxtralModel.from_numpy(w8_tree, cpu.model.config, "cuda")
    plain = VoxtralModel(model.params, cpu.model.config, "cuda",
                         kernels=False)
    replies = {}
    for name, m in (("kernels", model), ("plain", plain)):
        for pool in (0, 2):
            srv = serve(make_server(TranscribePipeline(m, cpu.tokenizer),
                                    "127.0.0.1", 0, pool_streams=pool,
                                    prewarm=True))
            k1.decode_stack_step.launches = 0
            try:
                replies[name, pool] = script(srv.server_address)
            finally:
                srv.shutdown()
                srv.server_close()
            if name == "kernels":
                assert k1.decode_stack_step.launches > 0
    for pool in (0, 2):
        # /healthz carries the prewarm report's seconds.
        got = [r for r in replies["kernels", pool]
               if not r[0].startswith("healthz")]
        ref = [r for r in replies["plain", pool]
               if not r[0].startswith("healthz")]
        assert_same(got, ref)
