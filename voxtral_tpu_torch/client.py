"""Python client for a transcription server (stdlib-only; a copy of
``voxtral_tpu/client.py``).

The Python-side analogue of the reference's browser client
(``web/voxtral-client.js:20-60`` — init / transcribe-file /
live-microphone surface): where the reference wraps a WebWorker
speaking its worker protocol, this wraps the HTTP server
(``voxtral_tpu_torch/serving/server.py``, or the JAX package's, which
speaks the same protocol) so any Python process can transcribe files or
feed live PCM without holding model weights or a card.

Usage::

    from voxtral_tpu_torch.client import VoxtralClient

    c = VoxtralClient("http://127.0.0.1:8080")
    c.transcribe("clip.wav")["text"]              # whole-file (WAV)
    c.transcribe("clip.wav", timestamps=True)     # + word timings
    c.transcribe_pcm(samples)                     # float32 numpy PCM

    with c.open_stream() as s:                    # live/incremental
        for chunk in pcm_chunks:                  # float32 @ 16 kHz
            print(s.feed(chunk), end="")          # new text per chunk
        print(s.finish())

    for delta in c.stream_file("clip.wav"):       # SSE over /v1
        print(delta, end="")

Every method raises :class:`ServerError` (with ``.status`` and the
server's message) on a non-2xx response; network errors surface as the
underlying ``OSError``.  No third-party dependencies — ``http.client``
only (numpy for PCM bodies) — so the module imports in any Python 3.10+
environment.
"""

from __future__ import annotations

import io
import json
import uuid
from typing import Iterable, Iterator, Optional
from urllib.parse import urlsplit


class ServerError(RuntimeError):
    """Non-2xx HTTP response; ``status`` + the server's error message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


def _error_message(body: bytes) -> str:
    try:
        payload = json.loads(body)
    except ValueError:
        return body.decode("utf-8", "replace")[:500]
    err = payload.get("error", payload)
    if isinstance(err, dict):  # OpenAI envelope
        return str(err.get("message", err))
    return str(err)


def _multipart(fields: dict) -> tuple[bytes, str]:
    """Encode ``{name: bytes | str | (filename, bytes)}`` as
    multipart/form-data; returns (body, content_type)."""
    boundary = "voxtral" + uuid.uuid4().hex
    out = io.BytesIO()
    for name, value in fields.items():
        out.write(f"--{boundary}\r\n".encode())
        if isinstance(value, tuple):
            filename, data = value
            out.write(
                f'Content-Disposition: form-data; name="{name}"; '
                f'filename="{filename}"\r\n'
                "Content-Type: application/octet-stream\r\n\r\n".encode())
            out.write(data)
        else:
            if isinstance(value, str):
                value = value.encode()
            out.write(f'Content-Disposition: form-data; name="{name}"'
                      "\r\n\r\n".encode())
            out.write(value)
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


class VoxtralClient:
    """HTTP client for one transcription server.

    ``base_url`` accepts ``http://host:port`` (https is refused —
    the stdlib server is plain HTTP; front it with a TLS proxy and
    point the client at that).  One connection per request: the
    server closes streaming responses, and reconnect-per-call keeps
    the client trivially thread-safe.
    """

    def __init__(self, base_url: str, timeout: float = 300.0):
        parts = urlsplit(base_url)
        if parts.scheme != "http":
            raise ValueError(f"unsupported scheme {parts.scheme!r} "
                             "(http only; terminate TLS in a proxy)")
        if not parts.hostname:
            raise ValueError(f"no host in base_url: {base_url!r}")
        self.host = parts.hostname
        self.port = parts.port or 80
        self.timeout = timeout

    # -- plumbing -------------------------------------------------------------

    def _request(self, method: str, path: str, body: bytes = b"",
                 content_type: Optional[str] = None, stream: bool = False):
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        headers = {}
        if content_type:
            headers["Content-Type"] = content_type
        conn.request(method, path, body=body or None, headers=headers)
        resp = conn.getresponse()
        if resp.status >= 300:
            data = resp.read()
            conn.close()
            raise ServerError(resp.status, _error_message(data))
        if stream:
            return conn, resp  # caller iterates + closes
        data = resp.read()
        conn.close()
        return data

    def _json(self, method: str, path: str, body: bytes = b"",
              content_type: Optional[str] = None) -> dict:
        return json.loads(self._request(method, path, body, content_type))

    @staticmethod
    def _pcm_bytes(samples) -> bytes:
        import numpy as np

        arr = np.ascontiguousarray(samples, dtype=np.float32)
        if arr.ndim != 1:
            raise ValueError(f"PCM must be 1-D mono, got shape {arr.shape}")
        return arr.tobytes()

    @staticmethod
    def _wav_field(audio) -> bytes:
        if isinstance(audio, bytes):
            return audio
        with open(audio, "rb") as f:  # path-like
            return f.read()

    # -- health / metadata ----------------------------------------------------

    def healthz(self) -> dict:
        return self._json("GET", "/healthz")

    def models(self) -> list[dict]:
        """OpenAI-style model listing (``GET /v1/models``)."""
        return self._json("GET", "/v1/models")["data"]

    # -- whole-file -----------------------------------------------------------

    def transcribe(self, audio, timestamps: bool = False) -> dict:
        """Transcribe a WAV file (path or raw bytes) via ``/transcribe``.

        Returns the server dict: ``{"text", "audio_seconds",
        "wall_seconds"}``, plus ``"words"`` when ``timestamps=True``.
        """
        path = "/transcribe" + ("?timestamps=1" if timestamps else "")
        return self._json("POST", path, self._wav_field(audio))

    def transcribe_pcm(self, samples, rate: int = 16000,
                       timestamps: bool = False) -> dict:
        """Transcribe raw float32 mono PCM via ``/transcribe_pcm``."""
        path = f"/transcribe_pcm?rate={int(rate)}"
        if timestamps:
            path += "&timestamps=1"
        return self._json("POST", path, self._pcm_bytes(samples))

    def transcriptions(self, audio, model: str = "",
                       response_format: str = "json",
                       filename: str = "audio.wav"):
        """OpenAI-compatible ``POST /v1/audio/transcriptions``.

        ``response_format``: ``"json"``/``"verbose_json"`` return the
        parsed dict; ``"text"`` returns the plain string.
        """
        fields: dict = {"file": (filename, self._wav_field(audio)),
                        "response_format": response_format}
        if model:
            fields["model"] = model
        body, ctype = _multipart(fields)
        data = self._request("POST", "/v1/audio/transcriptions",
                             body, ctype)
        if response_format == "text":
            return data.decode().rstrip("\n")
        return json.loads(data)

    # -- streaming ------------------------------------------------------------

    def stream_file(self, audio, filename: str = "audio.wav"
                    ) -> Iterator[str]:
        """SSE streaming transcription of a WAV upload (``stream=true``
        on ``/v1/audio/transcriptions``): yields each text delta as the
        server decodes; ``StopIteration.value``-free — collect with
        ``"".join(...)`` for the full text."""
        body, ctype = _multipart({
            "file": (filename, self._wav_field(audio)),
            "stream": "true",
        })
        conn, resp = self._request("POST", "/v1/audio/transcriptions",
                                   body, ctype, stream=True)
        try:
            buf = b""
            while True:
                chunk = resp.read(4096)
                if not chunk:
                    break
                buf += chunk
                while b"\n\n" in buf:
                    block, buf = buf.split(b"\n\n", 1)
                    block = block.strip()
                    if not block.startswith(b"data: "):
                        continue
                    event = json.loads(block[len(b"data: "):])
                    if event.get("type") == "transcript.text.delta":
                        yield event["delta"]
                    elif event.get("type") == "error":
                        raise ServerError(
                            400, _error_message(json.dumps(event).encode()))
        finally:
            conn.close()

    def open_stream(self, timestamps: bool = False) -> "StreamHandle":
        """Start a live ``/stream`` session (microphone-style feeds)."""
        sid = self._json("POST", "/stream/start")["session"]
        return StreamHandle(self, sid, timestamps)


class StreamHandle:
    """One live streaming session (``/stream/<id>/...``); context-manager
    — ``__exit__`` finishes the session so abandoned handles don't hold
    a server slot until the TTL sweep."""

    def __init__(self, client: VoxtralClient, session_id: str,
                 timestamps: bool = False):
        self.client = client
        self.session_id = session_id
        self.timestamps = timestamps
        self.text = ""
        self.words: list[dict] = []
        self.finished = False

    def _post(self, action: str, body: bytes) -> dict:
        path = f"/stream/{self.session_id}/{action}"
        if self.timestamps:
            path += "?timestamps=1"
        return self.client._json("POST", path, body)

    def feed(self, samples) -> str:
        """Send float32 mono 16 kHz PCM; returns newly decoded text."""
        reply = self._post("feed", VoxtralClient._pcm_bytes(samples))
        self.text += reply["delta"]
        self.words = reply.get("words", self.words)
        return reply["delta"]

    def feed_chunks(self, chunks: Iterable) -> Iterator[str]:
        """Feed an iterable of PCM chunks, yielding each non-empty delta."""
        for chunk in chunks:
            delta = self.feed(chunk)
            if delta:
                yield delta

    def finish(self) -> str:
        """Flush the session; returns the final delta."""
        if self.finished:
            return ""
        self.finished = True
        reply = self._post("finish", b"")
        self.text = reply["text"]
        self.words = reply.get("words", self.words)
        return reply["delta"]

    def __enter__(self) -> "StreamHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.finish()
        except ServerError:
            pass  # session already gone (TTL eviction / server restart)
