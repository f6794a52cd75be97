"""Serving surface: HTTP transcription server + browser demo client
(port of ``voxtral_tpu/serving``).

The reference's browser/WASM deployment (``web/``, ``serve.mjs``)
becomes a served endpoint with the same worker protocol shape
(init/load/transcribe + streaming feed/finish) and a mic demo page;
the routes, replies and metrics are the JAX server's.
"""

from voxtral_tpu_torch.serving.server import VoxtralHTTPServer, make_server

__all__ = ["VoxtralHTTPServer", "make_server"]
