"""Minimal HTTP front end over StyleTransferService (stdlib only;
``tasks/style_http.py:32-164`` of the JAX package).

POST /style with an image body (raw uint8 H×W×3 with the ``X-Raw-Shape``
header, or anything Pillow decodes) returns the stylised canvas as a PNG,
written by ``utils/png.encode_png``, with ``X-Iterations`` and
``X-Final-Loss`` headers. The ``X-Style`` header picks a gallery style by
name or blends several (``X-Style: a:0.7,b:0.3``). GET /styles lists the
gallery, /stats the service counters, /metrics the same in Prometheus text,
and /healthz answers 200 while the workers are alive.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.png import encode_png
from .serving_http import HTTPServer, _decode_image
from .style_service import StyleTransferService


def _parse_style_header(value):
    """``None`` | ``"name"`` | ``"a:0.7,b:0.3"`` -> submit()'s style arg.
    A part without an explicit weight gets 1.0 (``"a,b"`` = equal blend)."""
    if value is None or ("," not in value and ":" not in value):
        return value
    style = {}
    for part in value.split(","):
        name, _, wt = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"empty style name in X-Style: {value!r}")
        try:
            style[name] = float(wt) if wt.strip() else 1.0
        except ValueError:
            raise ValueError(f"bad weight {wt.strip()!r} for style {name!r} in X-Style")
    return style


def make_style_http_server(
    service: StyleTransferService,
    host: str = "127.0.0.1",
    port: int = 0,
    timeout_s: float = 300.0,
) -> ThreadingHTTPServer:
    """Build (not start) a ThreadingHTTPServer bound to (host, port).
    port=0 picks a free port (read it back from ``server.server_address``)."""
    staging = max(256, round(service.crop * 256 / 224))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, content_type: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict):
            self._send(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                ok, reason = service.health()
                if ok:
                    self._json(200, {"ok": True})
                else:
                    self._json(503, {"ok": False, "error": reason})
            elif self.path == "/stats":
                self._json(200, service.stats())
            elif self.path == "/styles":
                self._json(200, {"styles": list(service.style_names)})
            elif self.path == "/metrics":
                s = service.stats()
                lines = [
                    "# TYPE hst_style_jobs_total counter",
                    f"hst_style_jobs_total {s['jobs']}",
                    "# TYPE hst_style_batches_total counter",
                    f"hst_style_batches_total {s['batches']}",
                    "# TYPE hst_style_batch_occupancy gauge",
                    f"hst_style_batch_occupancy {s['mean_batch_occupancy']:.6f}",
                    "# TYPE hst_style_mean_iterations gauge",
                    f"hst_style_mean_iterations {s['mean_iterations']:.3f}",
                    "# TYPE hst_style_jobs_per_second gauge",
                    f"hst_style_jobs_per_second {s['jobs_per_sec']:.4f}",
                    "# TYPE hst_style_latency_ms summary",
                    f'hst_style_latency_ms{{quantile="0.5"}} {s["latency_p50_ms"]:.3f}',
                    f'hst_style_latency_ms{{quantile="0.95"}} {s["latency_p95_ms"]:.3f}',
                    "# TYPE hst_style_healthy gauge",
                    f"hst_style_healthy {int(service.healthy())}",
                ]
                self._send(200, ("\n".join(lines) + "\n").encode(), "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/style":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                image = _decode_image(body, self.headers.get("X-Raw-Shape"), staging)
            except Exception as e:
                self._json(400, {"error": str(e) or repr(e)})
                return
            try:
                style = _parse_style_header(self.headers.get("X-Style"))
                fut = service.submit(image, style=style)
            except ValueError as e:
                self._json(400, {"error": str(e) or repr(e)})
                return
            except Exception as e:
                self._json(503, {"error": str(e) or repr(e)})
                return
            try:
                result = fut.result(timeout=timeout_s)
            except Exception as e:
                self._json(503, {"error": str(e) or repr(e)})
                return
            self._send(200, encode_png(np.asarray(result.image)), "image/png",
                       [("X-Iterations", str(result.iterations)),
                        ("X-Final-Loss", f"{result.loss:.8g}")])

    return HTTPServer((host, port), Handler)


def serve_style_http(
    service: StyleTransferService,
    host: str = "127.0.0.1",
    port: int = 8001,
) -> ThreadingHTTPServer:
    """Start the HTTP server on a daemon thread; returns the server (call
    ``.shutdown()`` to stop)."""
    srv = make_style_http_server(service, host, port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
