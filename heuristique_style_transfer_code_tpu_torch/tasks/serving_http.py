"""Minimal HTTP front end over ``BatchingInferenceServer`` (stdlib only;
``tasks/serving_http.py`` of the JAX package).

POST /predict with an image body (anything Pillow decodes, or raw uint8
H×W×3 with the ``X-Raw-Shape`` header) returns JSON ``{"probs": [...],
"class": "<name>", "prob": p}``. GET /stats returns the batcher's counters,
/metrics the same in Prometheus text, and /healthz 200 while the batcher
can make progress (503 otherwise).

Each request thread decodes its own image and blocks on the Future from
``submit``; the batcher packs concurrent requests into full device batches.
The request-body decoding and the server class are shared with the style
front end (``tasks/style_http.py``).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np


class HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for many clients: the
    default of 5 drops the connections that arrive together beyond it,
    and each dropped one waits a TCP retransmission (a second or more)."""

    request_queue_size = 1024


def _decode_image(body: bytes, raw_shape: Optional[str], staging: int) -> np.ndarray:
    """A raw uint8 H×W×3 body (``X-Raw-Shape: H,W,3``) as it is, or an
    encoded image (anything Pillow decodes, imported only then) staged to
    (staging, staging, 3)."""
    if raw_shape:
        h, w, c = (int(x) for x in raw_shape.split(","))
        if c != 3 or h <= 0 or w <= 0:
            raise ValueError(f"X-Raw-Shape must be H,W,3 with H,W > 0, got {raw_shape}")
        arr = np.frombuffer(body, dtype=np.uint8)
        if arr.size != h * w * c:
            raise ValueError("X-Raw-Shape does not match body size")
        return arr.reshape(h, w, c)
    from ..data.loader import decode_image_staged_bytes

    return decode_image_staged_bytes(body, staging)


def make_http_server(
    batcher,
    class_names: List[str],
    host: str = "127.0.0.1",
    port: int = 0,
    timeout_s: float = 30.0,
) -> ThreadingHTTPServer:
    """Build (not start) a ThreadingHTTPServer bound to (host, port) over
    ``batcher`` (a ``BatchingInferenceServer`` or anything with its
    ``submit``/``stats``/``health``/``healthy`` and ``crop``, such as the
    recycling proxy). port=0 picks a free port (read it back from
    ``server.server_address``)."""
    # encoded images are staged to the batcher's geometry (crop * 256/224,
    # the canonical resize:crop ratio)
    staging = max(256, round(batcher.crop * 256 / 224))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                ok, reason = batcher.health()
                if ok:
                    self._json(200, {"ok": True})
                else:
                    self._json(503, {"ok": False, "error": reason})
            elif self.path == "/stats":
                self._json(200, batcher.stats())
            elif self.path == "/metrics":
                # Prometheus text exposition of the batcher counters
                s = batcher.stats()
                lines = [
                    "# TYPE hst_images_total counter",
                    f"hst_images_total {s['images']}",
                    "# TYPE hst_batches_total counter",
                    f"hst_batches_total {s['batches']}",
                    "# TYPE hst_batch_occupancy gauge",
                    f"hst_batch_occupancy {s['mean_batch_occupancy']:.6f}",
                    "# TYPE hst_throughput_images_per_second gauge",
                    f"hst_throughput_images_per_second {s['throughput_imgs_per_sec']:.3f}",
                    "# TYPE hst_latency_ms summary",
                    f'hst_latency_ms{{quantile="0.5"}} {s["latency_p50_ms"]:.3f}',
                    f'hst_latency_ms{{quantile="0.95"}} {s["latency_p95_ms"]:.3f}',
                    "# TYPE hst_healthy gauge",
                    f"hst_healthy {int(batcher.healthy())}",
                ]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                frame = _decode_image(body, self.headers.get("X-Raw-Shape"), staging)
            except Exception as e:  # malformed request: a client error
                self._json(400, {"error": str(e) or repr(e)})
                return
            try:
                fut = batcher.submit(frame)
            except ValueError as e:  # submit() rejected the frame: a client error
                self._json(400, {"error": str(e) or repr(e)})
                return
            except Exception as e:  # server stopped, queue fault
                self._json(503, {"error": str(e) or repr(e)})
                return
            try:
                probs = fut.result(timeout=timeout_s)
            except Exception as e:  # dispatch, device or timeout: a server fault
                self._json(503, {"error": str(e) or repr(e)})
                return
            idx = int(np.argmax(probs))
            self._json(
                200,
                {
                    "probs": [float(p) for p in probs],
                    "class": class_names[idx] if idx < len(class_names) else str(idx),
                    "prob": float(probs[idx]),
                },
            )

    return HTTPServer((host, port), Handler)


def serve_http(
    batcher,
    class_names: List[str],
    host: str = "127.0.0.1",
    port: int = 8000,
) -> ThreadingHTTPServer:
    """Start the HTTP server on a daemon thread; returns the server (call
    ``.shutdown()`` to stop)."""
    srv = make_http_server(batcher, class_names, host, port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
