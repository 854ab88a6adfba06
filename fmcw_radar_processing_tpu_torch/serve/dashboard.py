"""Monitoring dashboard: stdlib HTTP server over a payload directory (the
JAX package's ``serve/dashboard.py``).

The reference's presentation layer is a Next.js dashboard consuming the
JSON payloads from blob storage (SURVEY §1 L7; README.md:22,46-47). This
is its dependency-free equivalent: a static page
(serve/dashboard_static/index.html, a copy of the JAX package's, vanilla
JS + canvas/SVG) served next to the payload files the pipeline wrote, with
a manifest endpoint that maps the four reference schemas
(radar_processing.m:306-436) to dashboard panels. Nothing here touches
the device.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_STATIC_DIR = os.path.join(os.path.dirname(__file__), "dashboard_static")


def build_manifest(data_dir: str) -> dict:
    """Classify the payload files in data_dir by reference schema.

    Recognizes (SURVEY §2.1 "JSON writers"):
      spectrogram_data.json / <n>_spectrogram_batch_<b>.json,
      <n>_range_fft_data.json, <n>_range_speed_data.json, <n>_fft_data.json,
      spectrogram.png.
    """
    man: dict = {"name": None, "spectrogram": None, "range_fft": None,
                 "range_speed": None, "fft_snapshot": None, "png": None,
                 "batches": []}
    try:
        names = sorted(os.listdir(data_dir))
    except OSError:
        return man
    for n in names:
        if n == "spectrogram_data.json":
            man["spectrogram"] = n
        elif n.endswith("_range_fft_data.json"):
            man["range_fft"] = n
            man["name"] = n[: -len("_range_fft_data.json")]
        elif n.endswith("_range_speed_data.json"):
            man["range_speed"] = n
        elif n.endswith("_fft_data.json"):
            man["fft_snapshot"] = n
        elif n == "spectrogram.png":
            man["png"] = n
        elif "_spectrogram_batch_" in n and n.endswith(".json"):
            man["batches"].append(n)
            if man["name"] is None:
                man["name"] = n.split("_spectrogram_batch_")[0]
    return man


class _Handler(BaseHTTPRequestHandler):
    data_dir = "."

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path in ("/", "/index.html"):
            with open(os.path.join(_STATIC_DIR, "index.html"), "rb") as f:
                self._send(200, f.read(), "text/html; charset=utf-8")
        elif path == "/api/manifest":
            body = json.dumps(build_manifest(self.data_dir)).encode()
            self._send(200, body, "application/json")
        elif path.startswith("/data/"):
            name = os.path.basename(path[len("/data/"):])  # no traversal
            full = os.path.join(self.data_dir, name)
            if not os.path.isfile(full):
                self._send(404, b"not found", "text/plain")
                return
            ctype = ("image/png" if name.endswith(".png")
                     else "application/json" if name.endswith(".json")
                     else "application/octet-stream")
            with open(full, "rb") as f:
                self._send(200, f.read(), ctype)
        else:
            self._send(404, b"not found", "text/plain")

    def log_message(self, fmt: str, *args) -> None:  # quiet by default
        pass


class DashboardServer:
    """Threaded dashboard server; context-manager friendly."""

    def __init__(self, data_dir: str, port: int = 8050, host: str = "127.0.0.1"):
        handler = type("Handler", (_Handler,), {"data_dir": data_dir})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self) -> "DashboardServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def __enter__(self) -> "DashboardServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
