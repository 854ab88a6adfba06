"""HTTP service — the MATLAB Production Server endpoint equivalent (the JAX
package's ``serve/http_service.py``), over the port's RadarService.

    POST /process   {"processAnimalActivity": "yes"|"no"}  → step-status JSON
                    (radar_processing_with_azure.m:95-99), HTTP 200 whatever
                    the outcome, 400 on a malformed body
    POST /classify  spectrogram image(s) → label + probability; body is raw
                    PNG/JPEG bytes (Content-Type: image/*) or JSON
                    {"image_b64": "..."} / {"images_b64": ["...", ...]}.
                    503 without a classifier, on a full queue or a timeout;
                    400 on a body or image that cannot be decoded; 500 when
                    the forward itself fails
    GET  /healthz   liveness + request counters (+ batching counters)
    GET  /          service info

One process holds one RadarService (pipelines reused across requests) and
at most one classifier, both on ``HandlerConfig.device``. The device is
one shared accelerator: /process runs and the batched /classify forwards
serialize on one lock. Concurrent /classify requests coalesce into one
bucketed batch (serve/batcher.py). Zero third-party dependencies beyond
the pipeline's own.

Repaired over the JAX service: a failure of the forward (a server fault)
answers 500, not 400, and /healthz reads every counter under its lock.
"""

from __future__ import annotations

import base64
import concurrent.futures
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fmcw_radar_processing_tpu_torch.serve.batcher import (
    ClassifyBatcher,
    QueueFullError,
)
from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig, RadarService
from fmcw_radar_processing_tpu_torch.utils.observe import log_event

CLASSIFY_TIMEOUT_S = 300.0


def _decode_body(headers, body: bytes) -> list[bytes]:
    """The image blobs of a /classify body; ValueError if there are none
    or the body cannot be decoded."""
    ctype = (headers.get("Content-Type") or "").split(";")[0]
    if ctype.startswith("image/"):
        blobs = [body]
    else:
        request = json.loads(body or b"{}")  # JSONDecodeError is a ValueError
        if not isinstance(request, dict):
            raise ValueError("request body must be a JSON object")
        try:  # binascii.Error is a ValueError
            if "images_b64" in request:
                blobs = [base64.b64decode(s) for s in request["images_b64"]]
            elif "image_b64" in request:
                blobs = [base64.b64decode(request["image_b64"])]
            else:
                raise ValueError(
                    "provide image bytes (Content-Type: image/*) or "
                    "JSON with image_b64 / images_b64")
        except TypeError as e:  # not a string
            raise ValueError(f"bad base64 field: {e}") from e
    if not blobs:
        raise ValueError("no images in request")
    return blobs


class _Handler(BaseHTTPRequestHandler):
    service: RadarService = None  # type: ignore[assignment]
    classifier = None  # SpectrogramClassifier | None
    batcher: ClassifyBatcher | None = None
    lock: threading.Lock = None  # type: ignore[assignment]
    stats: dict = None  # type: ignore[assignment]
    # Counter updates happen on worker threads; a dedicated lock (not the
    # accelerator lock, so counters never wait behind a chain run).
    stats_lock: threading.Lock = None  # type: ignore[assignment]

    def _count(self, error: bool = False) -> None:
        with self.stats_lock:
            self.stats["requests"] += 1
            if error:
                self.stats["errors"] += 1

    def _send(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, rejected: bool = False) -> None:
        """Answer a failed /classify (counted as an error, not a request)."""
        with self.stats_lock:
            self.stats["errors"] += 1
            if rejected:
                self.stats["rejected"] = self.stats.get("rejected", 0) + 1
        self._send(code, {"status": "error", "message": message})

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            with self.stats_lock:
                body = {"status": "ok", **self.stats}
            if self.batcher is not None:
                body["classify_batching"] = self.batcher.stats_snapshot()
            self._send(200, body)
        elif path == "/":
            endpoints = {"POST /process": "run the radar chain",
                         "GET /healthz": "liveness"}
            if self.classifier is not None:
                endpoints["POST /classify"] = (
                    "classify spectrogram image(s): "
                    f"classes {list(self.classifier.classes)}"
                )
            self._send(200, {
                "service": "fmcw-radar-processing-tpu-torch",
                "endpoints": endpoints,
            })
        else:
            self._send(404, {"status": "error", "message": "not found"})

    def do_POST(self) -> None:  # noqa: N802
        path = self.path.split("?", 1)[0]
        if path == "/classify":
            self._do_classify()
            return
        if path != "/process":
            self._send(404, {"status": "error", "message": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            request = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(request, dict):
                raise ValueError("request body must be a JSON object")
        except ValueError as e:  # json.JSONDecodeError is a ValueError
            self._send(400, {"status": "error",
                             "message": f"bad request: {e}"})
            return
        t0 = time.perf_counter()
        with self.lock:  # one chain run at a time on the device
            result = self.service.main(request)
        dt = round(time.perf_counter() - t0, 4)
        self._count(error=result.get("status") != "success")
        log_event("process_request", status=result.get("status"),
                  duration_s=dt, steps=len(result.get("steps", [])))
        # The reference's MPS endpoint returns its status JSON with HTTP 200
        # even on processing errors (the status field carries the outcome).
        self._send(200, result)

    def _do_classify(self) -> None:
        if self.classifier is None:
            self._send(503, {
                "status": "error",
                "message": "no classifier loaded "
                           "(start with serve --classifier-artifact DIR)",
            })
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            blobs = _decode_body(self.headers, self.rfile.read(n))
        except ValueError as e:
            self._send(400, {"status": "error", "message": f"bad request: {e}"})
            return
        t0 = time.perf_counter()
        try:
            # Decode on this request's thread (host work, concurrent); only
            # the device forward goes through the batcher.
            imgs = np.stack(
                [self.classifier.decode_image_bytes(b) for b in blobs])
            fut = self.batcher.submit(imgs)
        except QueueFullError as e:
            # Backpressure: the client backs off or tries another replica.
            self._error(503, f"overloaded: {e}", rejected=True)
            return
        except Exception as e:  # noqa: BLE001 — undecodable image, bad shape
            self._error(400, f"classification failed: {e}")
            return
        try:
            predictions = fut.result(timeout=CLASSIFY_TIMEOUT_S)
        except concurrent.futures.TimeoutError:
            # The queue did not reach this request in time: overload.
            self._error(503, "overloaded: classification timed out in queue")
            return
        except Exception as e:  # noqa: BLE001 — the forward failed: our fault
            self._error(500, f"classification failed: {e}")
            return
        dt = round(time.perf_counter() - t0, 4)
        self._count()
        log_event("classify_request", images=len(blobs), duration_s=dt)
        self._send(200, {
            "status": "success",
            "classes": list(self.classifier.classes),
            "predictions": predictions,
        })

    def log_message(self, fmt: str, *args) -> None:
        pass


class _Server(ThreadingHTTPServer):
    # socketserver's default backlog of 5 drops the connections of a burst
    # beyond it, and their clients retry only after a second.
    request_queue_size = 128


class RadarHttpService:
    """Threaded HTTP wrapper around RadarService; context-manager friendly.

    classifier / classifier_artifact: serve /classify with this classifier,
    or one loaded from this artifact directory onto ``config.device``; it is
    warmed at every batch bucket before the socket opens.
    """

    def __init__(self, config: HandlerConfig | None = None,
                 port: int = 8060, host: str = "127.0.0.1",
                 service: RadarService | None = None,
                 classifier=None, classifier_artifact: str | None = None,
                 classify_queue_images: int = 256):
        svc = service or RadarService(config)
        if classifier is None and classifier_artifact:
            from fmcw_radar_processing_tpu_torch.models.infer import (
                SpectrogramClassifier,
            )

            classifier = SpectrogramClassifier.load(classifier_artifact,
                                                    svc.config.device)
        accel_lock = threading.Lock()
        batcher = None
        if classifier is not None:
            if hasattr(classifier, "warmup"):
                classifier.warmup()
            batcher = ClassifyBatcher(classifier, accel_lock=accel_lock,
                                      max_queue_images=classify_queue_images)
        handler = type("Handler", (_Handler,), {
            "service": svc,
            "classifier": classifier,
            "batcher": batcher,
            "lock": accel_lock,
            "stats": {"requests": 0, "errors": 0},
            "stats_lock": threading.Lock(),
        })
        self.service = svc
        self.classifier = classifier
        self.batcher = batcher
        try:
            self.httpd = _Server((host, port), handler)
        except OSError:
            if batcher is not None:
                batcher.stop()
            raise
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self) -> "RadarHttpService":
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
        if self.batcher is not None:
            self.batcher.stop()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def __enter__(self) -> "RadarHttpService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
