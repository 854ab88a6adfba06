"""PyTorch port: the HTTP service, the /classify batcher, the dashboard and
the CLI's service commands, held to the JAX service's contract.

The JAX batcher tests (tests/test_batcher.py) and HTTP tests
(tests/test_http_service.py, tests/test_infer.py, tests/test_dashboard.py)
run here against the port, on the CPU, plus one test for each repair the
port makes over the JAX service: a dispatcher that survives a batch whose
images do not stack, per-request shape checks, ``stop()`` failing queued
requests exactly once, /healthz reading consistent counters, and a failed
forward answered 500. Every wait on a future or a socket has a timeout.
"""

import base64
import concurrent.futures
import io
import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.config import RadarConfig, default_device_config
from fmcw_radar_processing_tpu.io.raw_format import write_recording
from fmcw_radar_processing_tpu.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu.serve.cli import main as jax_cli_main
from fmcw_radar_processing_tpu_torch.models.infer import export_classifier
from fmcw_radar_processing_tpu_torch.models.params import state_dict_to_flax
from fmcw_radar_processing_tpu_torch.models.vgg import build_model, init_flax_default_
from fmcw_radar_processing_tpu_torch.serve.batcher import (
    ClassifyBatcher,
    QueueFullError,
)
from fmcw_radar_processing_tpu_torch.serve.cli import main as cli_main
from fmcw_radar_processing_tpu_torch.serve.dashboard import (
    DashboardServer,
    build_manifest,
)
from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig
from fmcw_radar_processing_tpu_torch.serve.http_service import RadarHttpService

REPO = Path(__file__).resolve().parent.parent
SHAPE = (16, 16, 3)
CLASSES = ("calf", "human")


class _FakeClassifier:
    """Deterministic per-image 'prediction' + recorded batch sizes; refuses
    images that are not 4×4×3, as a real classifier refuses a wrong shape."""

    classes = ("a", "b")

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s
        self.batch_sizes: list[int] = []
        self._mu = threading.Lock()

    def classify(self, images):
        images = np.asarray(images)
        if images.shape[1:] != (4, 4, 3):
            raise ValueError(f"expected images of shape (4, 4, 3), got "
                             f"{images.shape[1:]}")
        with self._mu:
            self.batch_sizes.append(len(images))
        if self.delay_s:
            time.sleep(self.delay_s)
        # Identity fingerprint so each request can check it got ITS rows.
        return [{"label": "a", "score": float(img[0, 0, 0])} for img in images]


def _img(v, shape=(4, 4, 3)):
    return np.full(shape, v, np.float32)


# --------------------------- the batcher (JAX tests) ---------------------------


def test_single_request_passthrough():
    clf = _FakeClassifier()
    b = ClassifyBatcher(clf)
    try:
        out = b.classify(np.stack([_img(0.25), _img(0.5)]), timeout=10)
        assert [r["score"] for r in out] == [0.25, 0.5]
        assert clf.batch_sizes == [2]
    finally:
        b.stop()


def test_concurrent_requests_coalesce():
    clf = _FakeClassifier(delay_s=0.15)
    b = ClassifyBatcher(clf)
    try:
        vals = [i / 16.0 for i in range(8)]
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(b.classify, _img(v), 30) for v in vals]
            results = [f.result(timeout=30) for f in futs]
        for v, out in zip(vals, results):
            assert len(out) == 1 and out[0]["score"] == pytest.approx(v)
        assert len(clf.batch_sizes) < 8
        assert max(clf.batch_sizes) > 1
        assert sum(clf.batch_sizes) == 8
        assert b.stats_snapshot()["max_batch"] == max(clf.batch_sizes)
    finally:
        b.stop()


def test_queue_full_raises():
    clf = _FakeClassifier(delay_s=0.3)
    b = ClassifyBatcher(clf, max_queue_images=2)
    try:
        first = b.submit(_img(0.1))  # dispatches immediately
        time.sleep(0.05)  # let the dispatcher pick it up
        b.submit(np.stack([_img(0.2), _img(0.3)]))  # fills the queue
        with pytest.raises(QueueFullError):
            b.submit(_img(0.4))
        assert b.stats_snapshot()["rejected"] == 1
        assert first.result(timeout=10)[0]["score"] == pytest.approx(0.1)
    finally:
        b.stop()


def test_oversized_request_admitted_when_idle():
    clf = _FakeClassifier()
    b = ClassifyBatcher(clf, max_queue_images=2)
    try:
        out = b.classify(np.stack([_img(i / 8.0) for i in range(5)]), timeout=30)
        assert [r["score"] for r in out] == pytest.approx(
            [i / 8.0 for i in range(5)])
    finally:
        b.stop()


def test_error_propagates_per_request():
    class Boom(_FakeClassifier):
        def classify(self, images):
            raise RuntimeError("device on fire")

    b = ClassifyBatcher(Boom())
    try:
        with pytest.raises(RuntimeError, match="on fire"):
            b.classify(_img(0.5), timeout=10)
        with pytest.raises(RuntimeError, match="on fire"):  # still serving
            b.classify(_img(0.5), timeout=10)
    finally:
        b.stop()


# --------------------------- the batcher's repairs ---------------------------


def test_dispatcher_survives_images_that_do_not_stack():
    """Two requests of different image shapes coalesce into one batch. The
    JAX dispatcher dies in np.concatenate and every later request hangs;
    here the odd request gets its own error and the others their results."""
    clf = _FakeClassifier(delay_s=0.2)
    b = ClassifyBatcher(clf)  # the fake has no input_shape: submit admits all
    try:
        first = b.submit(_img(0.1))
        time.sleep(0.05)  # the dispatcher is busy with `first`
        good = b.submit(_img(0.2))
        odd = b.submit(_img(0.3, shape=(5, 5, 3)))
        assert first.result(timeout=10)[0]["score"] == pytest.approx(0.1)
        assert good.result(timeout=10)[0]["score"] == pytest.approx(0.2)
        with pytest.raises(ValueError, match="expected images of shape"):
            odd.result(timeout=10)
        later = b.classify(_img(0.4), timeout=10)
        assert later[0]["score"] == pytest.approx(0.4)
        assert b._thread.is_alive()
    finally:
        b.stop()


def test_submit_rejects_wrong_shape_per_request():
    class Shaped(_FakeClassifier):
        input_shape = (4, 4, 3)

    b = ClassifyBatcher(Shaped())
    try:
        with pytest.raises(ValueError, match="expected images of shape"):
            b.submit(_img(0.3, shape=(5, 5, 3)))
        assert b.classify(_img(0.6), timeout=10)[0]["score"] == pytest.approx(0.6)
    finally:
        b.stop()


def test_stop_fails_queued_requests_once():
    clf = _FakeClassifier(delay_s=0.3)
    b = ClassifyBatcher(clf)
    first = b.submit(_img(0.1))
    time.sleep(0.05)  # in flight
    queued = [b.submit(_img(0.2 + i / 10)) for i in range(3)]
    b.stop()
    assert not b._thread.is_alive()
    assert first.result(timeout=10)[0]["score"] == pytest.approx(0.1)
    for fut in queued:
        with pytest.raises(RuntimeError, match="batcher stopped"):
            fut.result(timeout=10)
    assert clf.batch_sizes == [1]  # nothing queued was also served
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(_img(0.5))


def test_stats_snapshot_is_consistent_under_load():
    """Readers racing the dispatcher never see a half-updated batch: every
    snapshot has batched_images ≥ batches (each batch holds ≥ 1 image)."""
    clf = _FakeClassifier()
    b = ClassifyBatcher(clf, max_queue_images=10_000)
    bad: list[dict] = []
    done = threading.Event()

    def read():
        while not done.is_set():
            s = b.stats_snapshot()
            if s["batched_images"] < s["batches"] or s["max_batch"] > s["batched_images"]:
                bad.append(s)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        readers = [threading.Thread(target=read) for _ in range(4)]
        for t in readers:
            t.start()
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            futs = [ex.submit(b.classify, _img(i / 400), 30) for i in range(400)]
            assert all(len(f.result(timeout=30)) == 1 for f in futs)
    finally:
        done.set()
        sys.setswitchinterval(old)
        for t in readers:
            t.join(timeout=10)
        b.stop()
    assert not any(t.is_alive() for t in readers)
    assert not bad, bad[:3]
    assert b.stats_snapshot()["batched_images"] == 400


# --------------------------- HTTP: /process ---------------------------


def _post(url, data, ctype="application/json", timeout=120):
    if not isinstance(data, bytes):
        data = json.dumps(data).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


@pytest.fixture
def service(tmp_path):
    """Service over local 'blob' storage holding a small synthetic recording,
    running the port on the CPU."""
    cfg = RadarConfig.create(default_device_config())
    rec = synthesize_recording(
        cfg, 12, (SyntheticTarget(range_m=6.0, doppler_bin_offset=2),), seed=0)
    blob = tmp_path / "blob"
    blob.mkdir()
    write_recording(str(blob / "radar_data"), rec)
    work = tmp_path / "work"
    work.mkdir()
    hc = HandlerConfig(fdata="radar_data", workdir=str(work),
                       storage_spec=f"local:{blob}", device="cpu")
    with RadarHttpService(hc, port=0) as srv:
        yield srv, blob, work


def test_process_request_contract(service):
    srv, blob, work = service
    st, res = _post(srv.url + "process", {"processAnimalActivity": "no"})
    assert st == 200 and res["status"] == "success"
    assert [s["step"] for s in res["steps"]] == [
        "Read Files", "Radar Processing", "Upload JSON"]
    assert all(s["status"] == "success" for s in res["steps"])
    uploaded = {p.name for p in blob.iterdir()}
    assert {"spectrogram_data.json", "radar_data_range_speed_data.json",
            "spectrogram.png"} <= uploaded
    st, health = _get(srv.url + "healthz")
    assert st == 200 and health["requests"] == 1 and health["errors"] == 0
    # The dashboard over the same workdir lists what /process wrote.
    man = build_manifest(str(work))
    assert man["name"] == "radar_data" and man["png"] == "spectrogram.png"
    assert None not in (man["spectrogram"], man["range_fft"],
                        man["range_speed"], man["fft_snapshot"])


def test_service_reuses_pipeline_across_concurrent_requests(service):
    srv, _, _ = service
    # A burst of connections fits the listen backlog (socketserver's 5
    # would drop some, and their clients retry a second later).
    assert srv.httpd.request_queue_size >= 64
    _post(srv.url + "process", {})
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        results = [f.result(timeout=120) for f in
                   [ex.submit(_post, srv.url + "process",
                              {"processAnimalActivity": "no"}) for _ in range(4)]]
    assert all(st == 200 and res["status"] == "success" for st, res in results)
    assert len(srv.service._pipelines) == 1
    _, health = _get(srv.url + "healthz")
    assert health["requests"] == 5 and health["errors"] == 0


def test_bad_requests(service):
    srv, _, _ = service
    st, res = _post(srv.url + "process", b"{not json")
    assert st == 400 and res["status"] == "error"
    st, _ = _post(srv.url + "process", b"[1,2]")
    assert st == 400
    st, _ = _post(srv.url + "nope", {})
    assert st == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.url + "nope")
    assert e.value.code == 404
    st, info = _get(srv.url)
    assert st == 200 and "POST /classify" not in info["endpoints"]
    # No classifier: /classify answers 503.
    st, res = _post(srv.url + "classify", b"{}")
    assert st == 503 and "no classifier loaded" in res["message"]


def test_processing_error_reported_in_steps(tmp_path):
    hc = HandlerConfig(fdata="missing", workdir=str(tmp_path),
                       storage_spec=f"local:{tmp_path / 'empty-blob'}", device="cpu")
    with RadarHttpService(hc, port=0) as srv:
        st, res = _post(srv.url + "process", {})
        assert st == 200 and res["status"] == "error"
        assert res["steps"][-1]["status"] == "error"
        _, health = _get(srv.url + "healthz")
        assert health["errors"] == 1


# --------------------------- HTTP: /classify ---------------------------


def _png_bytes(img01):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((np.asarray(img01) * 255).astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A SmallCNN with Flax's default initialization from a seeded
    generator, exported as an inference artifact."""
    model = init_flax_default_(build_model("small", SHAPE),
                               torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("clf") / "artifact")
    export_classifier(path, "small", state_dict_to_flax(model.state_dict()),
                      SHAPE, CLASSES)
    return path


@pytest.fixture
def classify_service(artifact, tmp_path):
    hc = HandlerConfig(workdir=str(tmp_path), storage_spec=f"local:{tmp_path}",
                       device="cpu")
    with RadarHttpService(hc, port=0, classifier_artifact=artifact) as srv:
        yield srv


def test_classify_raw_png_and_json_batch(classify_service):
    srv = classify_service
    rng = np.random.default_rng(4)
    imgs = rng.uniform(0, 1, (3, 24, 20, 3))
    st, res = _post(srv.url + "classify", _png_bytes(imgs[0]), ctype="image/png")
    assert st == 200 and res["status"] == "success"
    assert res["classes"] == list(CLASSES)
    (pred,) = res["predictions"]
    assert pred["label"] in CLASSES and 0.0 <= pred["score"] <= 1.0
    blobs = [_png_bytes(im) for im in imgs]
    body = json.dumps({"images_b64": [base64.b64encode(b).decode()
                                      for b in blobs]}).encode()
    st, res = _post(srv.url + "classify", body)
    assert st == 200 and len(res["predictions"]) == 3
    direct = srv.classifier.classify_bytes(blobs)
    for a, b in zip(res["predictions"], direct):
        assert a["label"] == b["label"] and abs(a["score"] - b["score"]) < 1e-5
    st, res = _post(srv.url + "classify", json.dumps(
        {"image_b64": base64.b64encode(blobs[1]).decode()}).encode())
    assert st == 200 and res["predictions"][0] == direct[1]
    st, info = _get(srv.url)
    assert "POST /classify" in info["endpoints"]
    st, health = _get(srv.url + "healthz")
    assert health["requests"] == 3
    assert health["classify_batching"]["batched_images"] == 5


def test_classify_bad_requests(classify_service):
    srv = classify_service
    st, res = _post(srv.url + "classify", b"{not json")
    assert st == 400 and res["status"] == "error"
    st, _ = _post(srv.url + "classify", json.dumps({}).encode())
    assert st == 400
    st, _ = _post(srv.url + "classify", json.dumps({"images_b64": []}).encode())
    assert st == 400
    st, _ = _post(srv.url + "classify", json.dumps({"images_b64": [3]}).encode())
    assert st == 400
    st, res = _post(srv.url + "classify", json.dumps(
        {"image_b64": base64.b64encode(b"junk").decode()}).encode())
    assert st == 400 and "classification failed" in res["message"]
    _, health = _get(srv.url + "healthz")
    assert health["errors"] == 1 and health["requests"] == 0


class _HttpFake(_FakeClassifier):
    input_shape = (4, 4, 3)

    def decode_image_bytes(self, data):
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            im = im.convert("RGB").resize((4, 4), Image.BILINEAR)
            return np.asarray(im, np.float32) / 255.0


def test_classify_server_fault_is_500(tmp_path):
    """A failed forward is the server's fault: 500, where the JAX service
    answers 400."""
    class Broken(_HttpFake):
        def classify(self, images):
            raise RuntimeError("CUDA error: an illegal memory access")

    hc = HandlerConfig(workdir=str(tmp_path), storage_spec=f"local:{tmp_path}",
                       device="cpu")
    with RadarHttpService(hc, port=0, classifier=Broken()) as srv:
        st, res = _post(srv.url + "classify", _png_bytes(np.full((8, 8, 3), 0.5)),
                        ctype="image/png", timeout=30)
        assert st == 500 and "illegal memory access" in res["message"]
        _, health = _get(srv.url + "healthz")
        assert health["errors"] == 1


def test_http_queue_depth_backpressure(tmp_path):
    """Under a 12-way burst with queue bound 2, some requests get 503 while
    the served ones coalesce; /healthz reports the batching counters."""
    hc = HandlerConfig(workdir=str(tmp_path), storage_spec=f"local:{tmp_path}",
                       device="cpu")
    clf = _HttpFake(delay_s=0.25)
    png = _png_bytes(np.full((8, 8, 3), 0.5))
    with RadarHttpService(hc, port=0, classifier=clf,
                          classify_queue_images=2) as srv:
        with concurrent.futures.ThreadPoolExecutor(12) as ex:
            futs = [ex.submit(_post, srv.url + "classify", png, "image/png", 60)
                    for _ in range(12)]
            codes = [f.result(timeout=60)[0] for f in futs]
        assert codes.count(200) >= 1 and codes.count(503) >= 1
        assert codes.count(200) + codes.count(503) == 12
        _, health = _get(srv.url + "healthz")
    cb = health["classify_batching"]
    assert cb["batches"] >= 1 and cb["rejected"] >= 1
    assert cb["batched_images"] == codes.count(200) == health["requests"]
    assert health["rejected"] == codes.count(503)


# --------------------------- dashboard ---------------------------


@pytest.fixture
def payload_dir(tmp_path):
    files = {
        "spectrogram_data.json": {"time": [0.1], "frequency": [1.0],
                                  "intensity": [[-3.0]]},
        "rec_range_fft_data.json": {"time_axis": [0.0], "filename": "rec"},
        "rec_range_speed_data.json": {"range": [[1.5]], "filename": "rec"},
        "rec_fft_data.json": {"frame_index": 1, "filename": "rec"},
        "rec_spectrogram_batch_1.json": {"time": []},
    }
    for name, payload in files.items():
        (tmp_path / name).write_text(json.dumps(payload))
    (tmp_path / "spectrogram.png").write_bytes(b"\x89PNG\r\n\x1a\nfake")
    return str(tmp_path)


def test_dashboard_manifest(payload_dir, tmp_path):
    from fmcw_radar_processing_tpu.serve.dashboard import (
        build_manifest as jax_build_manifest,
    )

    man = build_manifest(payload_dir)
    assert man == jax_build_manifest(payload_dir)
    assert man["name"] == "rec" and man["batches"] == ["rec_spectrogram_batch_1.json"]
    assert build_manifest(str(tmp_path / "missing"))["range_fft"] is None


def _get_raw(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read(), r.headers.get("Content-Type", "")


def test_dashboard_routes_and_traversal(payload_dir, tmp_path):
    secret = tmp_path.parent / "secret.txt"
    secret.write_text("private")
    with DashboardServer(payload_dir, port=0) as srv:
        st, body, ct = _get_raw(srv.url)
        assert st == 200 and b"FMCW Radar Monitoring" in body and "text/html" in ct
        st, body, _ = _get_raw(srv.url + "api/manifest")
        assert st == 200 and json.loads(body)["name"] == "rec"
        st, body, ct = _get_raw(srv.url + "data/rec_fft_data.json")
        assert json.loads(body)["frame_index"] == 1 and ct == "application/json"
        st, body, ct = _get_raw(srv.url + "data/spectrogram.png")
        assert body.startswith(b"\x89PNG") and ct == "image/png"
        for path in ("data/nope.json", "bogus", "data/../secret.txt",
                     "data/..%2fsecret.txt"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get_raw(srv.url + path)
            assert e.value.code == 404, path


def test_dashboard_page_is_the_jax_page():
    name = "serve/dashboard_static/index.html"
    port = (REPO / "fmcw_radar_processing_tpu_torch" / name).read_bytes()
    assert port == (REPO / "fmcw_radar_processing_tpu" / name).read_bytes()


# --------------------------- CLI ---------------------------


def test_cli_config_equals_jax(tmp_path, capsys):
    cfg = RadarConfig.create(default_device_config())
    rec = synthesize_recording(cfg, 2, (SyntheticTarget(range_m=6.0),), seed=0)
    xml, _ = write_recording(str(tmp_path / "rec"), rec)
    assert cli_main(["config", xml]) == 0
    got = capsys.readouterr().out
    assert jax_cli_main(["config", xml]) == 0
    assert got == capsys.readouterr().out
    assert json.loads(got)


def test_cli_serve_and_dashboard_bind_errors(tmp_path, capsys):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        port = str(s.getsockname()[1])
        assert cli_main(["serve", "--device", "cpu", "--port", port,
                         "--workdir", str(tmp_path),
                         "--storage", f"local:{tmp_path}"]) == 1
        assert cli_main(["dashboard", str(tmp_path), "--port", port]) == 1
    assert capsys.readouterr().err.count("cannot bind") == 2
    assert cli_main(["serve", "--device", "cpu", "--port", "0",
                     "--classifier-artifact", str(tmp_path / "none"),
                     "--storage", f"local:{tmp_path}"]) == 1
    assert "not a classifier artifact" in capsys.readouterr().err


def test_cli_classify(artifact, tmp_path, capsys):
    paths = []
    for i in range(2):
        p = tmp_path / f"{i}.png"
        p.write_bytes(_png_bytes(np.full((20, 20, 3), 0.2 + 0.5 * i)))
        paths.append(str(p))
    assert cli_main(["classify", "--device", "cpu", "--artifact", artifact,
                     *paths]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["classes"] == list(CLASSES)
    assert [r["file"] for r in out["predictions"]] == paths
    assert cli_main(["classify", "--device", "cpu", "--artifact",
                     str(tmp_path / "none"), *paths]) == 1
