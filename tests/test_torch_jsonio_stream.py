"""PyTorch port: ``utils/jsonio.py::write_json`` streams each large float
array from the native writer (``native/fmcw_json_stream.cpp``) straight
into the file, formatted on up to ``torch.get_num_threads()`` threads.

The file holds the same bytes as the JAX package's ``write_json`` and as
``dumps_matlab``, on one thread or two; where the native writer is missing
or fails partway, the file is rewritten whole through the Python path.
Under ``torch.profiler`` the service counts the streamed bytes as
``service.json_streamed_bytes``, which ``radarbench/metrics/
service.json_streamed_pct.py`` reads. Runs on the CPU.
"""

from __future__ import annotations

import importlib.util
import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fmcw_radar_processing_tpu.utils import jsonio as jjson
from fmcw_radar_processing_tpu_torch.config import RadarConfig, default_device_config
from fmcw_radar_processing_tpu_torch.io.raw_format import write_recording
from fmcw_radar_processing_tpu_torch.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu_torch.serve import handler as handler_mod
from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig, RadarService
from fmcw_radar_processing_tpu_torch.utils import jsonio as tjson
from fmcw_radar_processing_tpu_torch.utils import observe
from fmcw_radar_processing_tpu_torch.utils.observe import PROFILED

REPO = Path(__file__).resolve().parents[1]
SPECIALS = [np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, 1e-45, 1e-05, 1e+20,
            206.0, -1.5e-7, 1e16, 0.1, 123456789.0]
# Values a 4 MiB chunk holds at indent level 1, pretty: 4 MiB // 59.
CHUNK_VALUES = (4 << 20) // 59


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def _values(shape, dtype, seed=0):
    """Random values with every special value scattered through them."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(int(np.prod(shape))) * 40.0 - 60.0).astype(dtype)
    idx = rng.choice(a.size, size=min(a.size, 4 * len(SPECIALS)), replace=False)
    with np.errstate(over="ignore"):  # 1e+20 is inf in float16
        a[idx] = np.resize(np.array(SPECIALS, dtype), idx.size)
    return a.reshape(shape)


def _payload(arr):
    """A payload as the pipeline builds them: the array among scalar,
    string, nested and small-array fields."""
    return {"title": "Spectrogram", "values": arr, "count": 3,
            "nested": {"a": [1.5, float("nan")], "b": "c"},
            "small": np.array([1.0, np.nan, 2.5]), "last": -0.0}


def _field_text(value, pretty):
    """The value's text as the JAX package's writer renders a field."""
    prefix = '{\n  "k": ' if pretty else '{"k": '
    return jjson.dumps_matlab({"k": value}, pretty)[len(prefix):-(2 if pretty else 1)]


def _check_written(tmp_path, obj, pretty):
    """The port's file against the JAX package's and dumps_matlab; returns
    (bytes written, bytes streamed)."""
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    n, streamed = tjson.write_json_counts(str(ours), obj, pretty=pretty)
    jjson.write_json(str(theirs), obj, pretty=pretty)
    got = ours.read_bytes()
    assert got == theirs.read_bytes()
    assert got == tjson.dumps_matlab(obj, pretty).encode()
    assert n == ours.stat().st_size == len(got)
    assert tjson.write_json(str(ours), obj, pretty=pretty) == n
    return n, streamed


SHAPES = {"1d": (600,), "2d": (37, 29), "row": (1, 700), "column": (700, 1),
          "row_over_a_chunk": (3 * CHUNK_VALUES // 2,),
          "rows_over_a_chunk": (3, CHUNK_VALUES + 17)}


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("pretty", [True, False], ids=["pretty", "compact"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_streamed_write_is_byte_identical(tmp_path, shape, dtype, pretty, threads):
    """Every shape, dtype and layout: the JAX writer's bytes and
    dumps_matlab's, the count the file's size, the array's text streamed."""
    torch.set_num_threads(threads)
    arr = _values(SHAPES[shape], dtype)
    obj = _payload(arr)
    _, streamed = _check_written(tmp_path, obj, pretty)
    assert streamed == len(_field_text(arr, pretty))


@pytest.mark.parametrize("threads,pretty", [(1, True), (2, True), (2, False)])
def test_streamed_map_over_many_chunks(tmp_path, threads, pretty):
    """A 1,025 x 2,000 float32 map (rows not a multiple of the workers,
    tens of chunks) and its float64 axes, written as the spectrogram
    payload: the same bytes on one thread and two."""
    torch.set_num_threads(threads)
    obj = {"time": np.arange(2000) * 0.15, "frequency": np.linspace(0.0, 500.0, 1025),
           "intensity": _values((1025, 2000), np.float32, seed=3),
           "title": "All Frames - Log-Scaled Spectrogram",
           "xLabel": "Time (s)", "yLabel": "Frequency (Hz)"}
    n, streamed = _check_written(tmp_path, obj, pretty)
    assert streamed == sum(len(_field_text(obj[k], pretty))
                           for k in ("time", "frequency", "intensity"))
    assert n - streamed < 200


@pytest.mark.parametrize("obj", [
    {"small": np.arange(511.0), "s": "x"},
    {"ints": np.arange(4000), "s": "x"},
    {"cube": np.ones((4, 16, 16), np.float32)},
    {1: np.ones(600)},
    {},
], ids=["below_threshold", "ints", "three_dims", "int_key", "empty"])
def test_unstreamed_objects_keep_todays_path(tmp_path, obj):
    """Small arrays, ints, 3-D arrays, non-string keys and an empty dict
    take today's path: the same bytes, none streamed."""
    path = tmp_path / "a.json"
    n, streamed = tjson.write_json_counts(str(path), obj)
    assert streamed == 0
    assert path.read_bytes() == tjson.dumps_matlab(obj).encode()
    assert n == path.stat().st_size


def test_non_native_float_dtypes_stream_widened(tmp_path):
    """float16, big-endian and strided arrays stream as today's float64
    widening renders them."""
    obj = {"h": _values((700,), np.float16), "be": _values((20, 40), ">f4"),
           "t": _values((40, 30), np.float32).T}
    _, streamed = _check_written(tmp_path, obj, True)
    assert streamed > 0


def test_without_native_same_bytes(tmp_path, monkeypatch):
    """No native library: the pure-Python path writes the same bytes."""
    obj = _payload(_values((30, 40), np.float32))
    want = tjson.dumps_matlab(obj).encode()
    monkeypatch.setattr(tjson, "_get_native", lambda: None)
    path = tmp_path / "a.json"
    assert tjson.write_json_counts(str(path), obj) == (len(want), 0)
    assert path.read_bytes() == want


class _FailingStream:
    """The native library, whose streaming writer fails at its ``fail_at``-th
    call after writing part of the text to the descriptor."""

    def __init__(self, lib, fail_at):
        self.lib, self.fail_at, self.calls = lib, fail_at, 0

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def fmcw_json_stream(self, data, itemsize, rows, cols, pretty, level, fd, threads):
        self.calls += 1
        if self.calls < self.fail_at:
            return self.lib.fmcw_json_stream(data, itemsize, rows, cols, pretty,
                                             level, fd, threads)
        os.write(fd, b"[\n    1.5,\n    partial")
        return -1


@pytest.mark.parametrize("fail_at", [1, 2])
@pytest.mark.parametrize("threads", [1, 2])
def test_native_failure_rewrites_whole_file(tmp_path, monkeypatch, fail_at, threads):
    """The native writer failing partway (on the first array or the second,
    after the first streamed): the file is rewritten whole, the same bytes,
    none counted as streamed."""
    torch.set_num_threads(threads)
    obj = {"a": _values((50, 60), np.float32), "mid": "x",
           "b": _values((900,), np.float64), "end": 1}
    want = tjson.dumps_matlab(obj).encode()
    lib = tjson._get_native()
    assert lib is not None
    proxy = _FailingStream(lib, fail_at)
    monkeypatch.setattr(tjson, "_get_native", lambda: proxy)
    path = tmp_path / "a.json"
    path.write_bytes(b"x" * (2 * len(want)))  # an older, longer artifact
    assert tjson.write_json_counts(str(path), obj) == (len(want), 0)
    assert proxy.calls == fail_at
    assert path.read_bytes() == want


@pytest.mark.parametrize("threads", [1, 3])
def test_native_writer_reports_a_failed_write(threads):
    """A pipe with no reader: the native writer returns -1 on any thread
    count, and returns (no worker left waiting)."""
    lib = tjson._get_native()
    assert lib is not None
    arr = _values((40, 3 * CHUNK_VALUES // 40), np.float32)
    r, w = os.pipe()
    os.close(r)
    result = []
    t = threading.Thread(target=lambda: result.append(lib.fmcw_json_stream(
        arr.ctypes.data, 4, arr.shape[0], arr.shape[1], 1, 1, w, threads)))
    try:
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert result == [-1]
    finally:
        os.close(w)
    assert lib.fmcw_json_stream(arr.ctypes.data, 2, 4, 0, 1, 1, 1, 1) == -1


# --- the service's counter and its reader --------------------------------------


def _reader():
    path = REPO / "radarbench" / "metrics" / "service.json_streamed_pct.py"
    spec = importlib.util.spec_from_file_location("metric_json_streamed_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_service_counts_the_streamed_bytes(tmp_path, monkeypatch):
    """Under torch.profiler, RadarService.main on the CPU counts as
    service.json_streamed_bytes the bytes of the arrays the native writer
    streamed into its four artifacts; service.json_streamed_pct reads 100
    x that over service.json_bytes, and None without the counter."""
    cfg = RadarConfig.create(default_device_config())
    blobs, work = tmp_path / "blobs", tmp_path / "work"
    blobs.mkdir()
    work.mkdir()
    targets = (SyntheticTarget(range_m=7.5, doppler_bin_offset=3),)
    write_recording(str(blobs / "radar_data"), synthesize_recording(cfg, 64, targets, seed=64))
    written = []
    counts = tjson.write_json_counts

    def recorded(path, obj, pretty=True):
        out = counts(path, obj, pretty)
        written.append((obj, pretty, out))
        return out

    monkeypatch.setattr(handler_mod, "write_json_counts", recorded)
    monkeypatch.setattr(observe, "_unprofiled_span_since", True)
    torch.set_num_threads(2)
    service = RadarService(HandlerConfig(workdir=str(work), storage_spec=f"local:{blobs}",
                                         device="cpu"))
    read = _reader()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert service.main({"processAnimalActivity": "no"})["status"] == "success"
        want = sum(len(_field_text(v, pretty)) for obj, pretty, _ in written
                   for v in obj.values() if tjson._native_operand(v) is not None)
        assert len(written) == 4 and want > 0
        assert sum(out[1] for *_, out in written) == want
        assert PROFILED.records["service.json_streamed_bytes"].items == want
        total = PROFILED.records["service.json_bytes"].items
        assert total == sum(p.stat().st_size for p in blobs.glob("*.json"))
        assert read({}) == pytest.approx(100.0 * want / total, rel=1e-12)
        del PROFILED.records["service.json_streamed_bytes"]
        assert read({}) is None
    finally:
        PROFILED.records.clear()


def test_streamed_share_metric_is_declared():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    assert declared["service.json_streamed_pct"] == {
        "name": "service.json_streamed_pct", "unit": "%", "better": "higher",
        "source": "program_span", "layer": "service",
        "moves": "recording_frames_per_s", "workloads": ["service-1k.process"]}
