"""PyTorch port: spans on the profiler's clock (utils/observe.py::span) and
the collector that the benchmark's span metrics read.

Without a profiler a span opens no ``record_function``, syncs nothing and
leaves the collector alone; under ``torch.profiler`` it is a
``user_annotation`` event of its name in the Chrome trace, with host
seconds and a count in ``PROFILED``. The recording and streaming paths
record each of their spans as often as the work runs and give the same
results with the profiler on as off; a ``/process`` request served on the
HTTP server's own thread records the service's spans and counter. Runs
on the CPU; the ``cuda`` tests check on the card that a window with device-resident inputs makes
no host synchronization, and that the CLI's ``process --trace-dir`` trace
names K1a's kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fmcw_radar_processing_tpu_torch.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.io.raw_format import write_recording
from fmcw_radar_processing_tpu_torch.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor
from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig, RadarService
from fmcw_radar_processing_tpu_torch.serve.http_service import RadarHttpService
from fmcw_radar_processing_tpu_torch.utils import observe
from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair
from fmcw_radar_processing_tpu_torch.utils.observe import PROFILED, StageTimer, count, span

REPO = Path(__file__).resolve().parents[1]
RECORDING_SPANS = ("recording.upload", "recording.chain_wait",
                   "recording.decode_copy", "recording.decode_widen")
STAGES = ("frame_chain", "stft", "host_decode", "payload_build")
METRICS = {  # reader (radarbench/metrics/<name>.py) -> the span it reads
    "recording.upload_host_ms": "recording.upload",
    "recording.chain_wait_ms": "recording.chain_wait",
    "recording.decode_copy_ms": "recording.decode_copy",
    "recording.decode_widen_ms": "recording.decode_widen",
    "stream.upload_host_ms": "stream.upload",
    "stream.chain_dispatch_ms": "stream.chain",
    "stream.stft_dispatch_ms": "stream.stft",
    "service.download_ms": "service.download",
    "service.load_ms": "service.load",
    "service.pipeline_ms": "service.pipeline",
    "service.json_ms": "service.json",
    "service.png_ms": "service.png",
    "service.store_ms": "service.store",
}
SERVICE_SPANS = {"service.download": 1, "service.load": 1, "service.pipeline": 1,
                 "service.json": 4, "service.png": 1, "service.store": 5}
RECORDING_CELLS = ["production-65k.recording", "fidelity-1k.recording"]
SERVICE_CELL = "service-1k.process"
DAY_CELL = "production-576k.recording"
COLLECTOR_READERS = {  # reader -> (records added, name by name, and its reading)
    **{m: ([(name, 0.25, None), (name, 0.75, None)], 1e3 * 1.0 / 4)
       for m, name in METRICS.items()},
    # bytes over the copy span's seconds; the span alone (a program
    # without the counter) reads None
    "recording.decode_copy_gbps": ([("recording.decode_copy", 0.25, None),
                                    ("recording.decode_copy", 0.75, None),
                                    ("recording.decode_copy_bytes", 0.0, 3 * 10**9),
                                    ("recording.decode_copy_bytes", 0.0, 10**9)], 4.0),
    # 100 × the page-locked bytes over the bytes copied; the copied bytes
    # alone (a program without the pinned counter) read None
    "recording.decode_pinned_pct": ([("recording.decode_copy_bytes", 0.0, 3 * 10**9),
                                     ("recording.decode_copy_bytes", 0.0, 10**9),
                                     ("recording.decode_pinned_bytes", 0.0, 2 * 10**9),
                                     ("recording.decode_pinned_bytes", 0.0, 10**9)], 75.0),
    # 100 × the host blocks' page-locked bytes over the bytes copied; the
    # copied bytes alone (a program without the block counter) read None
    "recording.decode_host_alloc_pct": ([("recording.decode_copy_bytes", 0.0, 3 * 10**9),
                                         ("recording.decode_copy_bytes", 0.0, 10**9),
                                         ("recording.decode_host_alloc_bytes", 0.0,
                                          3 * 10**9),
                                         ("recording.decode_host_alloc_bytes", 0.0,
                                          10**9 + 2 * 4096)], 100.0 + 2.048e-4),
    # the read-back's device slots per recording in MB (4 items)
    "recording.decode_scratch_mb": ([("recording.decode_scratch_bytes", 0.0, 2 * 10**8),
                                     ("recording.decode_scratch_bytes", 0.0, 2 * 10**8)],
                                    100.0),
    # the raw's bytes over the upload span's seconds; the span alone (a
    # program without the counter) reads None
    "recording.upload_gbps": ([("recording.upload", 0.25, None),
                               ("recording.upload", 0.75, None),
                               ("recording.upload_bytes", 0.0, 6 * 10**9),
                               ("recording.upload_bytes", 0.0, 2 * 10**9)], 8.0),
    # 100 × the staged bytes over the uploaded bytes; the uploaded bytes
    # alone (a program without the staging counter) read None
    "recording.upload_staged_pct": ([("recording.upload_bytes", 0.0, 3 * 10**9),
                                     ("recording.upload_bytes", 0.0, 10**9),
                                     ("recording.upload_staged_bytes", 0.0, 0),
                                     ("recording.upload_staged_bytes", 0.0, 10**9)], 25.0),
    # the JSON artifacts' bytes over the writer span's seconds; the span
    # alone (a program without the counter) reads None
    "service.json_gbps": ([("service.json", 0.25, None), ("service.json", 0.75, None),
                           ("service.json_bytes", 0.0, 3 * 10**9),
                           ("service.json_bytes", 0.0, 10**9)], 4.0),
    # 100 × the natively streamed bytes over the JSON artifacts' bytes; the
    # JSON bytes alone (a program without the streaming counter) read None
    "service.json_streamed_pct": ([("service.json_bytes", 0.0, 3 * 10**9),
                                   ("service.json_bytes", 0.0, 10**9),
                                   ("service.json_streamed_bytes", 0.0, 0),
                                   ("service.json_streamed_bytes", 0.0, 3 * 10**9)], 75.0),
}
STORE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
TARGETS = (SyntheticTarget(range_m=7.5, doppler_bin_offset=3),
           SyntheticTarget(range_m=16.9, doppler_bin_offset=-2))


@pytest.fixture(autouse=True)
def _fresh_collector(monkeypatch):
    """One torch thread, and the collector as a new process finds it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    PROFILED.records.clear()
    monkeypatch.setattr(observe, "_unprofiled_span_since", True)
    yield
    PROFILED.records.clear()
    torch.set_num_threads(n)


class _Profiled:
    """``torch.profiler.profile`` on the CPU whose Chrome trace, written on
    exit, is read back as {annotation name: count}."""

    def __init__(self, path):
        self.path = str(path)
        self.annotations: dict[str, int] = {}

    def __enter__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.path)
            self.annotations = _annotations(self.path)
        return False


def _annotations(path) -> dict[str, int]:
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    out: dict[str, int] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _forbid(what):
    def boom(*a, **k):
        raise AssertionError(f"{what} called")
    return boom


def _forbid_annotations(monkeypatch):
    for mod in (torch.autograd.profiler, torch.profiler):
        monkeypatch.setattr(mod, "record_function", _forbid("record_function"))


@pytest.fixture
def no_annotation_no_sync(monkeypatch):
    """record_function and torch.cuda.synchronize raise when called."""
    _forbid_annotations(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", _forbid("synchronize"))


def _recording(frames, algo):
    cfg = RadarConfig.create(default_device_config(), algo)
    rec = synthesize_recording(cfg, frames, TARGETS, seed=frames)
    return cfg, rec.frames[:, 0], rec.calib_vector(0, cfg.nts)


def _windows(cfg, channels, windows, frames, seed):
    """``windows`` windows of ``channels`` channels, [C, F, PN, 2·NTS] each,
    and the channels' [C, NTS, 2] calibration."""
    raws, cals = [], []
    for c in range(channels):
        rec = synthesize_recording(cfg, windows * frames, TARGETS[c % 2:c % 2 + 1],
                                   seed=seed + c)
        raws.append(to_pair(rec.frames[:, 0]).reshape(windows, frames, cfg.pn, -1))
        cals.append(to_pair(rec.calib_vector(0, cfg.nts)))
    raw = np.stack(raws, axis=1).astype(np.float32)
    return [np.ascontiguousarray(w) for w in raw], np.stack(cals).astype(np.float32)


# --- the primitive ------------------------------------------------------------


def test_span_without_profiler_touches_nothing(no_annotation_no_sync):
    """No profiler: one shared no-op, no record_function, no sync, and the
    collector stays empty; a StageTimer still times its stages."""
    assert span("a") is span("b")
    with span("a"):
        pass
    timer = StageTimer()
    with timer.stage("s", items=3):
        pass
    assert PROFILED.records == {}
    assert (timer.records["s"].items, timer.records["s"].count) == (3, 1)


def test_span_under_profiler_is_an_annotation(tmp_path):
    with _Profiled(tmp_path / "t.json") as p:
        for _ in range(3):
            with span("outer"):
                with span("inner"):
                    torch.ones(4).sum()
    assert p.annotations["outer"] == 3 and p.annotations["inner"] == 3
    outer, inner = PROFILED.records["outer"], PROFILED.records["inner"]
    assert (outer.count, inner.count) == (3, 3)
    assert outer.seconds >= inner.seconds > 0


def test_count_sums_into_items_under_the_profiler_only(tmp_path):
    """Off the profiler a count leaves the collector empty and calls
    nothing; under it the counts of a name sum into its ``items``, with no
    seconds, and the first count of a stretch clears the one before."""
    with pytest.MonkeyPatch.context() as mp:
        _forbid_annotations(mp)
        mp.setattr(torch.cuda, "synchronize", _forbid("synchronize"))
        count("bytes", 5)
    assert PROFILED.records == {}
    with _Profiled(tmp_path / "1.json"):
        with span("copy"):
            count("bytes", 5)
            count("bytes", 7)
    rec = PROFILED.records["bytes"]
    assert (rec.items, rec.count, rec.seconds) == (12, 2, 0.0)
    assert set(PROFILED.records) == {"copy", "bytes"}
    count("bytes", 1)  # between two stretches
    with _Profiled(tmp_path / "2.json"):
        count("bytes", 3)
    assert {k: r.items for k, r in PROFILED.records.items()} == {"bytes": 3}


@pytest.mark.parametrize("between", [True, False])
def test_collector_holds_the_newest_profiled_stretch(tmp_path, between):
    """An unprofiled span between two profiled stretches clears the
    collector at the second stretch's first span; without one, the
    stretches accumulate."""
    with _Profiled(tmp_path / "1.json"):
        with span("first"):
            pass
        with span("both"):
            pass
    if between:
        with span("untraced"):
            pass
    with _Profiled(tmp_path / "2.json"):
        with span("both"):
            pass
    if between:
        assert set(PROFILED.records) == {"both"}
        assert PROFILED.records["both"].count == 1
    else:
        assert set(PROFILED.records) == {"first", "both"}
        assert PROFILED.records["both"].count == 2


def test_stage_names_in_trace_and_records_unchanged(tmp_path):
    """A StageTimer's stage is a span of its name; the timer's own records
    (items, counts) are the same with the profiler on as off."""
    def run():
        timer = StageTimer()
        for _ in range(2):
            with timer.stage("s1", items=4):
                torch.ones(8).cumsum(0)
            with timer.stage("s2"):
                pass
        return timer

    off = run()
    with _Profiled(tmp_path / "t.json") as p:
        on = run()
    assert p.annotations["s1"] == 2 and p.annotations["s2"] == 2
    assert {k: (r.items, r.count) for k, r in on.records.items()} == {
        k: (r.items, r.count) for k, r in off.records.items()} == {
        "s1": (8, 2), "s2": (None, 2)}
    assert PROFILED.records["s1"].count == 2
    assert "count" in on.pretty().splitlines()[0]


# --- the program's spans --------------------------------------------------------


def _assert_same(a, b, where="out"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("algo", ["fidelity", "production", "int8"])
@pytest.mark.parametrize("frames", [8, 64])
def test_process_recording_spans_once_and_outputs_identical(tmp_path, frames, algo):
    """Each recording.* span and each stage once a call under the profiler,
    and the counter recording.decode_copy_bytes once, with the bytes of the
    trimmed maps in their store dtypes (a float32 dB map past nb_pad 512);
    every output, payloads included, bit-identical to an unprofiled call."""
    production = AlgorithmConfig.production()
    algos = {"fidelity": AlgorithmConfig(), "production": production,
             "int8": dataclasses.replace(production, intensity_dtype="int8")}
    cfg, raw, calib = _recording(frames, algos[algo])
    pipe = RadarPipeline(cfg, device="cpu")
    want = pipe.process_recording(raw, calib, timer=StageTimer())
    assert want.spectrogram_intensity.shape[1] > 0
    with _Profiled(tmp_path / "t.json") as p:
        got = pipe.process_recording(raw, calib, timer=StageTimer())
    for name in RECORDING_SPANS + STAGES:
        assert p.annotations.get(name) == 1, name
    assert {k: r.count for k, r in PROFILED.records.items()} == {
        n: 1 for n in RECORDING_SPANS + STAGES + ("recording.decode_copy_bytes",
                                                  "recording.upload_bytes")}
    assert PROFILED.records["recording.upload_bytes"].items == raw.size * 2 * 4
    a = cfg.algorithm
    nb = got.spectrogram_psd_db.shape[0]
    db_bytes = 4 if a.stft_db_store == "float32" or -(-nb // 8) * 8 > 512 else 2
    assert PROFILED.records["recording.decode_copy_bytes"].items == (
        got.spectrogram_intensity.size * STORE_BYTES[a.intensity_dtype]
        + got.spectrogram_psd_db.size * db_bytes)
    _assert_same(dataclasses.asdict(got), dataclasses.asdict(want))


@pytest.mark.parametrize("channels", [2, 4])
def test_process_window_spans_and_results(tmp_path, channels):
    """stream.chain once a channel, stream.upload and stream.stft once a
    window; results equal those of an unprofiled processor fed the same
    windows."""
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    windows, calib = _windows(cfg, channels, 3, 8, seed=channels)
    procs = [StreamingProcessor(cfg, channels, 8, device="cpu", nfft=64)
             for _ in range(2)]
    want = [procs[0].process_window(w, calib) for w in windows]
    with _Profiled(tmp_path / "t.json") as p:
        got = [procs[1].process_window(w, calib) for w in windows]
    counts = {"stream.upload": 3, "stream.chain": 3 * channels, "stream.stft": 3}
    assert {k: p.annotations.get(k) for k in counts} == counts
    assert {k: r.count for k, r in PROFILED.records.items()} == counts
    for g, w in zip(got, want):
        for field in w._fields:
            torch.testing.assert_close(getattr(g, field), getattr(w, field),
                                       rtol=0, atol=0, equal_nan=True)


def test_paths_open_no_annotation_and_no_sync_without_profiler(no_annotation_no_sync,
                                                               tmp_path):
    """With no profiler the recording and the streaming paths, and a
    /process request served by the HTTP service, open no record_function
    and call no device sync (both raise here)."""
    cfg, raw, calib = _recording(8, AlgorithmConfig.production())
    RadarPipeline(cfg, device="cpu").process_recording(raw, calib, timer=StageTimer())
    windows, cal = _windows(cfg, 2, 2, 8, seed=1)
    proc = StreamingProcessor(cfg, 2, 8, device="cpu", nfft=64)
    for w in windows:
        proc.process_window(w, cal)
    with _served(tmp_path, 8) as (srv, _):
        assert _process(srv)["status"] == "success"
    assert PROFILED.records == {}


# --- the service's spans --------------------------------------------------------


@contextlib.contextmanager
def _served(tmp_path, frames):
    """A RadarHttpService on 127.0.0.1 at the default profile on the CPU,
    over local blob storage holding a recording of ``frames`` frames;
    yields (server, blob directory)."""
    cfg = RadarConfig.create(default_device_config())
    blobs, work = tmp_path / "blobs", tmp_path / "work"
    blobs.mkdir()
    work.mkdir()
    write_recording(str(blobs / "radar_data"),
                    synthesize_recording(cfg, frames, TARGETS, seed=frames))
    hc = HandlerConfig(workdir=str(work), storage_spec=f"local:{blobs}", device="cpu")
    with RadarHttpService(hc, port=0, host="127.0.0.1") as srv:
        yield srv, blobs


def _process(srv) -> dict:
    req = urllib.request.Request(srv.url + "process",
                                 data=json.dumps({"processAnimalActivity": "no"}).encode(),
                                 headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=120) as r:
        return json.loads(r.read())


def test_process_request_on_the_server_thread_fills_the_collector(tmp_path, monkeypatch):
    """Under torch.profiler, a /process request served on the HTTP server's
    own worker thread records each service.* span as often as its step
    runs (four JSON artifacts, five uploads) and the recording's spans;
    service.json_bytes sums the four JSON blobs' sizes."""
    threads = []
    main = RadarService.main

    def on_thread(self, request=None):
        threads.append(threading.current_thread())
        return main(self, request)

    monkeypatch.setattr(RadarService, "main", on_thread)
    with _served(tmp_path, 64) as (srv, blobs):
        with _Profiled(tmp_path / "t.json"):
            assert _process(srv)["status"] == "success"
    assert len(threads) == 1 and threads[0] is not threading.main_thread()
    assert {k: r.count for k, r in PROFILED.records.items()
            if k in SERVICE_SPANS} == SERVICE_SPANS
    assert all(PROFILED.records[k].seconds > 0 for k in SERVICE_SPANS)
    assert set(RECORDING_SPANS) <= set(PROFILED.records)
    sizes = sum(p.stat().st_size for p in blobs.glob("*.json"))
    rec = PROFILED.records["service.json_bytes"]
    assert (rec.items, rec.count, rec.seconds) == (sizes, 4, 0.0)
    assert len(list(blobs.glob("*.json"))) == 4


# --- the benchmark's readers of the spans ---------------------------------------


def _reader(metric):
    path = REPO / "radarbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("metric", sorted(COLLECTOR_READERS))
def test_span_metric_reads_the_collector(metric, monkeypatch):
    """Its reading from a filled collector (seconds / items in ms for a
    span); None from an empty one, from one lacking the last record it
    reads, and from a program without the collector."""
    read = _reader(metric)
    ctx = {"items": 4, "spans": {}}
    assert read(ctx) is None
    added, want = COLLECTOR_READERS[metric]
    PROFILED.add("another.span", 9.0, 11)
    for name, seconds, items in added:
        if name == added[-1][0] and name not in PROFILED.records:
            assert read(ctx) is None  # every record but the last one read
        PROFILED.add(name, seconds, items)
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    monkeypatch.delattr(observe, "PROFILED")
    assert read(ctx) is None


def test_graph_replay_metric_reads_the_span_count(monkeypatch):
    """100 × the count of stream.graph_replay / items from a filled
    collector; None from one without the span, and from a program without
    the collector."""
    read = _reader("stream.graph_replay_pct")
    ctx = {"items": 4, "spans": {}}
    assert read(ctx) is None
    PROFILED.add("stream.chain", 0.5)
    assert read(ctx) is None
    for _ in range(3):
        PROFILED.add("stream.graph_replay", 0.25)
    assert read(ctx) == pytest.approx(75.0, rel=1e-12)
    monkeypatch.delattr(observe, "PROFILED")
    assert read(ctx) is None


def test_graph_replay_metric_is_declared():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    assert declared["stream.graph_replay_pct"] == {
        "name": "stream.graph_replay_pct", "unit": "%", "better": "higher",
        "source": "program_span", "layer": "streaming",
        "moves": "stream_window_p95_ms", "workloads": ["stream-8ch.windows"]}


@pytest.mark.parametrize("db_mode", ["per_window", "running_max"])
def test_cpu_windows_open_no_graph_replay(tmp_path, db_mode):
    """On the CPU every window runs eagerly: under the profiler no window,
    a window of a new length included, opens stream.graph_replay."""
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    windows, calib = _windows(cfg, 2, 3, 8, seed=9)
    proc = StreamingProcessor(cfg, 2, 8, device="cpu", nfft=64, db_mode=db_mode)
    with _Profiled(tmp_path / "t.json") as p:
        for w in windows + [w[:, :4] for w in windows]:
            proc.process_window(w, calib)
    assert "stream.graph_replay" not in p.annotations
    assert "stream.graph_replay" not in PROFILED.records
    assert PROFILED.records["stream.chain"].count == 2 * 6 and proc._graphs == {}


def test_every_span_metric_is_declared():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    also_service = ("recording.upload_host_ms", "recording.decode_copy_ms")
    for metric in METRICS:
        m = declared[metric]
        assert (m["source"], m["unit"], m["better"]) == ("program_span", "ms", "lower")
        if metric.startswith("recording."):
            want = (RECORDING_CELLS + ([SERVICE_CELL] if metric in also_service else [])
                    + [DAY_CELL])
        elif metric.startswith("service."):
            want = [SERVICE_CELL]
            assert (m["layer"], m["moves"]) == ("service", "recording_frames_per_s")
        else:
            want = ["stream-8ch.windows"]
        assert m["workloads"] == want, metric


def test_counter_and_export_metrics_are_declared():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    assert declared["recording.decode_copy_gbps"] == {
        "name": "recording.decode_copy_gbps", "unit": "GB/s", "better": "higher",
        "source": "program_span", "layer": "host decode",
        "moves": "recording_frames_per_s",
        "workloads": RECORDING_CELLS + [SERVICE_CELL, DAY_CELL]}
    assert declared["service.json_gbps"] == {
        "name": "service.json_gbps", "unit": "GB/s", "better": "higher",
        "source": "program_span", "layer": "service",
        "moves": "recording_frames_per_s", "workloads": [SERVICE_CELL]}
    assert declared["recording.decode_pinned_pct"] == {
        "name": "recording.decode_pinned_pct", "unit": "%", "better": "higher",
        "source": "program_span", "layer": "host decode",
        "moves": "recording_frames_per_s", "workloads": RECORDING_CELLS + [DAY_CELL]}
    for name, unit in (("recording.decode_scratch_mb", "MB"),
                       ("recording.decode_host_alloc_pct", "%")):
        assert declared[name] == {
            "name": name, "unit": unit, "better": "lower", "source": "program_counter",
            "layer": "host decode", "moves": "recording_frames_per_s",
            "workloads": [DAY_CELL] + RECORDING_CELLS}
    assert declared["kernels_roofline_pct.export_tiled"] == {
        "name": "kernels_roofline_pct.export_tiled", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels", "moves": "recording_frames_per_s",
        "workloads": ["fidelity-1k.recording"]}


def test_upload_metrics_are_declared():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name, unit in (("recording.upload_staged_pct", "%"),
                       ("recording.upload_gbps", "GB/s")):
        assert declared[name] == {
            "name": name, "unit": unit, "better": "higher",
            "source": "program_span", "layer": "recording entry",
            "moves": "recording_frames_per_s", "workloads": RECORDING_CELLS + [DAY_CELL]}


def _kernel(name, dur_us, cat="kernel"):
    return {"name": name, "cat": cat, "ts": 0.0, "dur": dur_us}


def test_export_tiled_roofline_reads_the_tiled_pair():
    """The export's least time (bytes bound here) times the items over the
    device seconds of K4a and K4b alone, in percent; None where neither
    ran."""
    read = _reader("kernels_roofline_pct.export_tiled")
    work = {"bytes": 1e12, "flops": 1e15, "export": {"bytes": 3.35e9, "flops": 6.7e9}}
    others = [_kernel("void profile_wgmma_kernel<3, false>(float const*)", 9e3),
              _kernel("Memcpy DtoH (Device -> Pageable)", 9e5, "gpu_memcpy"),
              _kernel("void psd_tiled_kernel<true, false>(float const*)", 9e3, "gpu_memset")]
    assert read({"items": 2, "events": [], "work": work}) is None
    assert read({"items": 2, "events": others, "work": work}) is None
    events = others + [_kernel("void psd_tiled_kernel<true, false>(float const*, int)", 1500.0),
                       _kernel("void db_rescale_tiled_kernel<false, float, float>(Phase2Args)",
                               2500.0)]
    # least 1 ms (3.35 GB at 3.35 TB/s; 0.1 ms of operations) × 2 over 4 ms
    assert read({"items": 2, "events": events, "work": work}) == pytest.approx(50.0, rel=1e-12)


# --- on the card ------------------------------------------------------------------


@pytest.mark.cuda
def test_window_on_card_makes_no_host_sync(monkeypatch):
    """Once warm, a window whose inputs lie on the card runs under the sync
    debug mode "error" with the profiler off, opening no record_function."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fmcw_radar_processing_tpu_torch.utils.cplx import pin_f32_matmul

    pin_f32_matmul()
    dev = torch.device("cuda")
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    windows, calib = _windows(cfg, 8, 3, 256, seed=7)
    windows = [torch.as_tensor(w, device=dev) for w in windows]
    calib = torch.as_tensor(calib, device=dev)
    proc = StreamingProcessor(cfg, 8, 256, device=dev, nfft=256)
    proc.process_window(windows[0], calib)  # builds and loads the kernels
    torch.cuda.synchronize()
    _forbid_annotations(monkeypatch)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for w in windows[1:]:
            res = proc.process_window(w, calib)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert res.psd_db.shape[0] == 8 and PROFILED.records == {}
    assert [g.captured for g in proc._graphs.values()] == [True]  # replayed


@pytest.mark.cuda
def test_process_trace_dir_on_card_names_k1a(tmp_path):
    """The CLI's process --trace-dir on the card (its default device): in a
    process of its own, the trace's kernels include K1a
    (profile_wgmma_kernel<3, false>, demangled or not); in this process,
    with the launch counters reset, K1a runs. The recording is read by
    the native reader (g++ builds it on the card's machine), byte-equal to
    the NumPy reader."""
    import re
    import subprocess
    import sys

    from fmcw_radar_processing_tpu_torch.io.native_loader import native_available
    from fmcw_radar_processing_tpu_torch.io.raw_format import (
        load_recording_for_chain,
        read_recording,
        write_recording,
    )
    from fmcw_radar_processing_tpu_torch.ops import _lib
    from fmcw_radar_processing_tpu_torch.serve import cli

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = RadarConfig.create(default_device_config())
    base = str(tmp_path / "rec")
    write_recording(base, synthesize_recording(
        cfg, 256, (SyntheticTarget(range_m=7.5, doppler_bin_offset=3),), seed=20261016))
    assert native_available()
    raw, calib, _ = load_recording_for_chain(base)
    rec = read_recording(base)
    assert raw.tobytes() == to_pair(rec.rx1()).tobytes()
    np.testing.assert_allclose(calib, to_pair(rec.calib_vector(0, cfg.nts)), rtol=1e-6)

    k1a = re.compile(r"profile_wgmma_kernel(ILi3ELb0E|<3, false>)")
    for where in ("subprocess", "here"):
        trace_dir = tmp_path / f"trace_{where}"
        args = ["process", base, "--output-dir", str(tmp_path / f"out_{where}"),
                "--trace-dir", str(trace_dir), "--compact-json"]
        if where == "subprocess":
            proc = subprocess.run([sys.executable, "-m",
                                   "fmcw_radar_processing_tpu_torch.serve.cli", *args],
                                  cwd=REPO, capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[-2000:]
            files = list(trace_dir.iterdir())
            assert len(files) == 1
            events = json.loads(files[0].read_text())["traceEvents"]
            kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
            assert any(k1a.search(k) for k in kernels), sorted(kernels)[:8]
        else:
            _lib.reset_launches()
            assert cli.main(args) == 0
            torch.cuda.synchronize()
            assert _lib.LAUNCHES["fast_time_profile_b3"] >= 1
