"""PyTorch port: the kernel modules (K1, K2, K3; K4 in test_torch_fidelity.py;
K5, K6, K7 in test_torch_materialize.py) vs the JAX package's Pallas
kernels, run in interpret mode on the CPU as the JAX tests run them.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold those plain versions to the Pallas kernels with the tolerances
the JAX package applies between its own formulations
(tests/test_pallas_chain.py, tests/test_stft_pallas.py). The tests marked
``cuda`` hold the CUDA kernels to the plain versions and skip without a
card.
"""

import importlib
import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu.dsp.stft import StftOperator as JStftOperator
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.ops import detect_cuda as dtc
from fmcw_radar_processing_tpu_torch.ops import fast_time_cuda as ftc
from fmcw_radar_processing_tpu_torch.ops import stft_cuda as stc
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import make_frame_chain
from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

from .test_pipeline import _mixed_recording, _tpu_layout

jftp = importlib.import_module("fmcw_radar_processing_tpu.ops.fast_time_pallas")
jstp = importlib.import_module("fmcw_radar_processing_tpu.ops.stft_pallas")

OP_KW = dict(window_length=20, beta=3.0, nfft=256, fs=1000.0, hop=1)


def _snr_db(got, want) -> float:
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    return -20 * np.log10(max(err, 1e-30))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(1e-30))))
    return np.exp2(e - 7)


def assert_within_one_bf16_ulp(got, want, mask, f32_atol):
    """Two bf16 roundings of float32 values that agree to ``f32_atol`` land
    at most one bf16 ulp apart; near 0 dB, where a bf16 ulp is below the
    float32 tolerance, that tolerance bounds them instead."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bound = np.maximum(_bf16_ulp(np.maximum(np.abs(got), np.abs(want))), f32_atol)
    diff = np.abs(got - want)
    assert np.all(diff[mask] <= bound[mask]), float((diff - bound)[mask].max())


def _k1_inputs(cfg, rng, f=12):
    frames, calib = _mixed_recording(cfg, rng, f=f)
    raw = to_pair(_tpu_layout(frames)).reshape(f, cfg.pn, 2 * cfg.nts)
    return raw, to_pair(calib)


def _k1_port(cfg, raw, calib, device="cpu"):
    w = ftc.blocked_weight(cfg, device)
    off = ftc.calib_offset(torch.as_tensor(calib, device=device), w)
    x = torch.as_tensor(raw, device=device).reshape(-1, 2 * cfg.nts)
    return w, off, x


# --- (b) K1 -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_plain_matches_pallas(cfg, seed):
    """vs _profile_kernel_b3 ("high"): waterfall SNR > 80 dB; vs
    _profile_kernel ("highest"): rtol 1e-5 / atol 1e-2."""
    raw, calib = _k1_inputs(cfg, np.random.default_rng(seed))
    w, off, x = _k1_port(cfg, raw, calib)
    got = ftc.fast_time_profile(x, w, off, cfg.pn).numpy()
    assert got.shape == (raw.shape[0], cfg.range_fft_size)
    high = np.asarray(jftp.fast_time_profile_pallas(
        jnp.asarray(raw), jnp.asarray(calib), cfg, precision="high"))
    highest = np.asarray(jftp.fast_time_profile_pallas(
        jnp.asarray(raw), jnp.asarray(calib), cfg, precision="highest"))
    assert _snr_db(got, high) > 80.0
    np.testing.assert_allclose(got, highest, rtol=1e-5, atol=1e-2)


def test_k1_offset_is_exact_f32(cfg, rng):
    """off = calib·W at float32 against a float64 product."""
    calib = to_pair(rng.standard_normal(cfg.nts) + 1j * rng.standard_normal(cfg.nts))
    w = ftc.blocked_weight(cfg)
    off = ftc.calib_offset(torch.as_tensor(calib), w).numpy()
    want = calib.reshape(1, -1).astype(np.float64) @ w.numpy().astype(np.float64)
    np.testing.assert_allclose(off, want[0], rtol=1e-5, atol=1e-3)


# --- (c) K2 / K3 ----------------------------------------------------------


def _signal(l, count, seed=5):
    rng = np.random.default_rng(seed)
    sig = np.zeros(l, np.float32)
    sig[:count] = np.abs(
        rng.standard_normal(count) + 0.5 * np.sin(np.arange(count) * 0.3)
    ).astype(np.float32)
    return sig


def _jax_export(sig, count, **kw):
    op = JStftOperator.create(**OP_KW)
    out = jstp.spectrogram_pallas(jnp.asarray(sig), jnp.asarray(count), op,
                                  tile=512, **kw)
    return [np.asarray(a).astype(np.float32) if a.dtype == jnp.bfloat16
            else np.asarray(a) for a in out]


def _port_export(sig, count, **kw):
    op = StftOperator.create(**OP_KW)
    return stc.spectrogram(torch.as_tensor(sig), count, op, **kw)


@pytest.mark.parametrize("l,count", [(4096, 4096), (4096, 1000), (700, 650)])
def test_k2_k3_plain_match_pallas_f32(l, count):
    sig = _signal(l, count)
    p, db, intensity = (a.numpy() for a in _port_export(sig, count))
    p_j, db_j, int_j = _jax_export(sig, count, psd_precision="highest")
    assert p.shape == p_j.shape and intensity.shape == int_j.shape
    np.testing.assert_allclose(p, p_j, rtol=1e-4, atol=1e-10)
    m = db_j > -120
    np.testing.assert_allclose(db[m], db_j[m], atol=1e-3)
    np.testing.assert_array_equal(db == DB_FLOOR, db_j == DB_FLOOR)
    mi = int_j > -120
    np.testing.assert_allclose(intensity[mi], int_j[mi], atol=2e-3)
    # The production phase 1 (bf16x3) in the display band.
    _, _, int_h = _jax_export(sig, count, psd_precision="high")
    mh = int_h > -40
    np.testing.assert_allclose(intensity[mh], int_h[mh], atol=4e-3)
    # Invalid columns: zero PSD, floored dB.
    ncols = count - 20 + 1
    assert np.all(p[:, ncols:] == 0.0)
    assert np.all(db[:, ncols:] == DB_FLOOR)


def test_k2_k3_plain_match_pallas_bf16_stores():
    """Production stores: bf16 dB map and bf16 intensity."""
    sig = _signal(4096, 1000)
    _, db, intensity = _port_export(sig, 1000, intensity_dtype=torch.bfloat16,
                                    db_store_dtype=torch.bfloat16)
    assert db.dtype == torch.bfloat16 and intensity.dtype == torch.bfloat16
    _, db_j, int_j = _jax_export(sig, 1000, psd_precision="highest",
                                 intensity_dtype=jnp.bfloat16,
                                 db_store_dtype=jnp.bfloat16)
    db, intensity = db.float().numpy(), intensity.float().numpy()
    assert_within_one_bf16_ulp(db, db_j, db_j > -120, 1e-3)
    assert_within_one_bf16_ulp(intensity, int_j, int_j > -120, 2e-3)
    np.testing.assert_array_equal(db == DB_FLOOR, db_j == DB_FLOOR)


def test_k2_k3_plain_match_pallas_int8():
    """int8 codes equal, or one code apart where the float32 intensity lies
    within its tolerance (2e-3 dB) of a rounding half step."""
    sig = _signal(4096, 1000)
    _, _, codes = _port_export(sig, 1000, intensity_dtype=torch.int8)
    _, _, int_f32 = _port_export(sig, 1000)
    _, _, codes_j = _jax_export(sig, 1000, psd_precision="highest",
                                intensity_dtype=jnp.int8)
    assert codes.dtype == torch.int8
    codes, int_f32 = codes.numpy().astype(np.int32), int_f32.numpy()
    diff = np.abs(codes - codes_j.astype(np.int32))
    assert diff.max() <= 1
    lo, _ = stc.INT8_DB_RANGE
    pos = (int_f32 - lo) * stc.INT8_SCALE
    near_half = np.abs(pos - np.floor(pos) - 0.5) <= 2e-3 * stc.INT8_SCALE
    assert np.all(near_half[diff == 1])
    assert (diff == 0).mean() > 0.999


def test_k3_plain_floor_and_all_zero_psd():
    """gmax = 0 (all-zero PSD): every dB is the floor; the G > 0 guard."""
    p = torch.zeros((136, 1024))
    db, intensity = stc.db_rescale(p, p.amax(), 129, 1024, torch.float32,
                                   torch.float32)
    assert torch.all(db == DB_FLOOR)
    np.testing.assert_allclose(intensity.numpy(), DB_FLOOR, atol=0.2)


# --- (i) no silent fallback ------------------------------------------------


def _fail_if_called(*args, **kwargs):
    raise AssertionError("plain version reached from a non-CPU tensor")


def test_wrappers_raise_without_kernel_library(cfg, monkeypatch, tmp_path):
    """A non-CPU tensor goes to the kernel or raises: with no nvcc the
    loader raises, and the plain versions are never called."""
    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setattr(_lib, "find_nvcc", lambda: None)
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "library_path",
                        lambda: tmp_path / "libmissing.so")
    monkeypatch.setattr(ftc, "fast_time_profile_ref", _fail_if_called)
    monkeypatch.setattr(stc, "psd_phase1_ref", _fail_if_called)
    monkeypatch.setattr(stc, "db_rescale_ref", _fail_if_called)
    launches = dict(_lib.LAUNCHES)
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(_lib.KernelBuildError, match="nvcc"):
        ftc.fast_time_profile(torch.empty(32, 128, **meta),
                              torch.empty(128, 512, **meta),
                              torch.empty(512, **meta), 16)
    with pytest.raises(_lib.KernelBuildError):
        stc.psd_phase1(torch.empty(2000, **meta), 1981,
                       torch.empty(288, 20, **meta), 144, 2048)
    with pytest.raises(_lib.KernelBuildError):
        stc.db_rescale(torch.empty(144, 2048, **meta), torch.empty((), **meta),
                       129, 1024, torch.bfloat16, torch.bfloat16)
    with pytest.raises(_lib.KernelBuildError):
        stc.psd_phase1_tiled(torch.empty(2000, **meta), 1981,
                             torch.empty(2064, 20, **meta), 1032, 2048)
    with pytest.raises(_lib.KernelBuildError):
        stc.db_rescale_tiled(torch.empty(1032, 2048, **meta),
                             torch.empty((), **meta), 1025, 1024,
                             torch.float32, torch.float32)
    assert _lib.LAUNCHES == launches


def test_cuda_pipeline_raises_without_gpu(monkeypatch, tmp_path):
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu_torch.serve.cli import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = str(tmp_path / "rec")
    assert cli_main(["synth", base, "--frames", "4"]) == 0
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["process", base, "--device", "cuda",
                  "--output-dir", str(tmp_path / "out")])
    from fmcw_radar_processing_tpu.config import default_device_config

    with pytest.raises(RuntimeError, match="cuda"):
        RadarPipeline(RadarConfig.create(default_device_config()),
                      device="cuda")


class _StubKernels:
    """Stands in for the kernel library: records each launch symbol and its
    integer arguments, launches nothing and reports success."""

    def __init__(self):
        self.calls: list[tuple[str, tuple]] = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return 0

        return launch


def _stub_library(monkeypatch):
    stub = _StubKernels()
    monkeypatch.setattr(_lib, "load_kernels", lambda: stub)
    monkeypatch.setattr(_lib, "check_operand", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return stub


@pytest.mark.parametrize("nfft,db_dtype,tiled", [
    (256, torch.float32, False),
    (512, torch.bfloat16, False),  # nb_pad 272: the untiled ceiling
    (1000, torch.bfloat16, True),  # nb_pad 512: a pinned non-power of two
    (1024, torch.float32, True),
    (16384, torch.float32, True),
])
def test_spectrogram_dispatch_on_device_tensors(monkeypatch, nfft, db_dtype,
                                                tiled):
    """A device tensor goes to K2/K3 up to nb_pad 272 and to K4a/K4b above,
    never to the plain versions; each launch is counted once."""
    stub = _stub_library(monkeypatch)
    monkeypatch.setattr(stc, "psd_phase1_ref", _fail_if_called)
    monkeypatch.setattr(stc, "db_rescale_ref", _fail_if_called)
    launches = dict(_lib.LAUNCHES)
    op = StftOperator.create(**{**OP_KW, "nfft": nfft})
    sig = torch.empty(3000, device="meta")
    p, db, intensity = stc.spectrogram(sig, 2500, op,
                                       intensity_dtype=torch.int8,
                                       db_store_dtype=db_dtype)
    assert p.shape == db.shape == (op.num_bins, 2981)
    assert intensity.shape == (1024, 2981) and intensity.dtype == torch.int8
    assert db.dtype == db_dtype
    names = [name for name, _ in stub.calls]
    kernels = (["psd_phase1_tiled", "db_rescale_tiled"] if tiled
               else ["psd_phase1", "db_rescale"])
    assert names == [k + "_launch" for k in kernels]
    align = 16 if db_dtype == torch.bfloat16 else 8
    nb_pad = -(-op.num_bins // align) * align
    assert stub.calls[0][1][3] == nb_pad and stub.calls[0][1][6] == 3072
    assert {k: _lib.LAUNCHES[k] - launches[k] for k in launches} == {
        k: int(k in kernels) for k in launches}


def test_kernel_build_runs_one_nvcc_per_source(monkeypatch, tmp_path):
    """The build compiles every source with its own nvcc, all started
    before any is waited for, then links the objects into one library.
    Each fake compile waits (up to 10 s) until every compile has started,
    so compiles run one after another would leave an end line early."""
    log = tmp_path / "argv.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import pathlib, sys, time\n"
        f"log = pathlib.Path({str(log)!r})\n"
        "with log.open('a') as fh: fh.write('start ' + sys.argv[-1] + '\\n')\n"
        "deadline = time.monotonic() + 10\n"
        f"while log.read_text().count('start ') < {len(_lib.SOURCES)} \\\n"
        "        and time.monotonic() < deadline:\n"
        "    time.sleep(0.02)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "pathlib.Path(out).write_text(' '.join(sys.argv[1:]))\n"
        "with log.open('a') as fh: fh.write('end ' + sys.argv[-1] + '\\n')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_lib, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    target = tmp_path / "build" / "libtest.so"
    _lib._build(target)
    lines = log.read_text().splitlines()
    n = len(_lib.SOURCES)
    # Every compile starts before the first one ends; the link comes last.
    assert sorted(lines[:n]) == sorted(f"start {_lib.CSRC / s}" for s in _lib.SOURCES)
    assert all(line.startswith("end ") for line in lines[n:2 * n])
    assert len(lines) == 2 * n + 2
    link = target.read_text().split()
    assert link[:3] == ["-shared", "-o", link[2]]
    assert [os.path.basename(o) for o in link[3:]] == [s + ".o" for s in _lib.SOURCES]
    assert target.with_suffix(".log").read_text().count(" -c ") == n
    assert sorted(p.name for p in target.parent.iterdir()) == [
        "libtest.log", "libtest.so"]  # the objects' directory is gone


def test_kernel_build_failure_names_the_source(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import pathlib, sys\n"
        "if sys.argv[-1].endswith('stft_export_tiled.cu'):\n"
        "    sys.stderr.write('error: broken\\n'); sys.exit(2)\n"
        "pathlib.Path(sys.argv[sys.argv.index('-o') + 1]).write_text('obj')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_lib, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    target = tmp_path / "build" / "libtest.so"
    with pytest.raises(_lib.KernelBuildError, match="stft_export_tiled.cu"):
        _lib._build(target)
    assert not target.exists()
    assert "error: broken" in target.with_suffix(".log").read_text()


def test_new_wrappers_raise_without_kernel_library(monkeypatch, tmp_path):
    """K5a, K5b, K6 and K7 on a non-CPU tensor: the loader raises without
    nvcc, and the plain versions are never called."""
    monkeypatch.setattr(_lib, "_lib", None)
    monkeypatch.setattr(_lib, "find_nvcc", lambda: None)
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "library_path",
                        lambda: tmp_path / "libmissing.so")
    monkeypatch.setattr(ftc, "fast_time_ref", _fail_if_called)
    monkeypatch.setattr(dtc, "search_peaks_fused_ref", _fail_if_called)
    monkeypatch.setattr(stc, "psd_tmax_ref", _fail_if_called)
    monkeypatch.setattr(stc, "db_rescale_recompute_ref", _fail_if_called)
    launches = dict(_lib.LAUNCHES)
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(_lib.KernelBuildError, match="nvcc"):
        ftc.fast_time(torch.empty(32, 128, **meta),
                      torch.empty(128, 512, **meta), torch.empty(512, **meta), 16)
    cfg = RadarConfig.create(default_device_config())
    with pytest.raises(_lib.KernelBuildError):
        dtc.search_peaks_fused(torch.empty(4, 256, **meta), cfg)
    with pytest.raises(_lib.KernelBuildError):
        stc.psd_tmax(torch.empty(2000, **meta), 1981,
                     torch.empty(272, 20, **meta), 136, 2048)
    with pytest.raises(_lib.KernelBuildError):
        stc.db_rescale_recompute(torch.empty(2000, **meta), 1981,
                                 torch.empty(272, 20, **meta),
                                 torch.empty((), **meta), 129, 1024, 2048,
                                 torch.float32)
    assert _lib.LAUNCHES == launches


def _launch_deltas(before):
    return {k: _lib.LAUNCHES[k] - before[k] for k in before}


@pytest.mark.parametrize("f", [12, 9])
def test_fast_time_dispatch_on_device_tensors(monkeypatch, f):
    """K6 on a device tensor: one fast_time launch (rows, K), rf [F, PN, K,
    2] and profile [F, K] allocated for it, never the plain version."""
    stub = _stub_library(monkeypatch)
    monkeypatch.setattr(ftc, "fast_time_ref", _fail_if_called)
    before = dict(_lib.LAUNCHES)
    meta = dict(device="meta", dtype=torch.float32)
    rf, prof = ftc.fast_time(torch.empty(f * 16, 128, **meta),
                             torch.empty(128, 512, **meta),
                             torch.empty(512, **meta), 16)
    assert rf.shape == (f, 16, 256, 2) and prof.shape == (f, 256)
    assert [(n, a[5:7]) for n, a in stub.calls] == [("fast_time_launch",
                                                     (f * 16, 256))]
    assert _launch_deltas(before) == {k: int(k == "fast_time") for k in before}


@pytest.mark.parametrize("targets", [1, 3])
def test_search_peaks_fused_dispatch_on_device_tensors(monkeypatch, targets):
    """K7 on a device tensor: one launch with the float32 threshold, frames,
    K and T; [F, T] outputs; a K the kernel is not built for raises first."""
    stub = _stub_library(monkeypatch)
    monkeypatch.setattr(dtc, "search_peaks_fused_ref", _fail_if_called)
    cfg = RadarConfig.create(default_device_config(),
                             AlgorithmConfig(max_num_targets=targets))
    before = dict(_lib.LAUNCHES)
    det = dtc.search_peaks_fused(torch.empty(100, 256, device="meta"), cfg)
    assert det.idx.shape == det.magnitude.shape == det.valid.shape == (100, targets)
    assert (det.idx.dtype, det.valid.dtype) == (torch.int32, torch.bool)
    (name, args), = stub.calls
    assert name == "search_peaks_launch" and args[2:6] == (200.0, 100, 256, targets)
    with pytest.raises(ValueError, match="K in"):
        dtc.search_peaks_fused(torch.empty(100, 200, device="meta"), cfg)
    assert len(stub.calls) == 1
    assert _launch_deltas(before) == {
        k: int(k == "search_peaks_fused") for k in before}


@pytest.mark.parametrize("nfft", [256, 512])
def test_spectrogram_recompute_dispatch_on_device_tensors(monkeypatch, nfft):
    """recompute=True on a device tensor: K5a then K5b, each counted once,
    psd None, a float32 dB map; K2/K3 and the plain versions untouched."""
    stub = _stub_library(monkeypatch)
    for name in ("psd_phase1_ref", "db_rescale_ref", "psd_tmax_ref",
                 "db_rescale_recompute_ref"):
        monkeypatch.setattr(stc, name, _fail_if_called)
    before = dict(_lib.LAUNCHES)
    op = StftOperator.create(**{**OP_KW, "nfft": nfft})
    p, db, intensity = stc.spectrogram(torch.empty(3000, device="meta"), 2500,
                                       op, intensity_dtype=torch.int8,
                                       recompute=True)
    assert p is None and db.dtype == torch.float32
    assert db.shape == (op.num_bins, 2981) and intensity.shape == (1024, 2981)
    assert [n for n, _ in stub.calls] == ["psd_tmax_launch",
                                          "db_rescale_recompute_launch"]
    nb_pad = -(-op.num_bins // 8) * 8
    assert stub.calls[0][1][3] == nb_pad and stub.calls[1][1][3] == nb_pad
    assert _launch_deltas(before) == {
        k: int(k in ("psd_tmax", "db_rescale_recompute")) for k in before}


def test_declared_launch_symbols_are_defined_once_in_the_sources():
    """Every C entry point the loader declares is defined in exactly one of
    the sources the build compiles."""
    import re

    class Recorder:
        def __getattr__(self, name):
            fn = SimpleNamespace()
            object.__setattr__(self, name, fn)
            return fn

    declared = Recorder()
    _lib._declare(declared)
    symbols = set(vars(declared))
    assert {"fast_time_launch", "search_peaks_launch", "psd_tmax_launch",
            "db_rescale_recompute_launch"} <= symbols
    defined: dict[str, int] = {}
    for src in _lib.SOURCES:
        text = (_lib.CSRC / src).read_text()
        for name in re.findall(r'extern "C" int (\w+)\(', text):
            defined[name] = defined.get(name, 0) + 1
    assert {n: defined.get(n, 0) for n in symbols} == {n: 1 for n in symbols}


# --- (j) CUDA kernels vs plain versions (need a card) ----------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fmcw_radar_processing_tpu_torch.utils.cplx import pin_f32_matmul

    pin_f32_matmul()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [12, 1000])
def test_k1_kernel_matches_plain(cfg, cuda_device, f):
    raw, calib = _k1_inputs(cfg, np.random.default_rng(3), f=f)
    w, off, x = _k1_port(cfg, raw, calib, cuda_device)
    before = _lib.LAUNCHES["fast_time_profile"]
    got = ftc.fast_time_profile(x, w, off, cfg.pn)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["fast_time_profile"] == before + 1
    want = ftc.fast_time_profile_ref(x, w, off, cfg.pn)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("int_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("l,count", [(4096, 1000), (70_000, 69_000)])
def test_k2_k3_kernels_match_plain(cuda_device, int_dtype, l, count):
    sig = torch.as_tensor(_signal(l, count), device=cuda_device)
    op = StftOperator.create(**OP_KW)
    db_dtype = torch.bfloat16 if int_dtype == torch.bfloat16 else torch.float32
    align = 16 if db_dtype == torch.bfloat16 else 8
    nb, nb_pad = op.num_bins, -(-op.num_bins // align) * align
    t_pad = -(-(l - 19) // stc.PSD_TILE) * stc.PSD_TILE
    a2 = torch.as_tensor(stc._folded_operator(op, align), device=cuda_device)
    p, tmax = stc.psd_phase1(sig, count - 19, a2, nb_pad, t_pad)
    p_ref, tmax_ref = stc.psd_phase1_ref(sig, count - 19, a2, nb_pad, t_pad)
    torch.testing.assert_close(p, p_ref, rtol=1e-4, atol=1e-10)
    torch.testing.assert_close(tmax, tmax_ref, rtol=1e-5, atol=0.0)
    gmax = tmax.amax()
    db, out = stc.db_rescale(p, gmax, nb, 1024, db_dtype, int_dtype)
    db_ref, out_ref = stc.db_rescale_ref(p, gmax, nb, 1024, db_dtype, int_dtype)
    torch.cuda.synchronize()
    assert torch.equal(db == DB_FLOOR, db_ref == DB_FLOOR)
    m = db_ref.float() > -120
    torch.testing.assert_close(db.float()[m], db_ref.float()[m], rtol=0,
                               atol=1e-3 if db_dtype == torch.float32 else 0.5)
    if int_dtype == torch.int8:
        assert (out.int() - out_ref.int()).abs().max() <= 1
    else:
        mi = out_ref.float() > -120
        torch.testing.assert_close(out.float()[mi], out_ref.float()[mi], rtol=0,
                                   atol=2e-3 if int_dtype == torch.float32 else 0.5)


def _k4_run(sig, count, op, db_dtype, int_dtype, tiled=True):
    """One export through the K4 (or K2/K3) wrappers, returning every
    intermediate: (p, tmax, gmax, db, out)."""
    align = 16 if db_dtype == torch.bfloat16 else 8
    nb, nb_pad = op.num_bins, -(-op.num_bins // align) * align
    t_pad = -(-(sig.shape[0] - 19) // stc.PSD_TILE) * stc.PSD_TILE
    a2 = torch.as_tensor(stc._folded_operator(op, align), device=sig.device)
    phase1, phase2 = ((stc.psd_phase1_tiled, stc.db_rescale_tiled) if tiled
                      else (stc.psd_phase1, stc.db_rescale))
    p, tmax = phase1(sig, count - 19, a2, nb_pad, t_pad)
    gmax = tmax.amax()
    db, out = phase2(p, gmax, nb, 1024, db_dtype, int_dtype)
    return a2, p, tmax, gmax, db, out


@pytest.mark.cuda
@pytest.mark.parametrize("int_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nfft,l,count,db_dtype", [
    (2048, 4096, 3000, torch.float32),  # nb_pad 1032: a partial last bin block
    (1000, 3000, 2500, torch.bfloat16),  # nb_pad 512: four whole blocks
])
def test_k4_kernels_match_plain(cuda_device, int_dtype, nfft, l, count,
                                db_dtype):
    sig = torch.as_tensor(_signal(l, count), device=cuda_device)
    op = StftOperator.create(**{**OP_KW, "nfft": nfft})
    before = dict(_lib.LAUNCHES)
    a2, p, tmax, gmax, db, out = _k4_run(sig, count, op, db_dtype, int_dtype)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["psd_phase1_tiled"] == before["psd_phase1_tiled"] + 1
    assert _lib.LAUNCHES["db_rescale_tiled"] == before["db_rescale_tiled"] + 1
    nb_pad, t_pad = p.shape
    p_ref, tmax_ref = stc.psd_phase1_ref(sig, count - 19, a2, nb_pad, t_pad)
    torch.testing.assert_close(p, p_ref, rtol=1e-4, atol=1e-10)
    assert tmax.shape == (-(-nb_pad // stc.BIN_BLOCK) * (t_pad // stc.PSD_TILE),)
    torch.testing.assert_close(gmax, tmax_ref.amax(), rtol=1e-5, atol=0.0)
    db_ref, out_ref = stc.db_rescale_ref(p, gmax, op.num_bins, 1024, db_dtype,
                                         int_dtype)
    assert torch.equal(db == DB_FLOOR, db_ref == DB_FLOOR)
    m = db_ref.float() > -120
    torch.testing.assert_close(db.float()[m], db_ref.float()[m], rtol=0,
                               atol=1e-3 if db_dtype == torch.float32 else 0.5)
    if int_dtype == torch.int8:
        assert (out.int() - out_ref.int()).abs().max() <= 1
    else:
        mi = out_ref.float() > -120
        torch.testing.assert_close(out.float()[mi], out_ref.float()[mi], rtol=0,
                                   atol=2e-3 if int_dtype == torch.float32 else 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("db_dtype", [torch.float32, torch.bfloat16])
def test_k4_kernels_equal_k2_k3_at_small_nfft(cuda_device, db_dtype):
    """K4a runs K2's arithmetic per bin block and K4b K3's per row, so at an
    nb_pad both pairs take, their outputs are bit-equal."""
    sig = torch.as_tensor(_signal(4096, 3000), device=cuda_device)
    op = StftOperator.create(**OP_KW)
    tiled = _k4_run(sig, 3000, op, db_dtype, torch.float32)[1:]
    untiled = _k4_run(sig, 3000, op, db_dtype, torch.float32, tiled=False)[1:]
    torch.cuda.synchronize()
    for i in (0, 2, 3, 4):  # p, gmax, db, intensity
        assert torch.equal(tiled[i], untiled[i])


@pytest.mark.cuda
@pytest.mark.parametrize("f", [12, 9, 1001])  # 9, 1001: not whole row tiles
def test_k6_kernel_matches_plain(cfg, cuda_device, f):
    """rf and profile vs the plain version (rtol 1e-5 / atol 1e-2); the
    profile bit-equal to K1's."""
    raw, calib = _k1_inputs(cfg, np.random.default_rng(4), f=f)
    w, off, x = _k1_port(cfg, raw, calib, cuda_device)
    before = _lib.LAUNCHES["fast_time"]
    rf, prof = ftc.fast_time(x, w, off, cfg.pn)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["fast_time"] == before + 1
    rf_ref, prof_ref = ftc.fast_time_ref(x, w, off, cfg.pn)
    torch.testing.assert_close(rf, rf_ref, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(prof, prof_ref, rtol=1e-5, atol=1e-2)
    assert torch.equal(prof, ftc.fast_time_profile(x, w, off, cfg.pn))


@pytest.mark.cuda
@pytest.mark.parametrize("targets", [1, 3])
def test_k7_kernel_matches_plain(cuda_device, targets):
    """idx, magnitude and valid exactly equal to the plain version, invalid
    slots included, on a recording's profile and on hand-made rows with
    plateaus, ties, threshold-equal and gate-edge values."""
    cfg = RadarConfig.create(default_device_config(),
                             AlgorithmConfig(max_num_targets=targets))
    raw, calib = _k1_inputs(cfg, np.random.default_rng(5), f=300)
    w, off, x = _k1_port(cfg, raw, calib, cuda_device)
    prof = ftc.fast_time_profile(x, w, off, cfg.pn)
    hand = torch.zeros(5, cfg.range_fft_size, device=cuda_device)
    hand[0, 40:43] = 600.0
    hand[0, 80] = 600.0
    hand[1, 50] = 200.0
    hand[2, 0] = 900.0
    hand[3] = 400.0
    prof = torch.cat([prof, hand])
    before = _lib.LAUNCHES["search_peaks_fused"]
    got = dtc.search_peaks_fused(prof, cfg)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["search_peaks_fused"] == before + 1
    want = dtc.search_peaks_fused_ref(prof, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got.valid.any() and not got.valid.all()


@pytest.mark.cuda
@pytest.mark.parametrize("int_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nfft,l,count", [(256, 70_000, 69_000), (512, 4096, 3000)])
def test_k5_kernels_equal_k2_k3(cuda_device, int_dtype, nfft, l, count):
    """K5a's tmax bit-equal to K2's and K5b's db and intensity to K3's
    (float32 dB map); each within K2/K3's bounds of its plain version."""
    sig = torch.as_tensor(_signal(l, count), device=cuda_device)
    op = StftOperator.create(**{**OP_KW, "nfft": nfft})
    a2, p, tmax, gmax, db, out = _k4_run(sig, count, op, torch.float32,
                                         int_dtype, tiled=False)
    nb_pad, t_pad = p.shape
    before = dict(_lib.LAUNCHES)
    tmax_r = stc.psd_tmax(sig, count - 19, a2, nb_pad, t_pad)
    db_r, out_r = stc.db_rescale_recompute(sig, count - 19, a2, tmax_r.amax(),
                                           op.num_bins, 1024, t_pad, int_dtype)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["psd_tmax"] == before["psd_tmax"] + 1
    assert _lib.LAUNCHES["db_rescale_recompute"] == before["db_rescale_recompute"] + 1
    assert torch.equal(tmax_r, tmax)
    assert torch.equal(db_r, db) and torch.equal(out_r, out)
    torch.testing.assert_close(tmax_r, stc.psd_tmax_ref(sig, count - 19, a2,
                                                        nb_pad, t_pad),
                               rtol=1e-5, atol=0.0)
    db_ref, out_ref = stc.db_rescale_recompute_ref(sig, count - 19, a2, gmax,
                                                   op.num_bins, 1024, t_pad,
                                                   int_dtype)
    assert torch.equal(db_r == DB_FLOOR, db_ref == DB_FLOOR)
    m = db_ref > -120
    torch.testing.assert_close(db_r[m], db_ref[m], rtol=0, atol=1e-3)
    if int_dtype == torch.int8:
        assert (out_r.int() - out_ref.int()).abs().max() <= 1
    else:
        mi = out_ref.float() > -120
        torch.testing.assert_close(out_r.float()[mi], out_ref.float()[mi], rtol=0,
                                   atol=2e-3 if int_dtype == torch.float32 else 0.5)


@pytest.mark.cuda
def test_pallas_chain_on_card_matches_cpu(cfg, cuda_device):
    """make_frame_chain(impl="pallas", return_range_fft=True) on the card
    against the CPU plain path: detections and ranges exact, the waterfall
    within rtol 1e-5 / atol 1e-2, the cube and the strongest chirps within
    the JAX package's bound between two summation orders, rtol 1e-5 / atol
    1e-5·max|rf| (tests/test_fused_chain.py:73-90)."""
    raw, calib = _k1_inputs(cfg, np.random.default_rng(6), f=64)
    outs = [make_frame_chain(cfg, dev, return_range_fft=True, impl="pallas")(
                torch.as_tensor(raw, device=dev), torch.as_tensor(calib, device=dev))
            for dev in (cuda_device, "cpu")]
    got, want = outs
    assert torch.equal(got.detection.idx.cpu(), want.detection.idx)
    assert torch.equal(got.detected.cpu(), want.detected)
    assert np.array_equal(got.range.cpu().numpy(), want.range.numpy(),
                          equal_nan=True)
    torch.testing.assert_close(got.waterfall.cpu(), want.waterfall, rtol=1e-5,
                               atol=1e-2)
    scale = float(want.range_fft.abs().max())
    for name in ("range_fft", "strongest_chirps"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name),
                                   rtol=1e-5, atol=1e-5 * scale)
