"""PyTorch port: the recording paths and the service on one CUDA card,
against the injected targets, the exact chain and the port's CPU plain
path.

The kernels alone are held to their plain versions by the ``cuda`` tests
of test_torch_ops.py and test_torch_k1c_k7.py; here they run behind
``RadarPipeline`` and ``RadarService``, counted by ``ops/_lib.py``'s
launch counters. The recordings carry two targets (7.5 m and 16.9 m) with
about a tenth of the frames muted, so that slow-time packing is not the
identity: 256 production frames, 1,024 fidelity frames (nfft 16,384 on
the whole recording, 2,048 on its first 128) and, in the tests also
marked ``slow``, the production recording at full size, 65,536 frames
(the ``production-65k`` benchmark's length). Every test needs a card and
skips without one; none imports JAX.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu_torch import (
    AlgorithmConfig,
    LocalStorage,
    RadarConfig,
    SyntheticTarget,
    default_device_config,
    synthesize_recording,
    write_recording,
)
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.ops import fast_time_cuda as ftc
from fmcw_radar_processing_tpu_torch.ops import stft_cuda as stc
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import pack_slow_time
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig, RadarService
from fmcw_radar_processing_tpu_torch.utils import cplx
from fmcw_radar_processing_tpu_torch.utils.cplx import pair_abs, pin_f32_matmul, to_pair

FRAMES = 65_536
FIDELITY_FRAMES = 1_024
SMALL_FRAMES = 256
SEED = 20261016
MUTED_SHARE = 0.10
STRONG = SyntheticTarget(range_m=7.5, doppler_bin_offset=3, amplitude=4.0)
WEAK = SyntheticTarget(range_m=16.9, doppler_bin_offset=-2, amplitude=2.0)
# Launch counters (ops/_lib.py::LAUNCHES) of the kernels the paths run.
K1A, K1B, K1C = "fast_time_profile_b3", "fast_time_profile", "fast_time_profile_bf16"
K2A, K2B, K3 = "psd_phase1_b3", "psd_phase1", "db_rescale"
K4A, K4B = "psd_phase1_tiled", "db_rescale_tiled"
K6, K7 = "fast_time", "search_peaks_fused"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_f32_matmul()
    return torch.device("cuda", 0)


def _production(**algo) -> RadarConfig:
    return RadarConfig.create(default_device_config(), AlgorithmConfig.production(**algo))


def _recording(cfg: RadarConfig, frames: int, seed: int):
    """A recording of the two targets: (the recording, raw [F, PN, 2·NTS],
    calib [NTS, 2], the frames with targets). The frames with targets are
    the first ``frames`` of one draw of FRAMES from SEED, as for every
    recording here."""
    present = np.random.default_rng(SEED).random(FRAMES)[:frames] >= MUTED_SHARE
    rec = synthesize_recording(cfg, frames, (STRONG, WEAK), seed=seed,
                               target_present=present)
    raw = to_pair(rec.rx1()).reshape(frames, cfg.pn, 2 * cfg.nts)
    return rec, raw, to_pair(rec.calib_vector(0, cfg.nts)), present


def _strong_target(cfg: RadarConfig):
    """The range and the speed the chain reports for STRONG, in float32."""
    rng = np.float32(STRONG.range_bin(cfg)) * np.float32(cfg.derived.dist_per_bin)
    spd = np.float32(STRONG.doppler_bin_offset) * np.float32(
        -cfg.derived.fd_per_bin * cfg.derived.hz_to_mps)
    return rng, spd


def _counted(fn, *args, **kwargs):
    """``fn``'s result and the launches it made, by counter."""
    torch.cuda.synchronize()
    _lib.reset_launches()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, dict(_lib.LAUNCHES)


def _once_each(launches: dict, *names: str) -> dict:
    """``launches`` as it reads when ``names`` ran once each and nothing else."""
    return {k: int(k in names) for k in launches}


def _snr_db(got, want) -> float:
    got, want = (np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float64)
                 for a in (got, want))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    return -20.0 * float(np.log10(max(err, 1e-30)))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _assert_within_one_bf16_ulp(got, want) -> None:
    """Above -120 dB, within one bf16 ulp of the larger magnitude, and
    within 1e-3 dB where that ulp is smaller."""
    a, b = torch.as_tensor(got), torch.as_tensor(want)
    assert a.shape == b.shape
    tol = torch.maximum(_bf16_ulp(torch.maximum(a.abs(), b.abs())), torch.tensor(1e-3))
    assert bool(((a - b).abs() <= tol)[b > -120].all())


def _assert_targets(out, cfg, present) -> None:
    """Detections on exactly the frames with targets, and in each of them
    STRONG's range and speed; no range elsewhere."""
    np.testing.assert_array_equal(out.detected, present)
    rng, spd = _strong_target(cfg)
    det = out.detected
    assert np.all(out.target_range[0, det] == rng)
    assert np.all(np.isnan(out.target_range[0, ~det]))
    assert np.all(out.target_speed[0, det] == spd)


def _assert_held_to_exact(got, exact, max_share: float) -> None:
    """At most ``max_share`` of the frames detected otherwise than the exact
    chain (impl "pallas_profile") detects them, and ranges equal to its on
    the frames both detect."""
    diff = int((got.detected != exact.detected).sum())
    assert diff <= max_share * got.detected.shape[0]
    both = got.detected & exact.detected
    np.testing.assert_array_equal(got.target_range[:, both], exact.target_range[:, both])


def _assert_intensity_within(out, ref, dtype) -> None:
    """The export's intensity against its plain version: one code in int8,
    one bf16 ulp in bf16, 2e-3 dB in float32."""
    if dtype == torch.int8:
        assert bool(((out.int() - ref.int()).abs() <= 1).all())
    elif dtype == torch.bfloat16:
        d = (out.float() - ref.float()).abs()
        assert bool((d <= _bf16_ulp(ref.float())).all())
    else:
        assert bool(((out - ref).abs() <= 2e-3).all())


# --- 256 and 1,024 frames ----------------------------------------------------


@pytest.fixture(scope="module")
def small(card):
    return _recording(_production(), SMALL_FRAMES, SEED + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", [{}, {"stft_hop": 4}, {"stft_psd_store": "bfloat16"}],
                         ids=["default", "hop4", "bf16_psd_store"])
def test_256_frames_on_card_match_the_cpu_plain_path(card, small, monkeypatch, algo):
    """The production profile on 256 frames, on the card and on the CPU
    under impl "pallas_profile_high" (the card's "auto", K1a; the CPU's
    "auto" is the exact profile): detections, ranges and speeds equal, the
    waterfall within rtol 1e-5 / atol 1e-2, intensity and dB map within
    one bf16 ulp above -120 dB. The card runs K1a, K2a and K3 (with the
    bf16 store, K2a's rounding flag); at stft_hop 4 only K1a, the export
    being the JAX package's XLA branch in plain PyTorch, and the CPU takes
    the card's pass semantics there (rescale_precision "high" is three
    bf16 passes on the card, exact float32 on the CPU)."""
    cfg = _production(**algo)
    _, raw, cal, _ = small
    got, launches = _counted(RadarPipeline(cfg, device=card).process_recording, raw, cal)
    hop = cfg.algorithm.stft_hop or 1
    assert {k for k, n in launches.items() if n} == ({K1A} if hop != 1 else {K1A, K2A, K3})
    if hop != 1:
        monkeypatch.setattr(cplx, "takes_mxu_passes", lambda t: True)
    want = RadarPipeline(cfg, device="cpu", impl="pallas_profile_high"
                         ).process_recording(raw, cal)
    np.testing.assert_array_equal(got.detected, want.detected)
    np.testing.assert_array_equal(got.target_range, want.target_range)
    np.testing.assert_array_equal(got.target_speed, want.target_speed)
    np.testing.assert_allclose(got.waterfall, want.waterfall, rtol=1e-5, atol=1e-2)
    for name in ("spectrogram_intensity", "spectrogram_psd_db"):
        _assert_within_one_bf16_ulp(getattr(got, name), getattr(want, name))
    if hop != 1:
        n_cols = (int(got.detected.sum()) * cfg.pn - 20) // hop + 1
        assert got.spectrogram_intensity.shape == (1024, n_cols)
        np.testing.assert_array_equal(got.spectrogram_times, want.spectrogram_times)


@pytest.fixture(scope="module")
def fidelity(card):
    return _recording(RadarConfig.create(default_device_config()), FIDELITY_FRAMES,
                      SEED + 2)


@pytest.mark.cuda
def test_fidelity_128_frames_on_card_match_the_cpu_plain_path(card, fidelity):
    """The fidelity profile (the bare AlgorithmConfig) on the recording's
    first 128 frames (nfft 2,048) against the CPU plain path: detections,
    ranges and speeds equal; the dB map within 1e-3 dB above -40 dB and
    the intensity within 2e-3, both within 0.2 dB above -120 dB, the
    floors in the same places."""
    cfg = RadarConfig.create(default_device_config())
    _, raw, cal, _ = fidelity
    got = RadarPipeline(cfg, device=card).process_recording(raw[:128], cal)
    want = RadarPipeline(cfg, device="cpu").process_recording(raw[:128], cal)
    np.testing.assert_array_equal(got.detected, want.detected)
    np.testing.assert_array_equal(got.target_range, want.target_range)
    np.testing.assert_array_equal(got.target_speed, want.target_speed)
    assert got.spectrogram_psd_db.shape[0] == 1025
    for name, tol in (("spectrogram_psd_db", 1e-3), ("spectrogram_intensity", 2e-3)):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert float(d[b > -40].max()) <= tol
        assert float(d[b > -120].max()) <= 0.2
        np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)


@pytest.mark.cuda
def test_fidelity_main_path_on_card(card, fidelity):
    """The fidelity profile on 1,024 frames (nfft 16,384): K1a, K4a and
    K4b run, no other export kernel; the targets found; a [1024, n] finite
    intensity and an [8193, n] dB map normalized to 0 dB, floored at
    DB_FLOOR, with no valid column at the floor."""
    cfg = RadarConfig.create(default_device_config())
    _, raw, cal, present = fidelity
    out, launches = _counted(RadarPipeline(cfg, device=card).process_recording, raw, cal)
    assert all(launches[k] > 0 for k in (K1A, K4A, K4B))
    assert all(launches[k] == 0 for k in (K1B, K2B, K2A, K3, "psd_tmax_tiled",
                                          "db_rescale_recompute_tiled"))
    _assert_targets(out, cfg, present)
    n_valid = int(out.detected.sum()) * cfg.pn - 19
    inten, psd = out.spectrogram_intensity, out.spectrogram_psd_db
    assert inten.shape == (1024, n_valid) and psd.shape == (8193, n_valid)
    assert bool(np.isfinite(inten).all())
    assert float(psd.max()) == 0.0 and bool((psd >= DB_FLOOR).all())
    assert not (psd == DB_FLOOR).all(axis=0).any()


def _serve_no(svc, work, want_range) -> None:
    """A full-recording request: success, the four payloads and the PNG
    written, the injected range in every detected frame."""
    res = svc.main({"processAnimalActivity": "no"})
    assert res["status"] == "success", res
    for name in ("spectrogram_data.json", "radar_data_range_fft_data.json",
                 "radar_data_range_speed_data.json", "radar_data_fft_data.json",
                 "spectrogram.png"):
        assert os.path.exists(os.path.join(work, name)), name
    with open(os.path.join(work, "radar_data_range_speed_data.json")) as fh:
        rs = json.load(fh)
    # (T, F) with T = 1 encodes as a flat row (jsonencode rules).
    ranges = [v for v in np.ravel(np.array(rs["range"], dtype=object)) if v is not None]
    assert ranges and all(v == float(want_range) for v in ranges)


def _serve_yes(svc, work, present, pn) -> None:
    """An activity request: three batch JSONs, named and numbered as the
    JAX service names them, each with a finite [1024, 16·detected − 19]
    intensity."""
    res = svc.main({"processAnimalActivity": "yes"})
    assert res["status"] == "success", res
    names = [f"radar_data_spectrogram_batch_{b}.json" for b in (1, 2, 3)]
    assert res["steps"][1]["artifacts"] == names
    for b, name in enumerate(names):
        with open(os.path.join(work, name)) as fh:
            payload = json.load(fh)
        start, end = 100 * b + 1, min(100 * (b + 1), len(present))
        assert (payload["title"], payload["start_frame"], payload["end_frame"],
                payload["filename_base"]) == (f"Spectrogram - Batch {b + 1}", start,
                                              end, "radar_data")
        intensity = np.array(payload["intensity"], dtype=np.float64)
        n_valid = int(present[start - 1:end].sum()) * pn - 19
        assert intensity.shape == (1024, n_valid)
        assert bool(np.isfinite(intensity).all())


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["production", "fidelity"])
def test_service_answers_on_card(card, small, tmp_path, profile):
    """RadarService on its default device, the card, with the 256-frame
    recording in local blob storage: three full-recording requests ("no")
    and two activity requests ("yes"). Fidelity is the default profile
    (nfft 4,096 for "no", 2,048 and 1,024 for the activity batches: K4)."""
    rec, _, _, present = small
    blobs, work = str(tmp_path / "blobs"), str(tmp_path / "work")
    os.makedirs(work)
    store = LocalStorage(blobs)
    xml, bin_ = write_recording(str(tmp_path / "radar_data"), rec)
    store.put(xml, "radar_data.xml")
    store.put(bin_, "radar_data.raw.bin")
    chosen = {} if profile == "fidelity" else {"profile": profile}
    hc = HandlerConfig(workdir=work, storage_spec=f"local:{blobs}", pretty_json=False,
                       **chosen)
    assert hc.profile == profile
    svc = RadarService(hc)
    cfg = _production()  # the recording's: the profiles share the device
    for _ in range(3):
        _serve_no(svc, work, _strong_target(cfg)[0])
    for _ in range(2):
        _serve_yes(svc, work, present, cfg.pn)


ARTIFACTS = ("spectrogram_data.json", "radar_data_range_fft_data.json",
             "radar_data_range_speed_data.json", "radar_data_fft_data.json",
             "spectrogram.png")


@pytest.mark.cuda
def test_http_process_on_card_from_worker_threads(card, small, tmp_path):
    """POST /process 'no' at the default profile through RadarHttpService
    on the card: each request runs on a worker thread of its own (the
    upload's page-locked ring and the read-back's page-locked buffers from
    a thread that did not create them), three in turn, and every artifact
    is byte-equal to one written by RadarService.main on this thread."""
    import threading
    import urllib.request

    from fmcw_radar_processing_tpu_torch.serve.http_service import RadarHttpService

    rec, _, _, _ = small
    blobs, work, here = (str(tmp_path / d) for d in ("blobs", "work", "here"))
    os.makedirs(work)
    os.makedirs(here)
    store = LocalStorage(blobs)
    xml, bin_ = write_recording(str(tmp_path / "radar_data"), rec)
    store.put(xml, "radar_data.xml")
    store.put(bin_, "radar_data.raw.bin")
    svc = RadarService(HandlerConfig(workdir=here, storage_spec=f"local:{blobs}",
                                     upload=False, pretty_json=False))
    assert svc.main({"processAnimalActivity": "no"})["status"] == "success"
    want = {n: open(os.path.join(here, n), "rb").read() for n in ARTIFACTS}

    threads = []
    main = RadarService.main

    def on_thread(self, request=None):
        threads.append(threading.current_thread())
        return main(self, request)

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    hc = HandlerConfig(workdir=work, storage_spec=f"local:{blobs}", pretty_json=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RadarService, "main", on_thread)
        with RadarHttpService(hc, port=0, host="127.0.0.1") as srv:
            for _ in range(3):
                req = urllib.request.Request(
                    srv.url + "process", data=b'{"processAnimalActivity": "no"}',
                    headers={"Content-Type": "application/json"})
                with opener.open(req, timeout=300) as r:
                    assert json.loads(r.read())["status"] == "success"
                for n in ARTIFACTS:
                    with open(os.path.join(blobs, n), "rb") as fh:
                        assert fh.read() == want[n], n
    assert len({id(t) for t in threads}) == 3
    assert threading.main_thread() not in threads


# --- the production recording at full size (65,536 frames) -------------------


@pytest.fixture(scope="module")
def full(card):
    """(cfg, raw, calib, the frames with targets) of the full recording."""
    cfg = _production()
    _, raw, cal, present = _recording(cfg, FRAMES, SEED)
    return cfg, raw, cal, present


@pytest.fixture(scope="module")
def main(card, full):
    """The default production path (impl "auto": K1a, K2a, K3) on the full
    recording: (its pipeline, its outputs, its launches)."""
    cfg, raw, cal, _ = full
    pipe = RadarPipeline(cfg, device=card)
    out, launches = _counted(pipe.process_recording, raw, cal)
    return pipe, out, launches


@pytest.fixture(scope="module")
def exact(card, full):
    """The exact chain on the full recording: impl "pallas_profile" (K1b,
    six bf16 passes) and stft_psd_precision "highest" (K2b), then K3:
    (its outputs, its launches)."""
    _, raw, cal, _ = full
    pipe = RadarPipeline(_production(stft_psd_precision="highest"), device=card,
                         impl="pallas_profile")
    return _counted(pipe.process_recording, raw, cal)


@pytest.fixture(scope="module")
def packed(main, full):
    """The default path's packed |slow-time| signal (1,048,576 samples)
    and its valid count."""
    cfg, raw, cal, _ = full
    chain = main[0].run_chain(raw, cal)
    signal, count = pack_slow_time(chain.strongest_chirps, chain.detected, cfg.pn)
    return pair_abs(signal).contiguous(), int(count)


def _stft_operator(cfg, nfft: int) -> StftOperator:
    return StftOperator.create(window_length=20, beta=3.0, nfft=nfft,
                               fs=1.0 / cfg.derived.prt)


@pytest.mark.cuda
@pytest.mark.slow
def test_production_main_path_at_full_size(main, full):
    """K1a, K2a and K3 once each, and no K1b, K2b, K4a or K4b; the targets
    found; a [1024, n] finite intensity and a [129, n] dB map normalized to
    0 dB, floored at DB_FLOOR, with no valid column at the floor."""
    cfg, _, _, present = full
    _, out, launches = main
    assert all(launches[k] == 1 for k in (K1A, K2A, K3))
    assert all(launches[k] == 0 for k in (K1B, K2B, K4A, K4B))
    _assert_targets(out, cfg, present)
    n_valid = int(out.detected.sum()) * cfg.pn - 19
    inten, psd = out.spectrogram_intensity, out.spectrogram_psd_db
    assert inten.shape == (1024, n_valid) and psd.shape == (129, n_valid)
    assert bool(np.isfinite(inten).all())
    assert float(psd.max()) == 0.0 and bool((psd >= DB_FLOOR).all())
    assert not (psd == DB_FLOOR).all(axis=0).any()


@pytest.mark.cuda
@pytest.mark.slow
def test_exact_chain_at_full_size(card, full, main, exact):
    """The exact chain runs K1b, K2b and K3 once each and nothing else,
    finds the targets, and its waterfall is within 120 dB of the exact
    float32 profile (the plain version, on the card); the default path
    (K1a's bf16x3) detects the same frames with the same ranges and speeds,
    its waterfall within 100 dB of the exact chain's."""
    cfg, raw, cal, present = full
    xout, launches = exact
    assert launches == _once_each(launches, K1B, K2B, K3)
    _assert_targets(xout, cfg, present)
    w = ftc.blocked_weight(cfg, card)
    off = ftc.calib_offset(torch.as_tensor(cal, device=card), w)
    x = torch.as_tensor(raw, device=card).reshape(-1, 2 * cfg.nts)
    prof = ftc.fast_time_profile_ref(x, w, off, cfg.pn)
    assert _snr_db(xout.waterfall, prof.T) >= 120.0  # the waterfall is (K, F)
    del x, prof
    out = main[1]
    for name in ("detected", "target_range", "target_speed"):
        np.testing.assert_array_equal(getattr(out, name), getattr(xout, name))
    assert _snr_db(out.waterfall, xout.waterfall) >= 100.0


@pytest.mark.cuda
@pytest.mark.slow
def test_k1c_chain_at_full_size(card, full, exact):
    """impl "pallas_profile_bf16": K1c, K2a and K3 once each and nothing
    else; at most 0.1% of the frames detected otherwise than the exact
    chain, ranges equal on the frames both detect."""
    cfg, raw, cal, _ = full
    pipe = RadarPipeline(cfg, device=card, impl="pallas_profile_bf16")
    out, launches = _counted(pipe.process_recording, raw, cal)
    assert launches == _once_each(launches, K1C, K2A, K3)
    _assert_held_to_exact(out, exact[0], 0.001)


@pytest.mark.cuda
@pytest.mark.slow
def test_bf16_psd_store_at_full_size(card, full):
    """stft_psd_store "bfloat16": K1a, K2a (its rounding flag) and K3 once
    each and nothing else; the frames with targets detected; a finite
    [1024, n] intensity and a dB map normalized to 0 dB."""
    cfg, raw, cal, present = full
    qcfg = _production(stft_psd_store="bfloat16")
    out, launches = _counted(RadarPipeline(qcfg, device=card).process_recording, raw, cal)
    assert launches == _once_each(launches, K1A, K2A, K3)
    np.testing.assert_array_equal(out.detected, present)
    n_valid = int(out.detected.sum()) * cfg.pn - 19
    assert out.spectrogram_intensity.shape == (1024, n_valid)
    assert bool(np.isfinite(out.spectrogram_intensity).all())
    assert float(out.spectrogram_psd_db.max()) == 0.0


@pytest.mark.cuda
@pytest.mark.slow
def test_pallas_impl_at_full_size(card, full, main):
    """impl "pallas" (K6, the range FFT stored, and K7): K6, K7, K2a and K3
    run, K1b and K2b do not; the targets found; the default path's
    waterfall within 100 dB of this exact float32 one."""
    cfg, raw, cal, present = full
    pipe = RadarPipeline(cfg, device=card, impl="pallas")
    out, launches = _counted(pipe.process_recording, raw, cal)
    assert all(launches[k] > 0 for k in (K6, K7, K2A, K3))
    assert launches[K2B] == 0 and launches[K1B] == 0
    _assert_targets(out, cfg, present)
    assert _snr_db(main[1].waterfall, out.waterfall) >= 100.0


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("impl", ["fused", "xla", "fused_bf16"])
def test_plain_impls_at_full_size(card, full, exact, impl):
    """The frame chains the JAX package runs in XLA, in plain PyTorch on the
    card: only the export's K2a and K3 run, once each; the detections those
    of the exact chain (at most 0.1% of frames otherwise for fused_bf16),
    ranges equal on the frames both detect."""
    _, raw, cal, _ = full
    out, launches = _counted(RadarPipeline(full[0], device=card, impl=impl
                                           ).process_recording, raw, cal)
    assert launches == _once_each(launches, K2A, K3)
    _assert_held_to_exact(out, exact[0], 0.001 if impl == "fused_bf16" else 0.0)


@pytest.mark.cuda
@pytest.mark.slow
def test_stft_xla_at_full_size(card, full, main, packed):
    """stft_impl "xla" (the plain export after K1a: operator product,
    float32 dB map, rescale, bf16 cast): K1a once and nothing else; the
    targets' frames detected; a float32 dB map off the bf16 grid; its bf16
    intensity, and the default path's, within 0.15 dB of the kernel export
    at float32 intensity on clim [-40, 0] (two bf16 roundings of one value
    may lie a whole ulp, 0.25 dB at -40 dB, apart, each within half an ulp
    of it)."""
    cfg, raw, cal, present = full
    scfg = _production(stft_impl="xla")
    out, launches = _counted(RadarPipeline(scfg, device=card).process_recording, raw, cal)
    assert launches == _once_each(launches, K1A)
    np.testing.assert_array_equal(out.detected, present)
    psd = torch.as_tensor(out.spectrogram_psd_db)
    assert psd.dtype == torch.float32
    assert int((psd.to(torch.bfloat16).float() != psd).sum()) > 0
    sig, count = packed
    ref = stc.spectrogram(sig, count, _stft_operator(cfg, 256),
                          intensity_dtype=torch.float32)[2]
    inten, kernels = out.spectrogram_intensity, main[1].spectrogram_intensity
    ref = ref[:, :inten.shape[1]].cpu().numpy()
    assert inten.shape == kernels.shape == ref.shape
    band = (ref >= -40.0) & (ref <= 0.0)
    assert float(np.abs(inten - ref)[band].max()) <= 0.15
    assert float(np.abs(kernels - ref)[band].max()) <= 0.15


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("nfft,pair,intensity_dtype", [
    (256, ("psd_tmax", "db_rescale_recompute"), torch.float32),  # nb_pad 136: K5a/K5b
    (1000, ("psd_tmax_tiled", "db_rescale_recompute_tiled"), torch.bfloat16),  # 504
])
def test_recompute_export_on_the_packed_signal(full, packed, nfft, pair,
                                               intensity_dtype):
    """spectrogram(recompute=True) on the default path's packed |signal|
    runs its recompute pair once each and nothing else, bit-equal to
    spectrogram(); and in every intensity dtype the pair's tmax, dB map and
    intensity are bit-equal to the materializing pair's (K2b then K3, or
    K4a then K4b; float32 dB map), each within their bounds of its plain
    version (tmax 1e-5 relative a 1,024-column tile, the dB map 1e-3 dB
    above -120 dB with the floors in the same places)."""
    cfg = full[0]
    sig, count = packed
    op = _stft_operator(cfg, nfft)
    (_, db_r, int_r), launches = _counted(stc.spectrogram, sig, count, op,
                                          intensity_dtype=intensity_dtype,
                                          recompute=True)
    assert launches == _once_each(launches, *pair)
    _, db_m, int_m = stc.spectrogram(sig, count, op, intensity_dtype=intensity_dtype)
    assert torch.equal(db_r, db_m) and torch.equal(int_r, int_m)
    del db_r, int_r, db_m, int_m
    nv, nb = count - 19, op.num_bins
    nb_pad = -(-nb // 8) * 8
    t_pad = -(-(sig.shape[0] - 19) // stc.PSD_TILE) * stc.PSD_TILE
    a2 = torch.as_tensor(stc._folded_operator(op, 8), device=sig.device)
    if nb_pad > stc.UNTILED_MAX_BINS:  # the bin-blocked pair's domain
        assert nb_pad <= stc.JAX_UNTILED_MAX_BINS
        phase1, phase2 = stc.psd_phase1_tiled, stc.db_rescale_tiled
        tmax_fn, rescale_fn = stc.psd_tmax_tiled, stc.db_rescale_recompute_tiled
    else:
        phase1, phase2 = stc.psd_phase1, stc.db_rescale
        tmax_fn, rescale_fn = stc.psd_tmax, stc.db_rescale_recompute
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        p, tmax = phase1(sig, nv, a2, nb_pad, t_pad)
        db, out = phase2(p, tmax.amax(), nb, 1024, torch.float32, dtype)
        del p
        tmax_r = tmax_fn(sig, nv, a2, nb_pad, t_pad)
        gmax = tmax_r.amax()
        db_r, out_r = rescale_fn(sig, nv, a2, gmax, nb, 1024, t_pad, dtype)
        assert torch.equal(tmax_r, tmax)
        assert torch.equal(db_r, db) and torch.equal(out_r, out)
        del db, out
        # One max per 1,024-column tile (the bin-blocked pair's are cut per
        # bin block too, bin block major).
        tmax_cols = tmax_r.reshape(-1, t_pad // stc.PSD_TILE).amax(0)
        tmax_ref = stc.psd_tmax_ref(sig, nv, a2, nb_pad, t_pad)
        assert bool(((tmax_cols - tmax_ref).abs() <= 1e-5 * tmax_ref.abs()).all())
        db_ref, out_ref = stc.db_rescale_recompute_ref(sig, nv, a2, gmax, nb, 1024,
                                                       t_pad, dtype)
        assert torch.equal(db_r == DB_FLOOR, db_ref == DB_FLOOR)
        assert float((db_r - db_ref).abs()[db_ref > -120].max()) <= 1e-3
        _assert_intensity_within(out_r, out_ref, dtype)
        del db_r, out_r, db_ref, out_ref


@pytest.mark.cuda
@pytest.mark.slow
def test_matmul_and_rescale_precision_at_full_size(card, full):
    """stft_impl "xla", whose products go through utils/cplx.py::
    precision_matmul, at matmul_precision = rescale_precision "highest",
    "high" and "default" (exact float32, three and one bf16 passes on the
    card): K1a once a recording and no other kernel; "highest" detects the
    frames with targets, and the detections, ranges and speeds of the
    other two are identical to its."""
    _, raw, cal, present = full
    first = None
    for p in ("highest", "high", "default"):
        cfg = _production(stft_impl="xla", matmul_precision=p, rescale_precision=p)
        rec, launches = _counted(RadarPipeline(cfg, device=card).process_recording,
                                 raw, cal)
        assert launches == _once_each(launches, K1A)
        meas = (rec.detected, rec.target_range, rec.target_speed)
        del rec
        if first is None:
            np.testing.assert_array_equal(meas[0], present)
            first = meas
        for got, want in zip(meas, first):
            np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.slow
def test_production_bit_equal_with_the_precision_plumbing_bypassed(card, full,
                                                                   monkeypatch):
    """AlgorithmConfig.production() keeps matmul_precision "highest"; its
    outputs are bit-equal to the same call with every product the exact
    float32 torch.matmul (utils/cplx.py::takes_mxu_passes false), and that
    predicate was never asked on the way: every product took the exact
    branch."""
    cfg, raw, cal, _ = full
    assert cfg.algorithm.matmul_precision == "highest"
    pipe = RadarPipeline(cfg, device=card)
    asked = []
    real = cplx.takes_mxu_passes
    monkeypatch.setattr(cplx, "takes_mxu_passes", lambda t: asked.append(t.device) or real(t))
    a = pipe.process_recording(raw, cal)
    monkeypatch.setattr(cplx, "takes_mxu_passes", lambda t: False)
    b = pipe.process_recording(raw, cal)
    for name in ("waterfall", "detected", "target_range", "target_speed",
                 "spectrogram_intensity", "spectrogram_psd_db"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert not asked
