"""PyTorch port: the fidelity profile past nfft 512 — the bin-blocked export
pair K4a/K4b, the pipeline's store-dtype rule, activity mode and the
literal fft snapshot — vs the JAX package on the CPU.

On the CPU the K4 wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode (its tiled pair past nb_pad 512), as its
own tests do. Tolerances are those of tests/test_stft_pallas.py and
tests/test_torch_pipeline.py.
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu.dsp import stft as jstft
from fmcw_radar_processing_tpu.pipeline.recording import (
    RadarPipeline as JaxPipeline,
)
from fmcw_radar_processing_tpu_torch.dsp import stft as tstft
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR
from fmcw_radar_processing_tpu_torch.ops import stft_cuda as stc
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.serve.cli import main as cli_main

from .test_pipeline import _mixed_recording, _tpu_layout
from .test_torch_ops import assert_within_one_bf16_ulp

jstp = importlib.import_module("fmcw_radar_processing_tpu.ops.stft_pallas")

OP_KW = dict(window_length=20, beta=3.0, fs=1000.0, hop=1)


def _signal(l, count, seed=11):
    """The input of tests/test_stft_pallas.py::test_tiled_matches_xla_composition."""
    rng = np.random.default_rng(seed)
    sig = np.zeros(l, np.float32)
    sig[:count] = np.abs(
        rng.standard_normal(count) + 0.5 * np.sin(np.arange(count) * 0.17)
    ).astype(np.float32)
    return sig


def _jax_tiled(sig, count, nfft, **kw):
    op = jstft.StftOperator.create(nfft=nfft, **OP_KW)
    assert jstp.resolves_tiled(op)
    out = jstp.spectrogram_pallas(jnp.asarray(sig), jnp.asarray(count), op,
                                  tile=512, tile2=256, **kw)
    return [np.asarray(a) for a in out]


def _port(sig, count, nfft, **kw):
    op = tstft.StftOperator.create(nfft=nfft, **OP_KW)
    return [a.numpy() for a in stc.spectrogram(torch.as_tensor(sig), count, op, **kw)]


# --- K4a/K4b plain versions vs the Pallas tiled pair ------------------------

TILED_CASES = [(2048, 1400, 1400), (1024, 1536, 1200)]


@pytest.mark.parametrize("nfft,l,count", TILED_CASES)
def test_k4_plain_matches_pallas_tiled(nfft, l, count):
    sig = _signal(l, count)
    p, db, intensity = _port(sig, count, nfft)
    p_j, db_j, int_j = _jax_tiled(sig, count, nfft)
    assert p.shape == p_j.shape and intensity.shape == int_j.shape
    np.testing.assert_allclose(p, p_j, rtol=1e-4, atol=1e-10)
    m = db_j > -120
    np.testing.assert_allclose(db[m], db_j[m], atol=1e-3)
    np.testing.assert_array_equal(db == DB_FLOOR, db_j == DB_FLOOR)
    mi = int_j > -120
    np.testing.assert_allclose(intensity[mi], int_j[mi], atol=2e-3)
    ncols = count - 20 + 1
    assert np.all(p[:, ncols:] == 0.0)
    assert np.all(db[:, ncols:] == DB_FLOOR)
    np.testing.assert_allclose(intensity[:, ncols:], int_j[:, ncols:], atol=0.2)


@pytest.mark.parametrize("nfft,l,count", TILED_CASES)
def test_k4_plain_int8_emission_matches_pallas_tiled(nfft, l, count):
    """Decoded int8 codes within half a quantization step (+ 2e-3 of float32
    rounding fuzz) of the JAX float32 intensity in range, clamped below it;
    codes at most one apart from the JAX int8 codes."""
    sig = _signal(l, count)
    codes = _port(sig, count, nfft, intensity_dtype=torch.int8)[2]
    assert codes.dtype == np.int8
    int_j = _jax_tiled(sig, count, nfft)[2]
    codes_j = _jax_tiled(sig, count, nfft, intensity_dtype=jnp.int8)[2]
    dec = tstft.decode_db_int8(codes)
    lo, hi = tstft.INT8_DB_RANGE
    inside = (int_j > lo + 0.1) & (int_j < hi - 0.1)
    assert inside.sum() > 100
    np.testing.assert_allclose(dec[inside], int_j[inside],
                               atol=tstft.int8_db_step() / 2 + 2e-3)
    assert np.all(dec[int_j < lo - 0.5] == np.float32(lo))
    assert np.abs(codes.astype(np.int32) - codes_j.astype(np.int32)).max() <= 1


# --- the K4 host builders ---------------------------------------------------


@pytest.mark.parametrize("nfft", [1024, 16384, 65536])
def test_k4_folded_operator_bit_equal(nfft):
    """The folded operator at K4's alignments (8, or 16 under a bf16 dB
    store) and at the JAX tiled path's 128."""
    op_t = tstft.StftOperator.create(nfft=nfft, **OP_KW)
    op_j = jstft.StftOperator.create(nfft=nfft, **OP_KW)
    for align in (8, 16, 128):
        np.testing.assert_array_equal(stc._folded_operator(op_t, align),
                                      jstp._folded_operator(op_j, align))


@pytest.mark.parametrize("nb", [1025, 8193, 32769])
def test_log_interp_gather_bit_equal_at_large_nb(nb):
    """K4b's gather tables hold exactly the two nonzeros of each row of the
    JAX package's dense interpolation matrix, and nothing else is nonzero."""
    i0, w0, w1 = stc._log_interp_gather(nb, 1024)
    w = jstft._log_interp_matrix(nb, 1024)
    rows = np.arange(1024)
    np.testing.assert_array_equal(w[rows, i0], w0)
    np.testing.assert_array_equal(w[rows, i0 + 1], w1)
    assert np.count_nonzero(w) == np.count_nonzero(w0) + np.count_nonzero(w1)
    assert i0.min() >= 0 and i0.max() == nb - 2
    assert np.all(np.diff(i0) >= 0)  # nondecreasing: K4b's row ranges rely on it


@pytest.mark.parametrize("nb,align", [(1025, 8), (8193, 8), (32769, 16)])
def test_k4b_bin_block_rows(nb, align):
    """Every output row is emitted by exactly one bin block: the one holding
    i0, whose kb own rows plus its halo row also hold i0 + 1."""
    nb_pad = -(-nb // align) * align
    kb = stc.BIN_BLOCK
    o_start = stc._bin_block_rows(nb, 1024, nb_pad)
    i0 = stc._log_interp_gather(nb, 1024)[0]
    n_blocks = -(-nb_pad // kb)
    assert o_start.dtype == np.int32 and o_start.shape == (n_blocks + 1,)
    assert o_start[0] == 0 and o_start[-1] == 1024
    assert np.all(np.diff(o_start) >= 0)
    block = np.searchsorted(o_start, np.arange(1024), side="right") - 1
    np.testing.assert_array_equal(block, i0 // kb)
    halo_end = np.minimum((block + 1) * kb + 1, nb_pad)  # rows on chip
    assert np.all(i0 + 1 < halo_end)
    if nb_pad % kb:  # a partial last block
        assert nb_pad - (n_blocks - 1) * kb < kb
    if nb == 8193:
        assert o_start[1] == 551  # the first 128 bins own over half the rows


# --- the pipeline: store dtypes on the bin-blocked path (the repaired fault) -


@pytest.mark.parametrize("nfft", [1024, 2048])
def test_production_pinned_large_nfft_stores_f32_db(cfg, rng, nfft):
    """production(stft_nfft > 512): the JAX pipeline takes its tiled export
    and stores the dB map in float32 whatever stft_db_store says; the port
    must too (it used to hand back a bf16-rounded map, up to 0.125 dB off)."""
    frames, calib = _mixed_recording(cfg, rng, f=24)
    raw = _tpu_layout(frames)
    dev = default_device_config()
    got = RadarPipeline(
        RadarConfig.create(dev, AlgorithmConfig.production(stft_nfft=nfft)),
        device="cpu").process_recording(raw, calib)
    want = JaxPipeline(
        RadarConfig.create(dev, AlgorithmConfig.production(
            stft_nfft=nfft, stft_impl="pallas")),
        impl="pallas_profile_high").process_recording(raw, calib)
    a, b = got.spectrogram_psd_db, want.spectrogram_psd_db
    assert a.shape == b.shape == (nfft // 2 + 1, got.spectrogram_times.shape[0])
    m = b > -40
    assert m.sum() > 1000
    np.testing.assert_allclose(a[m], b[m], atol=1e-3)
    np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)
    ai, bi = got.spectrogram_intensity, want.spectrogram_intensity
    assert_within_one_bf16_ulp(ai, bi, bi > -120, 1e-3)


# --- activity mode ------------------------------------------------------------


def _jax_pipeline(profile: str, **algo):
    dev = default_device_config()
    if profile == "production":
        cfg = RadarConfig.create(dev, AlgorithmConfig.production(
            stft_impl="pallas", **algo))
        return JaxPipeline(cfg, impl="pallas_profile_high")
    return JaxPipeline(RadarConfig.create(dev, AlgorithmConfig(
        stft_impl="pallas", **algo)))


def _port_pipeline(profile: str, **algo):
    algo_cfg = (AlgorithmConfig.production(**algo) if profile == "production"
                else AlgorithmConfig(**algo))
    return RadarPipeline(RadarConfig.create(default_device_config(), algo_cfg),
                         device="cpu")


def assert_intensity_close(a, b, profile: str) -> None:
    """Fidelity: 2e-3 dB in the display band, 0.2 dB down to −120 dB;
    production (bf16 intensity): one bf16 ulp above −120 dB."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    if profile == "production":
        assert_within_one_bf16_ulp(a, b, b > -120, 1e-3)
    else:
        band = b > -40
        np.testing.assert_allclose(a[band], b[band], atol=2e-3)
        np.testing.assert_allclose(a[b > -120], b[b > -120], atol=0.2)
    np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)


@pytest.mark.parametrize("profile", ["fidelity", "production"])
@pytest.mark.parametrize("f,algo", [(150, {"batch_size": 60, "max_plots": 3}),
                                    (250, {})])
def test_process_activity_matches_jax(cfg, rng, profile, f, algo):
    """Same batches, frame ranges, filenames and times; intensity within
    the profile's tolerance. Under fidelity the 150-frame case mixes tiled
    (nfft 1024) and untiled (nfft 512) batches."""
    frames, calib = _mixed_recording(cfg, rng, f=f)
    raw = _tpu_layout(frames)
    got = _port_pipeline(profile, **algo).process_activity(raw, calib)
    want = _jax_pipeline(profile, **algo).process_activity(raw, calib)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.batch, g.start_frame, g.end_frame, g.filename) == (
            w.batch, w.start_frame, w.end_frame, w.filename)
        assert g.payload.keys() == w.payload.keys()
        for key in g.payload:
            if key in ("time", "frequency"):
                np.testing.assert_array_equal(g.payload[key], w.payload[key])
            elif key == "intensity":
                assert_intensity_close(g.payload[key], w.payload[key], profile)
            else:
                assert g.payload[key] == w.payload[key], key


def test_process_activity_skips_batches_without_signal(cfg, rng):
    """A batch with fewer than one window of slow-time samples writes no
    JSON and does not count toward max_plots (radar_processing.m:534,601)."""
    frames, calib = _mixed_recording(cfg, rng, f=90)
    frames[30:60] = 0.003 * (rng.standard_normal(frames[30:60].shape)
                             + 1j * rng.standard_normal(frames[30:60].shape))
    raw = _tpu_layout(frames)
    algo = {"batch_size": 30, "max_plots": 2}
    got = _port_pipeline("fidelity", **algo).process_activity(raw, calib)
    want = _jax_pipeline("fidelity", **algo).process_activity(raw, calib)
    assert [b.batch for b in got] == [b.batch for b in want] == [1, 3]


# --- the literal fft snapshot ---------------------------------------------------


@pytest.mark.parametrize("profile", ["fidelity", "production"])
def test_literal_snapshot_matches_jax(cfg, rng, profile):
    frames, calib = _mixed_recording(cfg, rng, f=12)
    raw = _tpu_layout(frames)
    algo = {"compat_linear_index_snapshot": True}
    got = _port_pipeline(profile, **algo).process_recording(raw, calib)
    want = _jax_pipeline(profile, **algo).process_recording(raw, calib)
    a = got.payloads["radar_data_fft_data.json"]
    b = want.payloads["radar_data_fft_data.json"]
    assert a.keys() == b.keys() and a["frame_index"] == b["frame_index"] == 100
    np.testing.assert_array_equal(a["range_bins"], b["range_bins"])
    # The "magnitude" tolerance of test_service_payloads_match_jax: |rf| is
    # a difference of float32 values near 1e3, so near its nulls the two
    # frameworks' summation orders leave ~1e-4 absolute.
    np.testing.assert_allclose(a["magnitude"], b["magnitude"], rtol=1e-5,
                               atol=1e-2)
    # Chirp 100 overall is frame 7, chirp 4 (PN 16) — not frame 100's profile.
    assert not np.allclose(a["magnitude"], got.waterfall[:, 6])


# --- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["fidelity", "production"])
def test_cli_activity_flags(tmp_path, capsys, algo):
    from fmcw_radar_processing_tpu.io.storage import LocalStorage

    base = str(tmp_path / "rec")
    assert cli_main(["synth", base, "--frames", "130"]) == 0
    out = tmp_path / "out"
    assert cli_main(["process", base, "--activity", "--device", "cpu",
                     "--algo", algo, "--output-dir", str(out),
                     "--compact-json", "--profile"]) == 0
    names = ["rec_spectrogram_batch_1.json", "rec_spectrogram_batch_2.json"]
    assert sorted(p.name for p in out.iterdir()) == names
    assert "activity_batches" in capsys.readouterr().out
    batch = json.loads((out / names[1]).read_text())
    assert (batch["title"], batch["start_frame"], batch["end_frame"]) == (
        "Spectrogram - Batch 2", 101, 130)
    store = LocalStorage(str(tmp_path / "blobs"))
    store.put(base + ".xml", "radar_data.xml")
    store.put(base + ".raw.bin", "radar_data.raw.bin")
    work = tmp_path / "work"
    work.mkdir()
    assert cli_main(["serve-once", "--activity", "--device", "cpu",
                     "--profile", algo, "--workdir", str(work),
                     "--storage", f"local:{tmp_path / 'blobs'}"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert result["steps"][1]["artifacts"] == [
        "radar_data_spectrogram_batch_1.json",
        "radar_data_spectrogram_batch_2.json"]
    assert result["steps"][2]["message"] == "Uploaded 2 artifact(s) to storage."
