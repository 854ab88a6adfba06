"""The seeded generator against the port's ``io/synth.py``, and the plain
reference against the port's CPU path, at a tiny size, compared as NumPy.
(The reference itself imports nothing of the port; these tests do, to
hold the two to each other.)"""

from __future__ import annotations

import ast
import json

import numpy as np
import torch

from radarbench.gen import synth
from radarbench.reference import chain as ref_chain
from radarbench.reference.compare import lin_gap, next_pow2
from radarbench.reference.export import StftRef
from radarbench.tests.conftest import REPO

CFG = json.loads((REPO / "radarbench" / "configs" / "production-65k.json").read_text())
TARGETS = json.loads((REPO / "radarbench" / "traffic" / "recording.json").read_text())["targets"]


def _port_config(**alg):
    from fmcw_radar_processing_tpu_torch.config import RadarConfig
    from fmcw_radar_processing_tpu_torch.config.radar import AlgorithmConfig, DeviceConfig

    return RadarConfig.create(DeviceConfig(**CFG["device"]),
                              AlgorithmConfig(**{**CFG["algorithm"], **alg}))


def _recording(frames=200, seed=3, **kw):
    raw, calib, present = synth.recording(CFG["device"], CFG["algorithm"], frames, TARGETS,
                                          gen=synth.generator(seed, "cpu"), device="cpu", **kw)
    return raw.numpy(), calib.numpy(), present.numpy()


def test_generator_matches_io_synth_without_noise():
    from fmcw_radar_processing_tpu_torch.io.synth import SyntheticTarget, synthesize_recording
    from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

    raw, calib, present = _recording(frames=40, noise_sigma=0.0)
    rec = synthesize_recording(_port_config(), 40, tuple(SyntheticTarget(**t) for t in TARGETS),
                               noise_sigma=0.0, target_present=present)
    want = to_pair(rec.rx1()).reshape(raw.shape)
    np.testing.assert_allclose(raw, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(calib, to_pair(rec.calib_vector(0, 64)), rtol=0, atol=1e-7)


def test_generator_noise_muting_and_seed():
    raw, _, present = _recording(frames=400, seed=11)
    quiet, _, _ = _recording(frames=400, seed=11, noise_sigma=0.0)
    noise = raw - quiet
    assert abs(float(noise.std()) - 0.01) < 5e-4
    assert int((~present).sum()) == 40  # exactly 10% muted
    again, _, present2 = _recording(frames=400, seed=11)
    assert np.array_equal(raw, again) and np.array_equal(present, present2)
    other, _, present3 = _recording(frames=400, seed=12)
    assert not np.array_equal(raw, other) and int((~present3).sum()) == 40
    blocks = synth.muted_mask(400, 100, 0.1, synth.generator(5, "cpu"), "cpu")
    assert [int((~b).sum()) for b in blocks.reshape(4, 100)] == [10] * 4


def test_reference_chain_matches_the_port_chain():
    from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import make_frame_chain

    raw, calib, present = _recording()
    got = make_frame_chain(_port_config(), "cpu", impl="pallas_profile")(
        torch.as_tensor(raw), torch.as_tensor(calib))
    ref = ref_chain.chain(torch.as_tensor(raw), torch.as_tensor(calib),
                          CFG["device"], CFG["algorithm"])
    prof = ref.profile.numpy()
    np.testing.assert_allclose(got.waterfall.numpy(), prof, rtol=0, atol=2e-6 * prof.max())
    assert np.array_equal(got.detected.numpy(), ref.detected.numpy())
    assert np.array_equal(ref.detected.numpy(), present)
    d = ref_chain.derived(CFG["device"], CFG["algorithm"])
    det = present
    np.testing.assert_array_equal(np.rint(got.range.numpy()[0, det] / d.dist_per_bin),
                                  ref.range_bin.numpy()[det])
    np.testing.assert_array_equal(np.rint(got.speed.numpy()[0, det] / d.speed_step),
                                  ref.doppler_offset.numpy()[det])
    assert set(ref.range_bin.numpy()[det]) == {40}  # 7.5 m, the strong target
    assert set(ref.doppler_offset.numpy()[det]) == {3}
    rows = got.strongest_chirps.numpy()
    want = ref.rows.numpy()
    np.testing.assert_allclose(rows[det, :, 0] + 1j * rows[det, :, 1], want[det],
                               rtol=0, atol=2e-6 * np.abs(want).max())


def test_reference_export_matches_the_ports_float32_export():
    """The port's exact export (float32 maps, "highest") against the
    reference: dB map and intensity within 1e-6 in the linear domain."""
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline

    raw, calib, _ = _recording()
    pc = _port_config(intensity_dtype="float32", stft_db_store="float32",
                      stft_psd_precision="highest")
    out = RadarPipeline(pc, device="cpu", impl="pallas_profile").process_recording(raw, calib)
    ref = ref_chain.chain_blocked(raw, calib, CFG["device"], CFG["algorithm"], "cpu")
    mag = ref.rows
    a = CFG["algorithm"]
    d = ref_chain.derived(CFG["device"], a)
    stft = StftRef(a["stft_window_length"], a["stft_kaiser_beta"],
                   a["stft_nfft"] or next_pow2(mag.shape[0]), 1 / d.prt, a["max_freq_bins"],
                   "cpu")
    n = stft.columns(mag.shape[0])
    p = stft.power(mag, 0, n)
    db = stft.db(p, p.amax())
    assert out.spectrogram_psd_db.shape == tuple(db.shape)
    assert lin_gap(torch.as_tensor(out.spectrogram_psd_db), db) < 1e-6
    assert lin_gap(torch.as_tensor(out.spectrogram_intensity), stft.rescale(db)) < 1e-6
    np.testing.assert_allclose(out.spectrogram_times, stft.times(n), rtol=3e-7)
    np.testing.assert_allclose(out.spectrogram_freqs, stft.log_freqs(), rtol=3e-7)


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "radarbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in {"__future__", "numpy", "torch", "typing",
                                           "radarbench"}, (path.name, n)
                assert not n.startswith("radarbench.") or n.startswith("radarbench.reference"), n
