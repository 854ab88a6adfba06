"""PyTorch port: the native streaming recording reader
(io/native_loader.py) and ``io/raw_format.py::load_recording_for_chain``.

tests/test_native_io.py's six cases, each held byte for byte to the port's
NumPy reader and to the JAX package's ``NativeRecordingReader`` on the same
file; then ``load_recording_for_chain`` (native, and the NumPy reader
without the library) against JAX's, the service's loader on top of it, and
the atomic build into the port's ``build/``.
"""

import os

import numpy as np
import pytest

from fmcw_radar_processing_tpu.io import native_loader as jnative
from fmcw_radar_processing_tpu.io.raw_format import (
    load_recording_for_chain as jload_recording_for_chain,
)
from fmcw_radar_processing_tpu_torch.io import native_loader as tnative
from fmcw_radar_processing_tpu_torch.io.native_loader import (
    NativeRecordingReader,
    native_available,
)
from fmcw_radar_processing_tpu_torch.io.raw_format import (
    RawRecording,
    load_recording_for_chain,
    read_raw_bin,
    write_raw_bin,
    write_recording,
)
from fmcw_radar_processing_tpu_torch.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu_torch.serve.handler import load_recording
from fmcw_radar_processing_tpu_torch.utils import native_build
from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

pytestmark = pytest.mark.skipif(
    not native_available(), reason="no C++ toolchain for native IO")


@pytest.fixture
def recording(cfg, tmp_path):
    rec = synthesize_recording(
        cfg, 12, (SyntheticTarget(range_m=7.5, doppler_bin_offset=2),),
        seed=5, n_cal_factor=4)
    path = str(tmp_path / "r.raw.bin")
    write_raw_bin(path, rec)
    return path, rec


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_header(recording, cfg):
    path, rec = recording
    r, j = NativeRecordingReader(path), jnative.NativeRecordingReader(path)
    assert r.frame_count == 12
    assert r.num_rx == cfg.device.num_rx_antennas
    assert (r.pn, r.nts) == (cfg.pn, cfg.nts)
    assert r.is_complex
    for k in ("version", "frame_count", "num_rx", "n_cal", "pn", "nts", "flags"):
        assert getattr(r, k) == getattr(j, k), k


def test_frames_match_numpy_reader(recording):
    """A whole read and a windowed read of the second antenna: the NumPy
    reader's pairs and JAX's native reader's, byte for byte."""
    path, rec = recording
    r, j = NativeRecordingReader(path), jnative.NativeRecordingReader(path)
    np_rec = read_raw_bin(path)
    _same(r.read_frames(0, 12, rx=0), to_pair(np_rec.frames[:, 0]))
    _same(r.read_frames(0, 12, rx=0), rec.rx1_pair())
    _same(r.read_frames(3, 4, rx=1), to_pair(np_rec.frames[3:7, 1]))
    _same(r.read_frames(3, 4, rx=1), j.read_frames(3, 4, rx=1))


def test_calib_vector_matches(recording, cfg):
    path, rec = recording
    r, j = NativeRecordingReader(path), jnative.NativeRecordingReader(path)
    got = r.calib_vector_pair(rx=0, nts=cfg.nts)
    np.testing.assert_allclose(got, rec.calib_pair(0, cfg.nts), rtol=1e-6)
    _same(got, j.calib_vector_pair(rx=0, nts=cfg.nts))
    _same(r.calib_vector_pair(rx=1), j.calib_vector_pair(rx=1))


def test_real_recording_zero_imag(cfg, tmp_path):
    rec = synthesize_recording(cfg, 3, (), seed=1)
    real_frames = rec.frames.real.astype(np.float32)
    path = str(tmp_path / "real.raw.bin")
    write_raw_bin(path, RawRecording(frames=real_frames, calib=rec.calib))
    r = NativeRecordingReader(path)
    assert not r.is_complex
    got = r.read_frames(0, 3, rx=0)
    np.testing.assert_array_equal(got[..., 0], real_frames[:, 0])
    assert np.all(got[..., 1] == 0.0)
    _same(got, jnative.NativeRecordingReader(path).read_frames(0, 3, rx=0))


def test_iter_batches(recording):
    path, _ = recording
    r = NativeRecordingReader(path)
    got = list(r.iter_batches(5))
    assert [s for s, _ in got] == [0, 5, 10]
    assert [b.shape[0] for _, b in got] == [5, 5, 2]
    for (s, b), (sj, bj) in zip(got, jnative.NativeRecordingReader(path).iter_batches(5)):
        assert s == sj
        _same(b, bj)


def test_out_of_range_rejected(recording):
    path, _ = recording
    r = NativeRecordingReader(path)
    with pytest.raises(IOError):
        r.read_frames(10, 5)
    with pytest.raises(IOError):
        r.read_frames(0, 1, rx=9)
    with pytest.raises(ValueError, match="failed to parse"):
        NativeRecordingReader(path + ".missing")


@pytest.mark.parametrize("native", [True, False])
def test_load_recording_for_chain_matches_jax(cfg, tmp_path, monkeypatch, native):
    """The chain's pair layout and the device config, natively and through
    the NumPy reader (the library unavailable), equal to JAX's loader."""
    rec = synthesize_recording(cfg, 9, (SyntheticTarget(range_m=5.0),), seed=2)
    base = str(tmp_path / "rec")
    write_recording(base, rec)
    if not native:
        monkeypatch.setattr(tnative, "native_available", lambda: False)
    raw, calib, device = load_recording_for_chain(base)
    jraw, jcalib, jdevice = jload_recording_for_chain(base)
    _same(raw, np.asarray(jraw))
    _same(calib, np.asarray(jcalib))
    assert raw.shape == (9, cfg.pn, cfg.nts, 2)
    for f in ("pn", "nts", "num_rx_antennas", "chirp_duration_ns"):
        assert getattr(device, f) == getattr(jdevice, f), f
    flat, fcalib, _ = load_recording(base)  # the service's loader
    _same(flat, raw.reshape(9, cfg.pn, 2 * cfg.nts))
    _same(fcalib, calib)


def test_load_recording_for_chain_rejects_a_mismatched_header(cfg, tmp_path):
    """A raw.bin whose PN disagrees with its XML raises, as JAX's does."""
    rec = synthesize_recording(cfg, 2, (), seed=1)
    base = str(tmp_path / "rec")
    write_recording(base, rec)
    write_raw_bin(base + ".raw.bin", RawRecording(frames=rec.frames[:, :, :8],
                                                  calib=rec.calib))
    with pytest.raises(ValueError, match="disagrees with XML"):
        load_recording_for_chain(base)
    with pytest.raises(ValueError, match="disagrees with XML"):
        jload_recording_for_chain(base)


def test_build_is_atomic_into_the_port_build_dir(tmp_path, monkeypatch):
    """The library is compiled to a temporary name and moved into place, in
    the directory given (the port's own ``build/``), leaving no temporary
    file behind."""
    assert os.path.basename(os.path.dirname(os.path.abspath(native_build.BUILD_DIR))) == (
        "fmcw_radar_processing_tpu_torch")
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    lib = tnative._build_and_load()
    assert lib.fmcw_parse_header is not None
    assert sorted(os.listdir(tmp_path / "build")) == ["libfmcw_io.so"]
