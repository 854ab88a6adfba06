"""PyTorch port: the entry points of ``entry.py`` (the counterparts of
``__graft_entry__.py``), the profiler trace and ``process --trace-dir``.

``entry("cpu")``'s forward is held to ``__graft_entry__.entry``'s on the
same 64 frames with the repo's chain and export bounds.
``dryrun_multichip`` runs at 1, 2 and 4 gloo ranks on the CPU (it checks
every path against the single-process chain itself and raises on a
mismatch), and raises when a path is broken.
"""

import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from fmcw_radar_processing_tpu.serve.cli import main as jax_cli
from fmcw_radar_processing_tpu_torch import entry as tentry
from fmcw_radar_processing_tpu_torch.serve.cli import main as cli
from fmcw_radar_processing_tpu_torch.utils.observe import trace


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_jax():
    """The same recording (64 frames, two targets, seed 0) and the same
    forward: detections and ranges exact, the waterfall at the oracle
    bound (rtol 3e-4 / atol 0.05), speeds rtol 1e-5, the intensity within
    2e-3 dB above −40 dB and 0.2 dB down to −120 dB."""
    fn, (raw, calib) = tentry.entry("cpu")
    got = {k: v.numpy() for k, v in fn(raw, calib).items()}
    jfn, jargs = graft.entry()
    want = {k: np.asarray(v) for k, v in jfn(*jargs).items()}
    np.testing.assert_array_equal(raw.numpy().reshape(jargs[0].shape),
                                  np.asarray(jargs[0]))
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["detected"], want["detected"])
    assert got["detected"].any()
    np.testing.assert_array_equal(got["range"], want["range"])
    np.testing.assert_allclose(got["speed"], want["speed"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["waterfall"], want["waterfall"], rtol=3e-4,
                               atol=0.05)
    np.testing.assert_allclose(got["strength"], want["strength"], rtol=3e-4,
                               atol=0.05)
    a, b = got["spectrogram_intensity"], want["spectrogram_intensity"]
    assert a.shape == b.shape == (1024, 64 * 16 - 19)
    band, deep = b > -40, b > -120
    np.testing.assert_allclose(a[band], b[band], atol=2e-3)
    np.testing.assert_allclose(a[deep], b[deep], atol=0.2)
    np.testing.assert_array_equal(a == -1000.0, b == -1000.0)


_DRY: dict = {}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_dryrun_multichip(world):
    """Every path of the JAX dryrun (the dp Trainer step, the dp chain,
    tp and pp at even worlds, the sp STFT, the sp recording, the multihost
    feed, streaming over the mesh) passes its check on every rank; each
    rank reports its wall time and K1a's launches (none on the CPU). The
    three worlds share one spawn of four ranks."""
    if not _DRY:
        _DRY.update(tentry.dryrun_multichip((1, 2, 4), "gloo", "cpu", threads=1))
    reports = _DRY[world]
    assert [r["rank"] for r in reports] == list(range(world))
    paths = [p for p in tentry.PATHS if world % 2 == 0 or p not in ("tp", "pp")]
    for r in reports:
        assert (r["world"], r["backend"]) == (world, "gloo")
        assert "card" not in r and "uuid" not in r  # no card: no placement
        for p in paths:
            assert r[p]["seconds"] > 0 and r[p]["k1a"] == 0, p
            # the stateless paths are timed a second time too
            assert (r[p].get("second_s", 0) > 0) == (p not in ("train", "stream")), p
        assert r["sp"]["intensity_max_abs_err_db"] <= 2e-3
        assert r["sp"]["gather_s"] > 0


def test_dryrun_raises_on_a_broken_path(monkeypatch):
    """A dp chain that loses a frame's detection fails the dryrun."""
    from fmcw_radar_processing_tpu_torch.parallel import sharded_chain

    make = sharded_chain.make_sharded_frame_chain

    def broken(*args, **kwargs):
        chain = make(*args, **kwargs)

        def run(raw, calib):
            out = chain(raw, calib)
            return out._replace(detected=torch.zeros_like(out.detected))
        return run

    monkeypatch.setattr(sharded_chain, "make_sharded_frame_chain", broken)
    with pytest.raises(AssertionError, match="dp-sharded chain: detected"):
        tentry.dryrun_multichip(1, "gloo", "cpu", paths=("dp",))
    assert not torch.distributed.is_initialized()


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "new" / "trace"
    with trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(d / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_cli_process_trace_dir(tmp_path, capsys):
    """process --trace-dir writes the trace and the payloads, and prints
    the table of the traced call's spans, each recording.* span once, as
    in the trace's annotations; a directory that cannot be created is an
    error (exit 1), as in the JAX CLI."""
    base = str(tmp_path / "rec")
    assert cli(["synth", base, "--frames", "8"]) == 0
    out, tr = str(tmp_path / "out"), str(tmp_path / "tr")
    assert cli(["process", base, "--output-dir", out, "--device", "cpu",
                "--trace-dir", tr, "--compact-json"]) == 0
    assert len(os.listdir(tr)) == 1
    assert "spectrogram_data.json" in os.listdir(out)
    printed = capsys.readouterr().out
    assert f"profiler trace in {tr}" in printed
    table = printed.split(f"profiler trace in {tr}\n", 1)[1].splitlines()
    with open(os.path.join(tr, os.listdir(tr)[0])) as f:
        events = json.load(f)["traceEvents"]
    annotated = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ("recording.upload", "recording.chain_wait",
                 "recording.decode_copy", "recording.decode_widen"):
        assert annotated.count(name) == 1, name
        assert any(row.split()[:2] == [name, "1"] for row in table), name
    blocker = tmp_path / "file"
    blocker.write_text("")
    bad = str(blocker / "trace")
    assert cli(["process", base, "--device", "cpu", "--trace-dir", bad]) == 1
    port_err = capsys.readouterr().err
    assert jax_cli(["process", base, "--trace-dir", bad]) == 1
    jax_err = capsys.readouterr().err
    assert port_err.startswith(f"cannot create trace dir {bad}:")
    assert port_err == jax_err
