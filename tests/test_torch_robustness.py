"""PyTorch port: the robustness sweep against the JAX package's
``models/robustness.py``, on the CPU at toy sizes: the SNR conditions
and input SNRs are JAX's, the chain's true-detection rates on a seed
equal JAX's exactly, the condition cache regenerates on a parameter
change and purges a partial set, and the sweep's report and CLI run.
"""

import glob
import json
import os

import pytest
import torch

from fmcw_radar_processing_tpu.models import robustness as jrob
from fmcw_radar_processing_tpu.models.dataset_gen import CALF as JCALF
from fmcw_radar_processing_tpu.models.dataset_gen import HUMAN as JHUMAN
from fmcw_radar_processing_tpu_torch.models import robustness as trob
from fmcw_radar_processing_tpu_torch.models.dataset_gen import CALF, HUMAN
from fmcw_radar_processing_tpu_torch.serve.cli import main as cli_main


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes it runs as fast as eight, and
    it does not oversubscribe the cores the test workers share (eight
    threads on a loaded machine ran the toy experiment 8× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_snr_conditions_equal_jax():
    grid = (40.0, 25.0, 0.0, -5.0)
    got = trob.snr_conditions((CALF, HUMAN), grid)
    want = jrob.snr_conditions((JCALF, JHUMAN), grid)
    assert [(c.name, c.noise_sigma) for c in got] == [(c.name, c.noise_sigma) for c in want]
    for c, w, snr in zip(got, want, grid):
        assert trob.input_snr_db((CALF, HUMAN), c) == jrob.input_snr_db(
            (JCALF, JHUMAN), jrob.Condition(w.name, w.noise_sigma))
        assert abs(trob.input_snr_db((CALF, HUMAN), c) - snr) < 1e-6
    cond = trob.Condition("amp", noise_sigma=0.05, amp_scale=0.25)
    assert trob.input_snr_db((CALF, HUMAN), cond) == jrob.input_snr_db(
        (JCALF, JHUMAN), jrob.Condition("amp", noise_sigma=0.05, amp_scale=0.25))
    assert trob.mean_amplitude((CALF, HUMAN)) == jrob.mean_amplitude((JCALF, JHUMAN))


@pytest.mark.parametrize("cond", [
    dict(name="clean", noise_sigma=0.05),
    dict(name="snr_low", noise_sigma=3.0),
    dict(name="overlap", noise_sigma=0.05, overlap_ratio=0.6),
    dict(name="hopeless", noise_sigma=0.05, amp_scale=1e-4),
])
def test_detection_rates_equal_jax(tmp_path, cond):
    """The chain's true-detection rate on a seed: the port's CPU chain
    equals JAX's exactly (2 images a class, 16 frames)."""
    kw = dict(images_per_class=2, frames_per_recording=16, seed=5,
              image_size=(80, 60))
    got = trob.generate_condition_images(str(tmp_path / "t"), (CALF, HUMAN),
                                         trob.Condition(**cond), device="cpu", **kw)
    want = jrob.generate_condition_images(str(tmp_path / "j"), (JCALF, JHUMAN),
                                          jrob.Condition(**cond), **kw)
    assert got["detection_rate"] == want["detection_rate"]
    if cond["name"] == "clean":
        assert got["detection_rate"] > 0.9
    if cond["name"] == "hopeless":
        assert got["detection_rate"] < 0.5


def test_condition_cache_regenerates_on_param_change(tmp_path):
    d = str(tmp_path / "set")
    kw = dict(images_per_class=1, frames_per_recording=16, image_size=(80, 60),
              device="cpu")
    cond = trob.Condition("c", noise_sigma=0.05)
    a = trob.generate_condition_images(d, (CALF, HUMAN), cond, **kw)
    b = trob.generate_condition_images(d, (CALF, HUMAN), cond, **kw)
    assert a == b
    c = trob.generate_condition_images(d, (CALF, HUMAN), cond,
                                       **{**kw, "images_per_class": 2})
    assert c["gen_key"] != a["gen_key"]
    assert len(os.listdir(os.path.join(d, "calf"))) == 2
    os.remove(os.path.join(d, "stats.json"))  # a crashed partial set
    (tmp_path / "set" / "calf" / "stray.png").write_bytes(b"x")
    trob.generate_condition_images(d, (CALF, HUMAN), cond, **kw)
    assert sorted(os.listdir(os.path.join(d, "calf"))) == ["calf_0000.png"]


@pytest.mark.parametrize("mixture", [False, True])
def test_sweep_report_roundtrip(tmp_path, mixture):
    report = trob.run_robustness_sweep(
        str(tmp_path), model="small", train_images_per_class=2,
        test_images_per_class=1, frames_per_recording=16, epochs=1, batch_size=2,
        image_size=(32, 32), render_size=(160, 120), snr_grid_db=(30.0, 10.0),
        extra_conditions=False, mixture_augment=mixture, mixture_frac=1.0,
        device="cpu")
    assert [r["condition"] for r in report["rows"]] == ["snr_+30dB", "snr_+10dB"]
    for row in report["rows"]:
        assert 0.0 <= row["accuracy"] <= 1.0 and 0.0 <= row["detection_rate"] <= 1.0
        assert row["n_images"] == 2
    assert report["mixture_augment"] is mixture
    md = trob.robustness_markdown(report)
    assert "snr_+30dB" in md and "Break point" in md
    name = "robustness_small_mixture.json" if mixture else "robustness_small.json"
    with open(tmp_path / name) as f:
        assert json.load(f)["rows"][0]["condition"] == "snr_+30dB"
    kind = "mixture1_0.25-0.85" if mixture else "clean"
    assert glob.glob(str(tmp_path / f"train_{kind}_2x16_*"))


def test_cli_robustness(tmp_path, capsys):
    assert cli_main(["robustness", "--out-dir", str(tmp_path), "--epochs", "1",
                     "--train-images-per-class", "1", "--test-images-per-class", "1",
                     "--frames", "16", "--snr-grid", "20", "--device", "cpu"]) == 0
    assert "snr_+20dB" in capsys.readouterr().out
    assert cli_main(["robustness", "--out-dir", str(tmp_path), "--classes", "calf,cow",
                     "--device", "cpu"]) == 2
