"""PyTorch port: the end-to-end classifier experiment against the JAX
package's ``models/experiment.py``, on the CPU at toy sizes.

The toy experiment is the JAX test's (``test_experiment.py:60-75``) and
is held to its bar (final train accuracy ≥ 0.8, the serving round trip
through the port's artifact); its report has the JAX report's keys at
every level.
"""

import json
import os

import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.models import experiment as jexp
from fmcw_radar_processing_tpu_torch.models import experiment as texp
from fmcw_radar_processing_tpu_torch.serve.cli import main as cli_main

TOY = dict(images_per_class=10, frames_per_recording=48, image_size=(64, 64),
           model="small", epochs=30, batch_size=7, learning_rate=1e-3,
           augment=False, render_size=(320, 240))
TINY = dict(images_per_class=7, frames_per_recording=16, image_size=(16, 16),
            model="small", epochs=2, batch_size=2, learning_rate=1e-3,
            augment=False, render_size=(80, 60))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes it runs as fast as eight, and
    it does not oversubscribe the cores the test workers share (eight
    threads on a loaded machine ran the toy experiment 8× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(report, skip=("history", "predictions")):
    """Every key path of a report; lists of dicts by their first entry."""
    out = set()

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                out.add(path + (k,))
                if k not in skip:
                    walk(v, path + (k,))
    walk(report, ())
    return out


@pytest.fixture(scope="module")
def jax_tiny_report(tmp_path_factory):
    return jexp.run_classifier_experiment(
        str(tmp_path_factory.mktemp("jax_exp")), jexp.ExperimentConfig(**TINY))


def test_toy_experiment_end_to_end(tmp_path, jax_tiny_report):
    """The JAX test's toy loop on the port: trains (train accuracy ≥ 0.8),
    reports, exports, round-trips 2 test images through the port's
    artifact; the report's keys (and the history entries', and the served
    predictions') are JAX's."""
    cfg = texp.ExperimentConfig(**TOY)
    report = texp.run_classifier_experiment(str(tmp_path), cfg, device="cpu")
    assert _keys(report) == _keys(jax_tiny_report)
    assert report["training"]["history"][0].keys() == \
        jax_tiny_report["training"]["history"][0].keys()
    assert report["serving_roundtrip"]["predictions"][0].keys() == \
        jax_tiny_report["serving_roundtrip"]["predictions"][0].keys()
    assert report["dataset"]["split"]["train"] == 14  # 7 a class
    assert report["dataset"]["classes"] == ["calf", "human"]
    assert len(report["training"]["history"]) == cfg.epochs
    for split in ("val", "test"):
        assert 0.0 <= report[split]["accuracy"] <= 1.0
        cm = np.asarray(report[split]["confusion_matrix"])
        assert cm.sum() == report["dataset"]["split"][split]
    assert report["training"]["history"][-1]["accuracy"] >= 0.8
    art = report["serving_roundtrip"]["artifact"]
    assert os.path.exists(os.path.join(art, "params.npz"))
    assert report["serving_roundtrip"]["sampled"] == 2
    assert report["device"]["device_kind"] == "cpu"
    assert report["device"]["peak_bytes_in_use"] is None
    with open(tmp_path / "report.json") as f:
        assert json.load(f)["model"] == "small"
    md = texp.report_markdown(report)
    assert "val accuracy" in md and "0.9828" in md and "Serving round-trip" in md

    report2 = texp.run_classifier_experiment(str(tmp_path), cfg, reuse_dataset=True,
                                             device="cpu")
    assert report2["dataset"]["generation_seconds"] < \
        report["dataset"]["generation_seconds"]


def test_cli_classifier_e2e(tmp_path, capsys):
    out = str(tmp_path / "e2e")
    assert cli_main(["classifier-e2e", "--out-dir", out, "--images-per-class", "7",
                     "--frames", "16", "--epochs", "1", "--batch-size", "2",
                     "--classes", "calf,bees", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "bees1-vs-calf" in text and os.path.exists(os.path.join(out, "report.md"))
    assert cli_main(["classifier-e2e", "--out-dir", out, "--classes", "calf",
                     "--device", "cpu"]) == 2
