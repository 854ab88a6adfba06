"""Shared fixtures of the benchmark's own tests.

``tiny_root`` is a checkout root in a temporary directory holding
BENCHMARK.json, with the cells of ``deferred.json`` put back into it, and
the benchmark's data files, with every configuration and mix cut to a
size the CPU runs in a second or two; the harness finds everything there
by name, as it does in a checkout. Tests marked ``cuda``
need a card; the ``card`` fixture skips them without one.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA_DIRS = ("configs", "traffic", "limits", "metrics", "drivers")
TINY = {"frames": 512, "channels": 2, "window_frames": 32, "input_shape": [32, 32, 3]}
TINY_TRAFFIC = {"pool_windows": 3, "enqueue_items": 3, "trace_items": 4,
                "client_threads": 2, "images_per_request": 2}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips when there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def with_deferred(spec: dict, deferred: dict) -> dict:
    """``spec`` (BENCHMARK.json) with the deferred cells, their
    configurations, the metrics of their own and the other metrics'
    ``workloads`` put back."""
    spec["configs"] += deferred["configs"]
    spec["workloads"] += deferred["workloads"]
    spec["end_to_end"] += deferred.get("end_to_end", [])
    spec["per_layer"] += deferred.get("per_layer", [])
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).extend(deferred["metric_workloads"].get(m["name"], []))
    return spec


def spec_with_deferred() -> dict:
    """The repo's BENCHMARK.json with the cells of deferred.json put back."""
    return with_deferred(json.loads((REPO / "BENCHMARK.json").read_text()),
                         json.loads((REPO / "radarbench" / "deferred.json").read_text()))


def one_card_cells() -> list[str]:
    """The one-card cells of BENCHMARK.json and then deferred.json, in file
    order: the cells the tests run one by one, so that a cell added as
    data is run without an edit to them."""
    return [w["name"] for w in spec_with_deferred()["workloads"] if w["chips"] == 1]


def make_root(dest: Path, tiny: bool = True) -> Path:
    """A checkout root at ``dest`` with BENCHMARK.json and the deferred
    cells, and copies of the benchmark's data files (cut to CPU size when
    ``tiny``)."""
    dest.mkdir(parents=True, exist_ok=True)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec_with_deferred(), indent=1))
    for d in DATA_DIRS:
        shutil.copytree(REPO / "radarbench" / d, dest / "radarbench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    if tiny:
        for path in (dest / "radarbench" / "configs").glob("*.json"):
            cfg = json.loads(path.read_text())
            cfg.update({k: v for k, v in TINY.items() if k in cfg})
            path.write_text(json.dumps(cfg))
        for path in (dest / "radarbench" / "traffic").glob("*.json"):
            t = json.loads(path.read_text())
            t.update({k: v for k, v in TINY_TRAFFIC.items() if k in t})
            if "channel_targets" in t:
                t["channel_targets"] = t["channel_targets"][:TINY["channels"]]
            path.write_text(json.dumps(t))
    return dest


FIDELITY = {"stft_nfft": None, "intensity_dtype": "float32", "stft_psd_precision": "highest",
            "stft_db_store": "float32"}  # the bare AlgorithmConfig() against production()


def add_fidelity_rehearsal(root: Path, frames: int, limits: dict) -> str:
    """Add to the checkout at ``root``, as new files and BENCHMARK.json
    entries only, the cell "fidelity-rehearsal.recording": the recording
    mix through the real ``recordings`` driver under the bare
    ``AlgorithmConfig()``, the HTTP service's default "fidelity" profile
    (hop 1, nfft from the recording's length, float32 maps), at ``frames``
    frames, with ``limits`` as its limits. Its control is the program's
    bf16 chain, a bf16 intensity store and the dB map rounded to bf16.
    Returns the cell's name."""
    rb = root / "radarbench"
    cfg = json.loads((REPO / "radarbench" / "configs" / "production-65k.json").read_text())
    cfg.update(name="fidelity-rehearsal", frames=frames,
               deployment="The HTTP service's default profile on one recording (a rehearsal).",
               control={"impl": "pallas_profile_bf16",
                        "algorithm": {"intensity_dtype": "bfloat16"},
                        "round_outputs": {"db": "bfloat16"}})
    cfg["algorithm"].update(FIDELITY)
    (rb / "configs" / "fidelity-rehearsal.json").write_text(json.dumps(cfg, indent=1))
    cell = "fidelity-rehearsal.recording"
    (rb / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "fidelity-rehearsal", "source": cfg["source"],
                            "file": "radarbench/configs/fidelity-rehearsal.json",
                            "reduced": [], "why": "the service's default profile"})
    spec["workloads"].append({"name": cell, "config": "fidelity-rehearsal",
                              "traffic": "recording", "chips": 1,
                              "why": "recordings back to back at the fidelity profile"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "production-65k.recording" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return cell


@pytest.fixture
def tiny_root(tmp_path):
    import torch

    torch.set_num_threads(2)
    return make_root(tmp_path / "checkout")
