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
TINY = {"frames": 512, "channels": 2, "window_frames": 32}
TINY_TRAFFIC = {"pool_windows": 3, "enqueue_items": 3, "trace_items": 4}


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
    configurations and their metrics' ``workloads`` put back."""
    spec["configs"] += deferred["configs"]
    spec["workloads"] += deferred["workloads"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).extend(deferred["metric_workloads"].get(m["name"], []))
    return spec


def make_root(dest: Path, tiny: bool = True) -> Path:
    """A checkout root at ``dest`` with BENCHMARK.json and the deferred
    cells, and copies of the benchmark's data files (cut to CPU size when
    ``tiny``)."""
    dest.mkdir(parents=True, exist_ok=True)
    spec = with_deferred(json.loads((REPO / "BENCHMARK.json").read_text()),
                         json.loads((REPO / "radarbench" / "deferred.json").read_text()))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
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


@pytest.fixture
def tiny_root(tmp_path):
    import torch

    torch.set_num_threads(2)
    return make_root(tmp_path / "checkout")
