"""The module check: JAX and the JAX package are refused by whole
top-level name, the port is not; and a whole run loads neither."""

from __future__ import annotations

import subprocess
import sys

from radarbench import harness
from radarbench.tests.conftest import REPO, one_card_cells


def test_forbidden_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "fmcw_radar_processing_tpu", "fmcw_radar_processing_tpu.pipeline.recording",
             "fmcw_radar_processing_tpu_torch", "fmcw_radar_processing_tpu_torch.ops",
             "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "fmcw_radar_processing_tpu",
        "fmcw_radar_processing_tpu.pipeline.recording", "jax", "jax.numpy",
        "jaxlib.xla_client"]
    assert harness.forbidden_modules(["fmcw_radar_processing_tpu_torch.x"]) == []


RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from radarbench import harness
for cell in {cells!r}:
    for traced in (False, True):
        harness.run_cell({root!r}, cell, 7, 0.1, traced, "cpu")
print(json.dumps(harness.forbidden_modules(sys.modules)))
"""


def test_a_whole_run_loads_no_jax(tiny_root):
    out = subprocess.run([sys.executable, "-c", RUN.format(repo=str(REPO), root=str(tiny_root),
                                                     cells=one_card_cells())],
                         capture_output=True, text=True, timeout=300, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_py_refuses_without_a_card_or_the_program(tmp_path):
    """Without enough cards (this machine has none) run.py exits 2 and
    prints no result; in a directory holding only the benchmark's files it
    does not exit 0 either."""
    out = subprocess.run([sys.executable, "radarbench/run.py", "--workload",
                          "production-65k.recording", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode == 2 and out.stdout == ""
    from radarbench.tests.conftest import make_root

    root = make_root(tmp_path / "bare", tiny=False)
    for f in ("run.py", "harness.py", "trace.py", "roofline.py", "program.py", "__init__.py"):
        (root / "radarbench" / f).write_bytes((REPO / "radarbench" / f).read_bytes())
    out = subprocess.run([sys.executable, "radarbench/run.py", "--workload",
                          "production-65k.recording", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode != 0 and out.stdout == ""
