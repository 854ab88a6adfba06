"""The harness finds cells, configurations, mixes, limits, drivers and
per-layer metrics by name from data alone, and BENCHMARK.json keeps to the
benchmark's contract."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import re
from pathlib import Path

import pytest

from radarbench import harness, roofline
from radarbench.tests.conftest import (
    REPO,
    add_fidelity_rehearsal,
    make_root,
    spec_with_deferred,
)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "radarbench/run.py"]
    assert BENCH["paths"] == ["radarbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and 1 <= len(c["source"]) <= 200
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


DEFERRED = json.loads((REPO / "radarbench" / "deferred.json").read_text())


def _resolves_by_name(bench, cell):
    w = bench.cell(cell)
    cfg = bench.config(w["config"])
    traffic = bench.traffic(w["traffic"])
    assert cfg["chips"] == w["chips"]
    assert hasattr(bench.driver(traffic["driver"]), "Driver")
    e2e = [m["name"] for m in bench.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = bench.per_layer(cell)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert callable(bench.reader(m["name"]))
    limits = bench.limits(cell)
    assert limits and all(isinstance(v, (int, float)) and math.isfinite(v)
                          for v in limits.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    _resolves_by_name(harness.Bench(REPO), cell)


@pytest.mark.parametrize("cell", [w["name"] for w in DEFERRED["workloads"]])
def test_every_deferred_cell_resolves_by_name_once_put_back(cell, tmp_path):
    assert cell not in {w["name"] for w in BENCH["workloads"]}
    _resolves_by_name(harness.Bench(make_root(tmp_path / "checkout", tiny=False)), cell)


def test_per_layer_workloads_name_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def _states_a_profile_of_the_program(spec: dict, root: Path) -> None:
    """Each configuration's algorithm, where it has one, is, field for
    field, one of the port's two named profiles: AlgorithmConfig.production()
    or the bare AlgorithmConfig() (the HTTP handler's "production" and
    "fidelity")."""
    from fmcw_radar_processing_tpu_torch.config.radar import (
        AlgorithmConfig,
        default_device_config,
    )

    profiles = [dataclasses.asdict(AlgorithmConfig.production()),
                dataclasses.asdict(AlgorithmConfig())]
    for c in spec["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        if "algorithm" not in cfg:
            continue
        assert cfg["algorithm"] in profiles, c["name"]
        assert cfg["device"] == dataclasses.asdict(default_device_config())
        assert cfg["reduced"] == c["reduced"]


def test_configs_state_a_profile_of_the_program():
    _states_a_profile_of_the_program(BENCH, REPO)


@pytest.mark.parametrize("field,value", [("stft_nfft", 512), ("intensity_dtype", "int8"),
                                         ("batch_size", 50)])
def test_a_config_of_neither_profile_is_refused(tmp_path, field, value):
    root = make_root(tmp_path / "checkout", tiny=False)
    path = root / "radarbench" / "configs" / "production-65k.json"
    cfg = json.loads(path.read_text())
    cfg["algorithm"][field] = value
    path.write_text(json.dumps(cfg))
    with pytest.raises(AssertionError):
        _states_a_profile_of_the_program(BENCH, root)


def _states_one_kind(spec: dict, root: Path) -> None:
    """Each configuration states a radar profile ("algorithm") or a
    classifier ("model"), not both and not neither."""
    for c in spec["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert ("algorithm" in cfg) != ("model" in cfg), c["name"]


def _states_the_published_vgg16(spec: dict, root: Path) -> None:
    """Each configuration's model, where it has one, is the port's
    published VGG16: VGG16_BLOCKS, 224×224×3 images, a head of 256, bf16."""
    from fmcw_radar_processing_tpu_torch.models.vgg import VGG16_BLOCKS

    for c in spec["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        if "model" not in cfg:
            continue
        assert cfg["model"] == "vgg16", c["name"]
        assert [tuple(b) for b in cfg["blocks"]] == list(VGG16_BLOCKS), c["name"]
        assert cfg["input_shape"] == [224, 224, 3] and cfg["head"] == 256, c["name"]
        assert cfg["dtype"] == "bfloat16", c["name"]
        assert cfg["reduced"] == c["reduced"]


def test_configs_state_one_kind():
    _states_one_kind(spec_with_deferred(), REPO)


def test_model_configs_state_the_published_vgg16():
    spec = spec_with_deferred()
    assert any("model" in json.loads((REPO / c["file"]).read_text()) for c in spec["configs"])
    _states_the_published_vgg16(spec, REPO)


@pytest.mark.parametrize("name,edit,check", [
    ("production-65k", lambda cfg: cfg.pop("algorithm"), _states_one_kind),
    ("production-65k", lambda cfg: cfg.update(model="vgg16"), _states_one_kind),
    ("vgg16-224", lambda cfg: cfg.update(head=128), _states_the_published_vgg16),
    ("vgg16-224", lambda cfg: cfg.update(input_shape=[112, 112, 3]),
     _states_the_published_vgg16),
    ("vgg16-224", lambda cfg: cfg["blocks"].pop(), _states_the_published_vgg16),
])
def test_a_config_of_neither_kind_or_both_or_a_cut_vgg16_is_refused(tmp_path, name, edit,
                                                                   check):
    root = make_root(tmp_path / "checkout", tiny=False)
    path = root / "radarbench" / "configs" / f"{name}.json"
    cfg = json.loads(path.read_text())
    edit(cfg)
    path.write_text(json.dumps(cfg))
    with pytest.raises(AssertionError):
        check(spec_with_deferred(), root)


DUMMY_DRIVER = '''
import time


class Driver:
    def __init__(self, cfg, traffic, seed, device, out_dir, variant="program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.attempted = self.failed = 0

    def setup(self):
        self.items = [self.seed + i for i in range(self.cfg["size"])]

    def device_info(self):
        return {"platform": "cpu", "kind": "cpu", "count": 1}

    def window(self, seconds):
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            n += sum(self.items) > 0
        self.attempted = n
        return {"dummy_items_per_s": n / (time.perf_counter() - t0)}

    def pre_trace(self):
        return {}

    def traced(self, path):
        open(path, "w").write('{"traceEvents": []}')
        self.attempted = self.traffic["trace_items"]
        return {"items": self.attempted, "window_s": 0.1, "spans": {"sum": 2.0}}

    def memory_peak(self):
        return 0

    def free(self):
        pass

    def check(self):
        return {"sum_faults": int(sum(self.items) != self.cfg["size"] * self.seed
                                  + self.cfg["size"] * (self.cfg["size"] - 1) // 2)}

    def close(self):
        pass
'''


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_dummy_cell_added_as_new_files_runs(tmp_path):
    root = make_root(tmp_path / "checkout")
    before = _digest(root)
    rb = root / "radarbench"
    (rb / "configs" / "dummy.json").write_text(json.dumps({"name": "dummy", "chips": 1,
                                                           "size": 3}))
    (rb / "traffic" / "count.json").write_text(json.dumps({"driver": "dummy",
                                                           "trace_items": 2}))
    (rb / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (rb / "metrics" / "dummy.sum_ms.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx['spans']['sum'] / ctx['items']\n")
    (rb / "limits" / "dummy.count.json").write_text(json.dumps({"limits": {"sum_faults": 0}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                            "file": "radarbench/configs/dummy.json", "reduced": [],
                            "why": "a dummy"})
    spec["workloads"].append({"name": "dummy.count", "config": "dummy", "traffic": "count",
                              "chips": 1, "why": "a dummy cell"})
    spec["end_to_end"].append({"name": "dummy_items_per_s", "unit": "items/s",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["dummy.count"]})
    spec["per_layer"].append({"name": "dummy.sum_ms", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "dummy",
                              "moves": "dummy_items_per_s", "workloads": ["dummy.count"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(root)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}  # no file of the harness was edited

    r = harness.run_cell(root, "dummy.count", 5, 0.05, False, "cpu")
    assert r["correct"] and set(r["metrics"]) == {"dummy_items_per_s", "setup_s"}
    assert r["checks"] == {"sum_faults": {"value": 0, "limit": 0}}
    r = harness.run_cell(root, "dummy.count", 5, 0.05, True, "cpu")
    assert r["metrics"] == {"dummy.sum_ms": {"value": 1000.0, "unit": "ms"}}
    assert list(r)[-1] == "checks"


ERRS = ("profile_err", "db_err", "intensity_err")


def test_a_fidelity_cell_added_as_new_files_runs(tmp_path, monkeypatch):
    """A cell of the service's default profile (a null stft_nfft) over the
    real recording mix and driver is taken as new files and BENCHMARK.json
    entries. At 512 frames its nfft is 8,192: past the untiled export's
    512 bins, the tiled export's plain versions. The program reads below
    its control on each number; limits between the two pass the one and
    fail the other; a traced run's roofline reader gets finite work."""
    import torch

    torch.set_num_threads(2)
    root = make_root(tmp_path / "checkout")
    before = _digest(root)
    cell = add_fidelity_rehearsal(root, 512, {"detect_faults": 0, "payload_faults": 0,
                                              **dict.fromkeys(ERRS, 0.0)})
    after = _digest(root)
    assert {k for k in before if before[k] != after.get(k)} == {"BENCHMARK.json"}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    _states_a_profile_of_the_program(spec, root)
    _resolves_by_name(harness.Bench(root), cell)

    seed = 2**31 + 4242
    runs = [harness.run_cell(root, cell, seed, 0.1, False, "cpu", variant=v)
            for v in ("program", "control")]
    prog, ctl = ({k: c["value"] for k, c in r["checks"].items()} for r in runs)
    assert prog["detect_faults"] == prog["payload_faults"] == 0, prog
    assert all(prog[k] < ctl[k] for k in ERRS), (prog, ctl)
    limits = {"detect_faults": 0, "payload_faults": 0,
              **{k: math.sqrt(prog[k] * ctl[k]) for k in ERRS}}
    (root / "radarbench" / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    assert harness.judge(prog, limits)[0] and not harness.judge(ctl, limits)[0]

    seen = {}
    reader = harness.Bench.reader

    def spying(self, metric):
        read = reader(self, metric)

        def spy(ctx):
            seen[metric] = ctx
            return read(ctx)

        return spy

    monkeypatch.setattr(harness.Bench, "reader", spying)
    r = harness.run_cell(root, cell, seed + 1, 0.1, True, "cpu")
    assert r["correct"], r["checks"]
    work = seen["kernels_roofline_pct.recording"]["work"]
    assert all(math.isfinite(x) and x > 0 for x in (work["bytes"], work["flops"],
                                                    work["export"]["bytes"],
                                                    work["export"]["flops"]))
    cols, rest = divmod(work["export"]["bytes"], (1024 + 4097) * 4)  # float32 maps, nfft 8,192
    assert rest == 0 and roofline.next_pow2(int(cols) + 19) == 8192


def test_judge_needs_every_limit_met():
    assert harness.judge({"a": 0, "b": 0.5}, {"a": 0, "b": 1.0})[0]
    assert not harness.judge({"a": 1, "b": 0.5}, {"a": 0, "b": 1.0})[0]
    assert not harness.judge({"a": 0}, {"a": 0, "b": 1.0})[0]
    assert not harness.judge({"a": 0, "b": float("nan")}, {"a": 0, "b": 1.0})[0]
