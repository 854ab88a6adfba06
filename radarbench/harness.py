"""One run of one cell, found by name from data alone.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; the harness reads

  radarbench/configs/<config>.json    the deployment (sizes, profile, chips,
                                      the control's lower-precision paths),
  radarbench/traffic/<traffic>.json   the mix: which driver, the scene the
                                      inputs show, pool, slices, samples,
  radarbench/drivers/<driver>.py      the code that drives the program,
  radarbench/limits/<cell>.json       each compared number's limit,
  radarbench/metrics/<metric>.py      one reader per per-layer metric,

so that a cell, a configuration, a mix or a metric is added as new files.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from radarbench import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "fmcw_radar_processing_tpu")


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / "radarbench"

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.dir / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return load_json(self.dir / "limits" / f"{cell}.json")["limits"]

    def driver(self, name: str):
        return load_module(self.dir / "drivers" / f"{name}.py", f"radarbench_driver_{name}")

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "radarbench_metric_" + metric.replace(".", "_")).read

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every limit read and met."""
    checks = {}
    ok = set(readings) == set(limits)
    for name in sorted(set(readings) | set(limits)):
        v = readings.get(name)
        lim = limits.get(name)
        checks[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not (isinstance(v, (int, float)) and math.isfinite(v)
                                             and v <= lim):
            ok = False
    return ok, checks


def run_cell(root: Path, cell_name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None,
             variant: str = "program") -> dict:
    """Run one cell once and return its result line (a dict): set-up, the
    measured window (or, traced, the traced slice and the per-layer
    metrics), the peak memory, then the comparison with the reference.
    ``variant`` "control" runs the configuration's lower-precision paths
    (configs/<config>.json "control") in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root)
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    drv = bench.driver(traffic["driver"]).Driver(
        cfg, traffic, seed, device, out_dir=bench.root / "radarbench" / "out",
        variant=variant)
    try:
        drv.setup()
        setup_s = time.perf_counter() - t_start
        dev_info = drv.device_info()
        metrics, breakdown = {}, None
        if not traced:
            values = drv.window(seconds)
            for m in bench.end_to_end(cell_name):
                v = setup_s if m["name"] == "setup_s" else values[m["name"]]
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            host = drv.pre_trace()
            out_dir = bench.root / "radarbench" / "out"
            out_dir.mkdir(parents=True, exist_ok=True)
            path = str(out_dir / f"trace_{cell_name}_{seed}.json")
            ctx = drv.traced(path)
            dev_ev, host_ev = tr.load_events(path)
            ctx.update(events=dev_ev, host=host,
                       busy_s=ctx.get("busy_s", tr.busy_seconds(dev_ev)))
            dev_info.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
            breakdown = {"device_ops": tr.device_ops(dev_ev),
                         "idle_gaps": tr.idle_gaps(dev_ev, host_ev)}
            for m in bench.per_layer(cell_name):
                v = bench.reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["memory_peak_bytes"] = drv.memory_peak()
        drv.free()
        readings = drv.check()
    finally:
        drv.close()
    correct, checks = judge(readings, bench.limits(cell_name))
    out = {"correct": correct, "attempted": drv.attempted, "failed": drv.failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def report(result: dict) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()

