"""The benchmark's own profiler call and the reduction of its trace.

A traced slice runs under ``torch.profiler`` with CPU and CUDA activity;
the Chrome trace is written to a file and read back. Device events are
the kernels, copies and fills (categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``); host events are the CPU operators and annotations, on
the same clock. From them:

  busy_s      the union of the device events' intervals, in seconds;
  device_ops  device time by event name, the largest first;
  idle_gaps   the device's idle time between its events, by the host
              operator that overlaps each gap most (the innermost one on
              a tie), the largest first.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@contextlib.contextmanager
def profiled(path: str):
    """Profile the enclosed block (CPU and CUDA activity) and write its
    Chrome trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    prof.export_chrome_trace(path)


def load_events(path: str) -> tuple[list[dict], list[dict]]:
    """(device events, host events) of a Chrome trace, each a dict with
    name, cat, ts and dur in microseconds."""
    with open(path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        rec = {"name": e.get("name", ""), "cat": cat, "ts": float(e["ts"]),
               "dur": float(e.get("dur", 0.0))}
        if cat in DEVICE_CATS:
            dev.append(rec)
        elif cat in HOST_CATS:
            host.append(rec)
    return dev, host


def busy_intervals(dev: list[dict]) -> list[tuple[float, float]]:
    """The union of the device events' [ts, ts + dur) intervals, sorted."""
    out: list[list[float]] = []
    for s, e in sorted((d["ts"], d["ts"] + d["dur"]) for d in dev):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(dev: list[dict]) -> float:
    return sum(e - s for s, e in busy_intervals(dev)) / 1e6


def device_ops(dev: list[dict], top: int = 10) -> list[list]:
    tot: dict[str, float] = defaultdict(float)
    for d in dev:
        tot[d["name"]] += d["dur"] / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(dev: list[dict], host: list[dict], top: int = 10) -> list[list]:
    """Idle time between the first and the last device event, by the host
    event overlapping each gap most (a sweep over both, in time order)."""
    busy = busy_intervals(dev)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    host = sorted(host, key=lambda h: h["ts"])
    tot: dict[str, float] = defaultdict(float)
    active: list[dict] = []
    nxt = 0
    for s, e in gaps:
        while nxt < len(host) and host[nxt]["ts"] < e:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h["ts"] + h["dur"] > s]
        best, key = None, None
        for h in active:
            ov = min(e, h["ts"] + h["dur"]) - max(s, h["ts"])
            k = (ov, -h["dur"])
            if ov > 0 and (key is None or k > key):
                best, key = h["name"], k
        tot[best or "(no host event)"] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def kernel_seconds(dev: list[dict]) -> float:
    """Seconds of compute kernels: NCCL's kernels are left out, since their
    time is mostly waiting for the other ranks."""
    return sum(d["dur"] for d in dev
               if d["cat"] == "kernel" and not d["name"].startswith("nccl")) / 1e6


def copy_seconds(dev: list[dict], direction: str) -> float:
    """Seconds of copies whose name holds ``direction`` ("HtoD", "DtoH")."""
    return sum(d["dur"] for d in dev
               if d["cat"] == "gpu_memcpy" and direction in d["name"]) / 1e6


def kernel_count(dev: list[dict]) -> int:
    return sum(d["cat"] == "kernel" for d in dev)
