"""Stage timers (wall-clock per pipeline stage, synced to the device), a
profiler trace and structured event lines.

CUDA launches return before the card finishes, so a stage's clock stops
only after the work it queued has run: :func:`_sync` calls
``torch.cuda.synchronize()`` when the observed value holds a CUDA tensor.
(The JAX package's sync blocks only on jax arrays.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from typing import Any, Iterator

import torch


def _cuda_devices(value: Any) -> set[torch.device]:
    if isinstance(value, torch.Tensor):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        out: set[torch.device] = set()
        for v in value:
            out |= _cuda_devices(v)
        return out
    return set()


def _sync(value: Any) -> None:
    """Wait until the CUDA work behind every tensor in ``value`` is done."""
    for dev in _cuda_devices(value):
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class StageRecord:
    seconds: float
    items: int | None = None

    @property
    def items_per_s(self) -> float | None:
        if self.items is None or self.seconds <= 0:
            return None
        return self.items / self.seconds


class StageTimer:
    """Collects per-stage wall times across one or more runs.

    Usage::

        timer = StageTimer()
        with timer.stage("frame_chain", items=num_frames):
            out = chain(raw, calib)          # asynchronous launches…
            timer.observe(out)               # …synced before the stop
    """

    def __init__(self) -> None:
        self.records: dict[str, StageRecord] = {}
        self._pending: Any = None

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None) -> Iterator[None]:
        self._pending = None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._pending is not None:
                _sync(self._pending)
                self._pending = None
            dt = time.perf_counter() - t0
            prev = self.records.get(name)
            if prev is None:
                self.records[name] = StageRecord(dt, items)
            else:  # accumulate across repeated runs of the same stage
                prev.seconds += dt
                if items is not None:
                    prev.items = (prev.items or 0) + items

    def observe(self, value: Any) -> Any:
        """Mark device output(s) to be synced before the stage clock stops."""
        self._pending = value
        return value

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records.values())

    def report(self) -> dict:
        total = self.total_seconds or 1.0
        out = {}
        for name, r in self.records.items():
            row: dict[str, Any] = {
                "seconds": round(r.seconds, 6),
                "share": round(r.seconds / total, 4),
            }
            if r.items_per_s is not None:
                row["items"] = r.items
                row["items_per_s"] = round(r.items_per_s, 2)
            out[name] = row
        return out

    def pretty(self) -> str:
        rows = [f"{'stage':<24}{'seconds':>10}{'share':>8}{'items/s':>14}"]
        for name, row in self.report().items():
            ips = row.get("items_per_s")
            rows.append(
                f"{name:<24}{row['seconds']:>10.4f}{row['share']:>8.1%}"
                f"{(f'{ips:,.0f}' if ips is not None else '—'):>14}"
            )
        rows.append(f"{'total':<24}{self.total_seconds:>10.4f}")
        return "\n".join(rows)


class NullTimer:
    """No-op StageTimer stand-in — lets pipelines take ``timer=None``."""

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None) -> Iterator[None]:
        yield

    def observe(self, value: Any) -> Any:
        return value


@contextlib.contextmanager
def trace(trace_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region it wraps: CPU
    activity, and CUDA activity (kernels, copies) when a card is present,
    written as a Chrome trace (``trace_<pid>.json``, for chrome://tracing
    or Perfetto) into ``trace_dir``, which is created if missing."""
    import os

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


def log_event(event: str, *, stream=None, **fields: Any) -> dict:
    """Emit one structured JSON event line (stderr by default) and return
    the record."""
    record = {"ts": round(time.time(), 3), "event": event, **fields}
    print(json.dumps(record, default=str), file=stream or sys.stderr)
    return record
