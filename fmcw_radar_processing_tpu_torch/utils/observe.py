"""Stage timers (wall-clock per pipeline stage, synced to the device),
spans on the profiler's clock, a profiler trace and structured event lines.

CUDA launches return before the card finishes, so a stage's clock stops
only after the work it queued has run: :func:`_sync` calls
``torch.cuda.synchronize()`` when the observed value holds a CUDA tensor.
(The JAX package's sync blocks only on jax arrays.)

:func:`span` marks a region of program code. While no ``torch.profiler``
profile records, it costs one flag read and does nothing; while one does,
the region is a ``record_function`` annotation (a ``user_annotation``
event on the clock of the kernels and copies in the Chrome trace) and its
host seconds and count go to :data:`PROFILED`. A span never synchronizes
the device: its seconds are host time, device work included only where
the code inside already waits for it. :func:`count` adds a number (bytes,
items) to :data:`PROFILED` under the same rule, and does nothing off the
profiler.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import threading
import time
from typing import Any, ContextManager, Iterator

import torch
import torch.autograd.profiler as _autograd_profiler


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
    count: int = 1  # runs of the stage summed into ``seconds``

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
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, items: int | None = None) -> Iterator[None]:
        """Time the enclosed block as stage ``name``; under the profiler
        the block, sync included, is also ``span(name)``."""
        with span(name):
            self._pending = None
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self._pending is not None:
                    _sync(self._pending)
                    self._pending = None
                self.add(name, time.perf_counter() - t0, items)

    def add(self, name: str, seconds: float, items: int | None = None) -> None:
        """Add one run of stage ``name``: repeated runs accumulate."""
        with self._lock:
            prev = self.records.get(name)
            if prev is None:
                self.records[name] = StageRecord(seconds, items)
            else:
                prev.seconds += seconds
                prev.count += 1
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
                "count": r.count,
                "seconds": round(r.seconds, 6),
                "share": round(r.seconds / total, 4),
            }
            if r.items_per_s is not None:
                row["items"] = r.items
                row["items_per_s"] = round(r.items_per_s, 2)
            out[name] = row
        return out

    def pretty(self) -> str:
        rows = [f"{'stage':<24}{'count':>7}{'seconds':>10}{'share':>8}{'items/s':>14}"]
        for name, row in self.report().items():
            ips = row.get("items_per_s")
            rows.append(
                f"{name:<24}{row['count']:>7}{row['seconds']:>10.4f}{row['share']:>8.1%}"
                f"{(f'{ips:,.0f}' if ips is not None else '—'):>14}"
            )
        rows.append(f"{'total':<31}{self.total_seconds:>10.4f}")
        return "\n".join(rows)


class NullTimer:
    """No-op StageTimer stand-in — lets pipelines take ``timer=None``. Its
    stages are still spans."""

    def stage(self, name: str, items: int | None = None) -> ContextManager[None]:
        return span(name)

    def observe(self, value: Any) -> Any:
        return value


PROFILED = StageTimer()
"""Host seconds and count of every span, and the sum of every counter (as
its ``items``), by name, over the newest stretch of spans and counts made
under the profiler. It is cleared when a span opens, or a count is made,
under the profiler after one without it, so an untraced call between two
profiled stretches leaves only the second."""

_NO_SPAN = contextlib.nullcontext()
_unprofiled_span_since = True  # since the last span or count under the profiler


def _profiling() -> bool:
    """Whether a ``torch.profiler`` profile records (one flag read);
    clears PROFILED at the first call under it after one without it."""
    global _unprofiled_span_since
    if not _autograd_profiler._is_profiler_enabled:
        _unprofiled_span_since = True
        return False
    if _unprofiled_span_since:
        _unprofiled_span_since = False
        with PROFILED._lock:
            PROFILED.records.clear()
    return True


def span(name: str) -> ContextManager[None]:
    """Mark the enclosed region of program code as ``name``: a shared no-op
    after one flag read while no profiler records, else a
    ``record_function`` annotation whose host seconds go to PROFILED."""
    return _profiled_span(name) if _profiling() else _NO_SPAN


def count(name: str, n: int) -> None:
    """Add ``n`` to PROFILED's record ``name`` (its ``items``, no seconds)
    while a profiler records; else nothing, after one flag read."""
    if _profiling():
        PROFILED.add(name, 0.0, n)


@contextlib.contextmanager
def _profiled_span(name: str) -> Iterator[None]:
    with _autograd_profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            PROFILED.add(name, time.perf_counter() - t0)


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
