"""Scoped wall-clock tracing — the toolkit/trace.{h,cc} equivalent.

`Trace("label")` context managers nest on a per-thread stack and
accumulate *exclusive* and *total* microseconds per label
(ref toolkit/trace.h:22-39, trace.cc:20-80); `trace_report()` renders the
table.  For device-side profiling, `scope()` additionally opens a
`torch.profiler.record_function` so labels show up in torch.profiler
traces (`python -m eggshell_tpu_torch.profile_step`) around the device
operations they launch: host timing alone sees launches, not the card's
work.  The host times are those of the Python block; without a
synchronisation inside it they do not include the card's time.

Counterpart of `eggshell_tpu.utils.trace`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Tuple

import torch

_local = threading.local()
_lock = threading.Lock()
# label -> [exclusive_us, total_us, count]
_slots: Dict[str, List[float]] = {}
_enabled = True


def trace_start() -> None:
    """Reset all accumulated timings (ref TraceStart)."""
    global _slots
    with _lock:
        _slots = {}


def set_tracing(enabled: bool) -> None:
    global _enabled
    _enabled = enabled


class Trace:
    """RAII-style scope: `with Trace("collision"): ...`."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        if not _enabled:
            return self
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        now = time.perf_counter()
        # pause the parent's exclusive clock
        if stack:
            parent = stack[-1]
            parent[2] += now - parent[1]  # accumulate parent's exclusive
        stack.append([self.label, now, 0.0, now])  # label, t_excl0, excl, t0
        return self

    def __exit__(self, *exc):
        if not _enabled:
            return False
        now = time.perf_counter()
        stack = _local.stack
        label, t_excl0, excl, t0 = stack.pop()
        excl += now - t_excl0
        total = now - t0
        with _lock:
            slot = _slots.setdefault(label, [0.0, 0.0, 0])
            slot[0] += excl * 1e6
            slot[1] += total * 1e6
            slot[2] += 1
        if stack:
            stack[-1][1] = now  # resume parent's exclusive clock
        return False


@contextlib.contextmanager
def scope(label: str):
    """Host Trace + torch.profiler.record_function in one."""
    with Trace(label), torch.profiler.record_function(label):
        yield


def trace_report() -> str:
    """Text report: exclusive/total microseconds per label
    (ref TraceReport, toolkit/trace.cc:37-80)."""
    with _lock:
        rows = sorted(_slots.items(), key=lambda kv: -kv[1][0])
    lines = [f"{'label':30s} {'count':>8s} {'excl (us)':>14s} {'total (us)':>14s}"]
    for label, (excl, total, count) in rows:
        lines.append(f"{label:30s} {count:8d} {excl:14.1f} {total:14.1f}")
    return "\n".join(lines)


def timings() -> Dict[str, Tuple[float, float, int]]:
    with _lock:
        return {k: tuple(v) for k, v in _slots.items()}
