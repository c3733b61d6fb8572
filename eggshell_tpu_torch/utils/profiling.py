"""Device time of a callable on the card, from one `torch.profiler` window.

Used by `chip_smoke.py` and `python -m eggshell_tpu_torch.profile_step`;
nothing in the simulation path imports it.  A window with no device
activity, or a flushed window whose calls do not each start with the
flush's operations, is profiled again, at most ATTEMPTS times in all, and
then raises: a time measured on the host is never reported as a device
time, and a window that lost events is never read.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

# CUPTI has been seen to return an empty window on the H100 machine, and
# windows with events missing.
ATTEMPTS = 3
# Overwritten before each call by `l2_flush`: more than the H100's 50 MB L2.
FLUSH_BYTES = 256 << 20


class NoDeviceActivity(RuntimeError):
    """torch.profiler recorded nothing on the card in any attempted window."""


class WindowMismatch(RuntimeError):
    """A flushed window's events do not split into the calls it ran."""


def l2_flush(dev):
    """A callable that fills FLUSH_BYTES of int16 on `dev`, so that the call
    after it finds its inputs in HBM and not in L2."""
    buf = torch.empty(FLUSH_BYTES // 2, dtype=torch.int16, device=dev)
    return lambda: buf.fill_(1)


def _window(fn, reps: int, flush):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(events, key=lambda e: e.time_range.start), wall


def _drop_flush(events, reps: int, flush_names: dict):
    """The events of a flushed window without the flush's own: one stream
    runs [flush, fn] `reps` times, so each rep's events start with the
    flush's."""
    skip = sum(flush_names.values())
    per_rep, rest = divmod(len(events), reps)
    dropped = [e for r in range(reps) for e in events[r * per_rep:r * per_rep + skip]]
    got = defaultdict(int)
    for e in dropped:
        got[e.name] += 1
    if rest or dict(got) != {k: v * reps for k, v in flush_names.items()}:
        raise WindowMismatch(f"flushed window of {len(events)} device operations over {reps} "
                             f"calls does not start each call with the flush {flush_names}")
    return [e for r in range(reps) for e in events[r * per_rep + skip:(r + 1) * per_rep]]


def _flush_names(flush, reps: int) -> dict:
    """The device operations one flush() runs, by name, from a window of
    the flush alone: a window in which some operation did not run a whole,
    positive number of times a call lost events and is profiled again."""
    for _ in range(ATTEMPTS):
        counts = {k: n for k, (_, n) in device_window(flush, reps)["by_name"].items()}
        names = {k: round(n) for k, n in counts.items()}
        if all(names[k] >= 1 and names[k] * reps == round(n * reps) for k, n in counts.items()):
            return names
    raise WindowMismatch(f"no window of the flush alone in {ATTEMPTS} recorded each of its "
                         f"operations once a call: {counts}")


def device_window(fn, reps: int, flush=None) -> dict:
    """Call fn() once to warm up, then `reps` times inside one profiler
    window that traces the card only.  Per call: `device_ms` (the summed
    durations of the kernels, copies and memsets fn ran on the card),
    `launches` (their number) and `wall_ms` (host clock over the window,
    which ends in a synchronise); `busy` = device time / wall time;
    `by_name`: device ms per call and launches per call of each kernel;
    and `attempts`, the windows it took to record a whole one.
    With `flush` (see `l2_flush`), flush() runs before each call and its
    device operations are left out of every count but `wall_ms` and
    `busy`."""
    flush_names = None if flush is None else _flush_names(flush, reps)
    fn()
    torch.cuda.synchronize()
    failure = NoDeviceActivity(f"torch.profiler recorded no device activity in {ATTEMPTS} windows")
    for attempt in range(1, ATTEMPTS + 1):
        events, wall = _window(fn, reps, flush)
        if not events:
            continue
        if flush_names is None:
            break
        try:
            events = _drop_flush(events, reps, flush_names)
            break
        except WindowMismatch as e:
            failure = e
    else:
        raise failure
    by_name = defaultdict(lambda: [0.0, 0])
    total_us = 0.0
    for e in events:
        us = e.time_range.end - e.time_range.start
        total_us += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    wall_ms = wall * 1e3 / reps
    device_ms = total_us * 1e-3 / reps
    return {
        "device_ms": device_ms,
        "launches": len(events) / reps,
        "wall_ms": wall_ms,
        "busy": device_ms / wall_ms,
        "by_name": {k: (v[0] * 1e-3 / reps, v[1] / reps) for k, v in by_name.items()},
        "attempts": attempt,
    }
