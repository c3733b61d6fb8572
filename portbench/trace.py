"""A traced stretch of a run, read from torch.profiler's trace.

The benchmark's own spans are `torch.profiler.record_function` ranges
around the calls it makes into the program (`CALL`) and around the traced
stretch (`WINDOW`).  A device operation counts as launched by a CUDA graph
replay when its correlation id is that of a `cudaGraphLaunch`.  Busy time
is the union of the device operations' intervals, never their sum, so
operations that overlap on two streams count once.  The profiler can lose
operations; a stretch in which a traced call launched fewer replayed
operations than another is traced again (`Stretch`), and is not read
where it stays short (`complete`).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import NamedTuple

import torch

WINDOW = "portbench.window"
CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Op(NamedTuple):
    name: str
    start: float         # microseconds on the trace's clock
    end: float
    graph: bool          # launched by a CUDA graph replay


class Trace(NamedTuple):
    window: tuple        # (start, end) of WINDOW, microseconds
    ops: list            # device Ops inside the window, by start
    calls: list          # (start, end) of each CALL span
    host: list           # (start, end, name) of the host's events


def start():
    """A running torch.profiler of the host and the card."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def finish(prof) -> Trace:
    """Stop `prof` and read its trace (written to a file under TMPDIR and
    removed)."""
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def parse(events: list) -> Trace:
    spans = [e for e in events if e.get("ph") == "X"]
    graph_corr = {e["args"].get("correlation") for e in spans
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and e.get("name", "").startswith("cudaGraphLaunch")}
    graph_corr.discard(None)
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in spans
               if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = windows[0]
    ops = sorted((Op(e["name"], e["ts"], e["ts"] + e["dur"],
                     e.get("args", {}).get("correlation") in graph_corr)
                  for e in spans if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1),
                 key=lambda o: o.start)
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                   if e.get("cat") == "user_annotation" and e.get("name") == CALL)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
            if e.get("cat") in HOST_CATS and e.get("name") not in (WINDOW, CALL)]
    return Trace((w0, w1), ops, calls, host)


def replayed_per_call(trace: Trace) -> list:
    """The number of replayed device operations in each CALL span."""
    return [sum(o.graph for o in ops_in(trace, span)) for span in trace.calls]


def complete(trace: Trace, steps_per_call: int) -> bool:
    """Whether the profiler kept every replayed operation of the stretch:
    every traced call replays the same steps, so each launched the same
    number of replayed operations, a multiple of its steps; an operation
    the profiler lost leaves its call short."""
    counts = replayed_per_call(trace)
    return bool(counts) and len(set(counts)) == 1 and counts[0] % steps_per_call == 0


class Stretch:
    """The traced stretch of a window.  The profiler runs from an
    attempt's first call; the attempt's calls `skip` to `skip + calls` are
    traced inside WINDOW, each in a CALL span (the first calls under a
    profiler pay its start).  Where the stretch is not `complete`, it is
    traced again from the next call, `attempts` times at most; `trace` is
    the stretch read, None until then."""

    def __init__(self, skip: int, calls: int, steps_per_call: int, attempts: int = 5):
        self.skip, self.calls, self.steps, self.attempts = skip, calls, steps_per_call, attempts
        self.first, self.tries, self.trace = 0, 1, None
        self._prof, self._win = start(), None

    def span(self, i: int):
        """The span call i runs in."""
        k = i - self.first
        if self.trace is not None or not self.skip <= k < self.skip + self.calls:
            return contextlib.nullcontext()
        if k == self.skip:
            self._win = torch.profiler.record_function(WINDOW)
            self._win.__enter__()
        return torch.profiler.record_function(CALL)

    def done(self, i: int) -> bool:
        """After call i: whether the stretch has been read."""
        if self.trace is None and i - self.first == self.skip + self.calls - 1:
            self._win.__exit__(None, None, None)
            t = finish(self._prof)
            if complete(t, self.steps) or self.tries == self.attempts:
                self.trace = t
            else:
                self.first, self.tries, self._prof = i + 1, self.tries + 1, start()
        return self.trace is not None


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def ops_in(trace: Trace, span) -> list:
    return [o for o in trace.ops if span[0] <= o.start <= span[1]]


def busy_s(trace: Trace) -> float:
    return covered((o.start, o.end) for o in trace.ops) * 1e-6


def window_s(trace: Trace) -> float:
    return (trace.window[1] - trace.window[0]) * 1e-6


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps of the window, each named by the innermost host event
    that spans the gap's middle."""
    by_name = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union((o.start, o.end) for o in trace.ops)
    edges = [trace.window[0]] + [x for iv in busy for x in iv] + [trace.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        around = [h for h in trace.host if h[0] <= mid <= h[1]]
        name = min(around, key=lambda h: h[1] - h[0])[2] if around else "host, untraced"
        named.append([name, (e - s) * 1e-6])
    return {"device_ops": [[n, v] for n, v in device_ops], "idle_gaps": named}
