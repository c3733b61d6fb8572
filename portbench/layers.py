"""The arithmetic of the per-layer metrics, over a traced stretch of a run.

Each metric of `BENCHMARK.json`'s `per_layer` is a file of its own under
`layer_metrics/`, named as the metric, whose `read(view)` returns the
number or None where the trace holds nothing for it; most of them call one
of these.  `view` is a `View`.  Each returns None where the profiler lost
replayed operations of the stretch (`trace.complete`): a lost operation
would read as idle time, as fewer operations a step, as a shorter step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from portbench import trace as tr
from portbench import work


class View(NamedTuple):
    trace: tr.Trace
    steps_per_call: int      # steps a call (a rollout) or an update replays
    batch: int               # scenarios a step on this rank
    config: dict
    flops_per_scenario_step: Optional[float]   # the reference's contact work (work.Tally)


def _per_call(view: View):
    """(call span, the call's device ops) of every traced call; empty where
    the stretch is not complete."""
    if not tr.complete(view.trace, view.steps_per_call):
        return []
    return [(span, tr.ops_in(view.trace, span)) for span in view.trace.calls]


def call_overhead_ms(view: View) -> Optional[float]:
    """Mean over calls of the call's host span less the device span of its
    replays (first replayed operation's start to the last one's end)."""
    out = []
    for (s, e), ops in _per_call(view):
        rep = [o for o in ops if o.graph]
        if rep:
            out.append((e - s) - (max(o.end for o in rep) - min(o.start for o in rep)))
    return sum(out) / len(out) * 1e-3 if out else None


def _is_collective(op: tr.Op) -> bool:
    return "nccl" in op.name.lower()


def outside_replays_ms(view: View) -> Optional[float]:
    """Mean over calls of the device time of the operations that no graph
    replay launched, collectives left out."""
    calls = _per_call(view)
    if not calls:
        return None
    total = sum(tr.covered((o.start, o.end) for o in ops if not o.graph and not _is_collective(o))
                for _, ops in calls)
    return total / len(calls) * 1e-3


def collectives_ms(view: View) -> Optional[float]:
    """Mean over calls of the device time of the collectives (NCCL)."""
    calls = _per_call(view)
    found = [[o for o in ops if _is_collective(o)] for _, ops in calls]
    if not any(found):
        return None
    return sum(tr.covered((o.start, o.end) for o in f) for f in found) / len(calls) * 1e-3


def _replays(view: View):
    """(replayed device ops, steps they replay) over the traced calls."""
    calls = _per_call(view)
    ops = [o for _, c in calls for o in c if o.graph]
    return ops, len(calls) * view.steps_per_call


def ops_per_step(view: View) -> Optional[float]:
    ops, steps = _replays(view)
    return len(ops) / steps if ops else None


def chain_roofline(view: View) -> Optional[float]:
    """The least time of a step's work over the device time of a replayed
    step (the union of the replayed operations' intervals over the steps
    replayed), in percent.  The work: the step's bytes from the cell's
    shapes (`work.step_bytes`) and the flops of the contacts the plain
    reference found in the run's checked answers, a scenario-step's mean
    times the scenarios a step (`work.contact_flops`)."""
    ops, steps = _replays(view)
    if not ops or view.flops_per_scenario_step is None:
        return None
    step_s = tr.covered((o.start, o.end) for o in ops) * 1e-6 / steps
    least = work.bound_s(work.step_bytes(view.config, view.batch),
                         view.flops_per_scenario_step * view.batch)
    return 100.0 * least / step_s


def device_idle_pct(view: View) -> Optional[float]:
    """The share of the traced stretch in which no device operation ran."""
    if not view.trace.ops or not _per_call(view):
        return None
    return 100.0 * (1.0 - tr.busy_s(view.trace) / tr.window_s(view.trace))
