"""Batched rollouts: back-to-back `parallel.rollout.rollout_batched` calls
of one client, each call's final states copied to the host, as a dataset
writer or a policy evaluator collects them.

Traffic keys: batch (B), horizon (H), start_sets, jitter, check_calls,
trace_skip, trace_calls.  Start set j is the
configuration's state with every coordinate of p shifted by U(0, jitter)
per scenario, drawn on the device from the seed; call i starts from set
i mod start_sets.

End to end: scenario_steps_per_s = B H calls / the window's seconds.
Check: `check_calls` calls drawn from the seed among all calls of the
window, every scenario of each rolled out again by the configuration's
plain reference in float64; the largest gaps of p, q, v and w over them.
The reference's contacts in those rollouts are what `work.Tally` counts
for the chain's roofline.
"""

from __future__ import annotations

import contextlib
import time

import torch

from eggshell_tpu_torch.parallel import rollout as port_rollout
from eggshell_tpu_torch.physics.scene import State
from portbench import harness, work
from portbench import trace as tr


class Runner:
    def __init__(self, ctx: harness.Ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.B, self.H, self.sets = t["batch"], t["horizon"], t["start_sets"]
        self.spec, self.base = harness.port_scene(ctx.config, ctx.device)
        self.cfg = harness.port_config(ctx.config)
        self.steps_per_call, self.batch = self.H, self.B
        self.flops_per_scenario_step = None

    def prepare(self, seed: int) -> None:
        dev, B = self.ctx.device, self.B
        gen = torch.Generator(dev).manual_seed(harness.derived_seed(seed, 1))
        n = self.base.p.shape[0]
        self.starts = []
        for _ in range(self.sets):
            shift = torch.rand((B, 1, 3), generator=gen, device=dev,
                               dtype=self.base.p.dtype) * self.ctx.traffic["jitter"]
            self.starts.append(State(p=(self.base.p.expand(B, n, 3) + shift).contiguous(),
                                     v=self.base.v.expand(B, n, 3).contiguous(),
                                     q=self.base.q.expand(B, n, 4).contiguous(),
                                     w=self.base.w.expand(B, n, 3).contiguous()))
        pin = dev.type == "cuda"
        self.host = State(*(torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
                            for x in self.starts[0]))
        self.kept = harness.Reservoir(self.ctx.traffic["check_calls"], seed)

    def _call(self, i: int) -> None:
        final = port_rollout.rollout_batched(self.spec, self.starts[i % self.sets], self.cfg,
                                             self.H)
        for h, f in zip(self.host, final):
            h.copy_(f, non_blocking=True)
        if self.ctx.device.type == "cuda":
            torch.cuda.current_stream(self.ctx.device).synchronize()

    def warm(self) -> None:
        """Capture the step's graphs (the first call) and replay them once."""
        for i in range(2):
            self._call(i)

    def window(self, seconds: float, trace: bool) -> dict:
        """Calls back to back until `seconds` have passed; with `trace`, a
        stretch of trace_calls calls after trace_skip is traced
        (`trace.Stretch`) and returned as "trace"."""
        t = self.ctx.traffic
        stretch = tr.Stretch(t["trace_skip"], t["trace_calls"], self.H) if trace else None
        out = {}
        calls = 0
        t0 = time.perf_counter()
        while True:
            with stretch.span(calls) if trace else contextlib.nullcontext():
                self._call(calls)
            self.kept.offer(calls, lambda c=calls: (c % self.sets,
                                                    State(*(h.clone() for h in self.host))))
            traced = not trace or stretch.done(calls)
            calls += 1
            if time.perf_counter() - t0 >= seconds and traced:
                break
        elapsed = time.perf_counter() - t0
        harness.log(f"[window] {calls} calls of B={self.B}, H={self.H} in {elapsed:.6f} s")
        if trace:
            out["trace"] = stretch.trace
            harness.log(f"[trace] {stretch.tries} stretch(es) traced, replayed operations a "
                        f"call {tr.replayed_per_call(stretch.trace)}")
        out.update(attempted=calls, e2e={"scenario_steps_per_s": self.B * self.H * calls / elapsed})
        return out

    def release(self) -> None:
        port_rollout.clear_graphs()

    def _reference_final(self, ref, j: int, dtype, tally=None):
        """The plain reference's final states of start set j."""
        scene, _ = ref.scene_of(self.ctx.config, dtype, self.ctx.device)
        solver = ref.solver_of(self.ctx.config)
        st = ref.Bodies(*(x.to(dtype) for x in self.starts[j]))
        return ref.rollout(scene, st, solver, self.H,
                           tally=None if tally is None else tally.add)

    def _gaps(self, got, want) -> dict:
        def gap(a, b):
            d = (a.to(torch.float64).cpu() - b.to(torch.float64).cpu()).abs()
            return float(d.max()) if bool(torch.isfinite(d).all()) else float("inf")

        return {"p_gap_m": gap(got.p, want.p), "q_gap": gap(got.q, want.q),
                "v_gap_m_per_s": gap(got.v, want.v), "w_gap_rad_per_s": gap(got.w, want.w)}

    def readings(self, lower_precision=None) -> tuple[dict, int, list]:
        """The compared numbers over the kept calls, the calls whose numbers
        pass a limit, and each call's own readings.  With
        `lower_precision` (a dtype) the reference in that dtype stands in
        for the program: the control."""
        ref = self.ctx.reference()
        scene, _ = ref.scene_of(self.ctx.config, torch.float64, self.ctx.device)
        tally = work.Tally(scene.inv_mass > 0, ref.solver_of(self.ctx.config).sweeps)
        per_call = []
        for i, (j, final) in sorted(self.kept.kept.items()):
            want = self._reference_final(ref, j, torch.float64, tally)
            got = final if lower_precision is None else self._reference_final(
                ref, j, lower_precision)
            per_call.append((i, self._gaps(got, want)))
        self.flops_per_scenario_step = tally.per_scenario_step()
        worst = {k: max(g[k] for _, g in per_call) for k in per_call[0][1]}
        failed = sum(1 for _, g in per_call
                     if any(not g[k] <= lim for k, lim in self.ctx.limits.items()))
        return worst, failed, per_call
