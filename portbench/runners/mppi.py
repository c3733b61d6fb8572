"""A sampling-MPC controller: back-to-back MPPI updates of one client,
`mpc.sampling.mppi_update_batched` on one card, or with the samples
sharded over the ranks `parallel.mesh.sharded_mppi_update` (one process a
card).

Traffic keys: samples (S, over all ranks), horizon (H), body, sigma,
temperature, noise_mode, target, room_states, body_shift, check_updates,
trace_skip, trace_updates.  Room state j is the
configuration's state with `body` moved by U(-body_shift, body_shift) on
each axis, drawn on the device from the seed; update i starts from room
state i mod room_states.
The mean starts at zero and carries over, shifted one control period, as a
receding-horizon controller's does; the noise comes from one generator
seeded from the seed (the same on every rank).  The cost of a sample is
|p[body] - target|^2 of its final state.

End to end: mpc_update_ms_p95 over every update of the window, each timed
from its call until the host holds the new mean's first control.  Check:
`check_updates` updates drawn from the seed among all updates of the
window, each recomputed by the plain reference in float64 from the same
room state, the mean it was given (the controller's state) and the
generator's state before it (the reference draws the same noise with
`torch.randn`): the largest |dcost| over every sample and the largest
|dmean| of the new mean.  The reference's contacts in those controlled
rollouts are what `work.Tally` counts for the chain's roofline.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from eggshell_tpu_torch.mpc import sampling as port_sampling
from eggshell_tpu_torch.parallel import mesh as port_mesh
from eggshell_tpu_torch.parallel import rollout as port_rollout
from eggshell_tpu_torch.physics.scene import State
from portbench import harness, work
from portbench import trace as tr


class Runner:
    def __init__(self, ctx: harness.Ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.S, self.H, self.body = t["samples"], t["horizon"], t["body"]
        if self.S % ctx.world:
            raise ValueError(f"{self.S} samples do not split over {ctx.world} ranks")
        self.spec, self.base = harness.port_scene(ctx.config, ctx.device)
        self.cfg = harness.port_config(ctx.config)
        self.steps_per_call, self.batch = self.H, self.S // ctx.world
        self.flops_per_scenario_step = None
        dtype = self.base.p.dtype
        target = torch.tensor(t["target"], dtype=dtype, device=ctx.device)
        body = self.body

        def cost(final):
            return torch.sum((final.p[body] - target) ** 2)

        self.cost = cost
        self.mesh = None
        if ctx.world > 1:
            self.mesh = port_mesh.make_mesh(ctx.world, device=ctx.device.type)

    def prepare(self, seed: int) -> None:
        t, dev = self.ctx.traffic, self.ctx.device
        gen = torch.Generator(dev).manual_seed(harness.derived_seed(seed, 2))
        self.rooms = []
        for _ in range(t["room_states"]):
            shift = (torch.rand(3, generator=gen, device=dev, dtype=self.base.p.dtype) * 2 - 1)
            p = self.base.p.clone()
            p[self.body] += shift * t["body_shift"]
            self.rooms.append(State(p=p, v=self.base.v.clone(), q=self.base.q.clone(),
                                    w=self.base.w.clone()))
        self.noise_seed = harness.derived_seed(seed, 3)
        self.kept = harness.Reservoir(t["check_updates"], seed)
        self._reset()

    def _reset(self) -> None:
        if not hasattr(self, "noise"):
            self.noise = torch.Generator(self.ctx.device)
        self.noise.manual_seed(self.noise_seed)
        self.mean = torch.zeros((self.H, 6), dtype=self.base.p.dtype, device=self.ctx.device)

    def _update(self, i: int):
        """One update; returns (new mean, this rank's costs, its ms)."""
        t = self.ctx.traffic
        args = (self.spec, self.rooms[i % len(self.rooms)], self.cfg, self.mean, self.noise,
                self.cost)
        kw = dict(controlled_body=self.body, num_samples=self.S, noise_sigma=t["sigma"],
                  temperature=t["temperature"], noise_mode=t["noise_mode"])
        t0 = time.perf_counter()
        if self.mesh is None:
            new_mean, costs = port_sampling.mppi_update_batched(*args, **kw)
        else:
            new_mean, costs = port_mesh.sharded_mppi_update(*args, mesh=self.mesh, **kw)
        new_mean[0].cpu()
        return new_mean, costs, (time.perf_counter() - t0) * 1e3

    def _advance(self, new_mean) -> None:
        self.mean = torch.cat([new_mean[1:], torch.zeros_like(new_mean[:1])])

    def warm(self) -> None:
        """Capture the controlled period's graph (the first update) and
        replay it once; then the controller starts afresh."""
        for i in range(2):
            self._advance(self._update(i)[0])
        self._reset()

    def _stop(self, mine: bool) -> bool:
        """Whether every rank stops: one rank's clock decides for all."""
        if self.mesh is None:
            return mine
        flag = torch.tensor([1.0 if mine else 0.0], device=self.ctx.device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX,
                                     group=self.mesh.get_group())
        return bool(flag.item())

    def window(self, seconds: float, trace: bool) -> dict:
        """Updates back to back until `seconds` have passed; with `trace`,
        a stretch of trace_updates updates after trace_skip is traced
        (`trace.Stretch`) and returned as "trace"."""
        t = self.ctx.traffic
        stretch = tr.Stretch(t["trace_skip"], t["trace_updates"], self.H) if trace else None
        out, lat = {}, []
        t0 = time.perf_counter()
        while True:
            i = len(lat)
            state = self.noise.get_state()
            mean_in = self.mean
            with stretch.span(i) if trace else contextlib.nullcontext():
                new_mean, costs, ms = self._update(i)
            lat.append(ms)
            self.kept.offer(i, lambda: (i % len(self.rooms), mean_in, state, new_mean, costs))
            self._advance(new_mean)
            traced = not trace or stretch.done(i)
            if self._stop(time.perf_counter() - t0 >= seconds and traced):
                break
        elapsed = time.perf_counter() - t0
        lat = np.asarray(lat)
        harness.log(f"[window] {len(lat)} updates of S={self.S} on {self.ctx.world} rank(s), "
                    f"H={self.H} in {elapsed:.6f} s; update ms median {np.median(lat):.6f}, "
                    f"p90 {np.percentile(lat, 90):.6f}, p95 {np.percentile(lat, 95):.6f}, "
                    f"p99 {np.percentile(lat, 99):.6f}, max {lat.max():.6f} (update "
                    f"{int(lat.argmax())}), over 20 ms: {int((lat > 20).sum())}")
        if trace:
            out["trace"] = stretch.trace
            harness.log(f"[trace] {stretch.tries} stretch(es) traced, replayed operations an "
                        f"update {tr.replayed_per_call(stretch.trace)}")
        out.update(attempted=len(lat), e2e={"mpc_update_ms_p95": float(np.percentile(lat, 95))})
        return out

    def release(self) -> None:
        port_rollout.clear_graphs()

    def _all_costs(self, costs):
        if self.mesh is None:
            return costs
        return port_mesh.gather(self.mesh, costs)

    def _reference(self, ref, j, mean_in, state, dtype, tally=None):
        """The update recomputed by the reference in `dtype`: (new mean,
        costs of every sample), in blocks of one rank's share of the
        samples."""
        t, dev = self.ctx.traffic, self.ctx.device
        g = torch.Generator(dev)
        g.set_state(state)
        shape = (self.S, 1 if t["noise_mode"] == "constant" else self.H, 6)
        eps = torch.randn(shape, generator=g, dtype=mean_in.dtype, device=dev)
        ctrls = (mean_in.to(dtype)[None] + eps.to(dtype) * t["sigma"]).expand(self.S, self.H, 6)
        scene, _ = ref.scene_of(self.ctx.config, dtype, dev)
        solver = ref.solver_of(self.ctx.config)
        room = self.rooms[j]
        target = torch.tensor(t["target"], dtype=dtype, device=dev)
        costs = []
        for s in range(0, self.S, self.batch):
            c = ctrls[s:s + self.batch]
            st = ref.Bodies(*(x.to(dtype)[None].expand((c.shape[0],) + x.shape) for x in room))
            final = ref.controlled_rollout(scene, st, solver, c, self.body,
                                           None if tally is None else tally.add)
            costs.append(torch.sum((final.p[:, self.body] - target) ** 2, -1))
        costs = torch.cat(costs)
        w = torch.exp(-(costs - costs.min()) / t["temperature"])
        return torch.einsum("s,shc->hc", w / w.sum(), ctrls), costs

    def readings(self, lower_precision=None) -> tuple[dict, int, list]:
        """As the rollouts' `readings`: the largest |dcost| and |dmean| over
        the kept updates (every rank takes part; rank 0's are the run's)."""
        ref = self.ctx.reference()
        scene, _ = ref.scene_of(self.ctx.config, torch.float64, self.ctx.device)
        tally = work.Tally(scene.inv_mass > 0, ref.solver_of(self.ctx.config).sweeps)
        per_call = []
        for i, (j, mean_in, state, new_mean, costs) in sorted(self.kept.kept.items()):
            costs = self._all_costs(costs)
            if self.ctx.rank != 0:
                continue
            want_mean, want_costs = self._reference(ref, j, mean_in, state, torch.float64,
                                                    tally)
            if lower_precision is not None:
                new_mean, costs = self._reference(ref, j, mean_in, state, lower_precision)

            def gap(a, b):
                d = (a.to(torch.float64) - b).abs()
                return float(d.max()) if bool(torch.isfinite(d).all()) else float("inf")

            per_call.append((i, {"cost_gap_m2": gap(costs, want_costs),
                                 "mean_gap_n": gap(new_mean, want_mean)}))
        if self.ctx.rank != 0:
            return {}, 0, []
        self.flops_per_scenario_step = tally.per_scenario_step()
        worst = {k: max(g[k] for _, g in per_call) for k in per_call[0][1]}
        failed = sum(1 for _, g in per_call
                     if any(not g[k] <= lim for k, lim in self.ctx.limits.items()))
        return worst, failed, per_call
