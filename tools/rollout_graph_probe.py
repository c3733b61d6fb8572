#!/usr/bin/env python3
"""The captured rollout on the card: which of its two designs is faster,
and which unfused configurations capture at all.

    python tools/rollout_graph_probe.py            # both parts
    python tools/rollout_graph_probe.py designs    # part 1 only
    python tools/rollout_graph_probe.py captures   # part 2 only
    python tools/rollout_graph_probe.py controls   # part 3 only

1. Designs.  On B = 4096 scenarios of each BASELINE scene (bench
   configuration, the scene's capacity and jitter), H = 50 steps: the
   eager loop, (a) one-step graphs replayed H times, reading and writing
   two state buffers in turn (`StepGraph`, what `rollout_batched` runs),
   and (b) the H steps unrolled in one capture, replayed once
   (`UnrolledGraph`, built here only).  Each runs REPS times in turns
   (loop, a, b, then the other way round, ...) after a warm-up call; each
   must give the loop's bits.  Prints each one's rollouts/s (host clock
   of a synchronised call) and its capture seconds.  These are the
   measurements behind the one-step graphs of `parallel.rollout`.
2. Captures.  Unfused configurations (the conditional-CFM slice with the
   power estimator and the jointed chain on the unfused branch, which
   `capture_refusal` refuses, and the plain Jacobi solve with always-on
   CFM, which it takes since the contacts' constants are made on the card)
   are captured (`StepGraph`, bypassing the rule) each in a process of its
   own, replayed 3 steps and held against the loop.
   Prints whether it captured, or the error it raised.  The power
   estimator's factorisation and solves (`stepper._cond_bounds_power`:
   `cholesky_ex`, `cholesky_solve`) are captured alone too, on a seeded
   SPD batch at the slice's m = 60, whatever stops the whole step first.
3. Controls.  The controlled rollout of the MPC cell (bench.py:181-218:
   living_room, S = 4096 samples, H = 20 controls, body 4, sigma 5,
   "constant" noise, the bench configuration at contact_capacity 32): the
   eager loop, (a) the control slot filled inside the graph from a device
   step counter (`StepGraph` with controls, what `mpc.sampling` runs) and
   (b) the slot filled by one copy launched from the host between replays
   (`HostFillGraph`, built here only), REPS_CONTROLS times each in turns
   after a warm-up call; each must give the loop's bits.  Prints each
   one's rollouts/s and MPC-update-equivalents (rollouts of the S samples)
   a second, and the medians' ratio.

It needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from eggshell_tpu_torch.parallel.rollout import StepGraph, rollout_batched  # noqa: E402
from eggshell_tpu_torch.physics import scenes  # noqa: E402
from eggshell_tpu_torch.physics.stepper import _fused_step  # noqa: E402
from eggshell_tpu_torch.utils.config import BENCH, SolverKind  # noqa: E402

B, H, REPS = 4096, 50, 3
S_CONTROLS, H_CONTROLS, BODY, REPS_CONTROLS = 4096, 20, 4, 5
UNFUSED = BENCH.replace(conditional_cfm=True, cond_estimator="power")
CAPTURES = {
    "slice_unfused_power": ("box_stack4", UNFUSED),
    "joints_unfused": ("pendulum_chain6", UNFUSED.replace(contact_capacity=4)),
    "plain_jacobi": ("box_stack4", BENCH.replace(solver=SolverKind.JACOBI)),
}


class UnrolledGraph(StepGraph):
    """Design (b): H fused steps in each graph, so a replay advances H."""

    def _body(self, src):
        sts, out = self.buffers[src], self.buffers[1 - src]
        for _ in range(H - 1):
            sts = _fused_step(self.spec, sts, self.cfg)
        _fused_step(self.spec, sts, self.cfg, out=out)


class HostFillGraph(StepGraph):
    """Design (b) of the controlled step: the graph reads `ext` as it is,
    and a copy launched from the host fills the controlled body's slot
    before each replay."""

    def _control(self):
        return self.ext

    def replay(self, times):
        for _ in range(times):
            t = self.controls.shape[1] - self.left
            self.ext[:, self.controlled_body].copy_(self.controls[:, t])
            super().replay(1)


def seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def designs(dev) -> None:
    for scene in scenes.BASELINE:
        spec, st, cfg = scenes.baseline_batch(scene, B, device=dev)
        want = rollout_batched(spec, st, cfg, H, graph=False)
        graphs, capture = {}, {}
        for name, kind in (("a", StepGraph), ("b", UnrolledGraph)):
            t0 = time.perf_counter()
            graphs[name] = kind(spec, cfg, st)
            torch.cuda.synchronize()
            capture[name] = time.perf_counter() - t0

        def run(name):
            if name == "loop":
                return lambda: rollout_batched(spec, st, cfg, H, graph=False)
            g = graphs[name]
            return lambda: (g.load(st), g.replay(H if name == "a" else 1))

        times = {k: [] for k in ("loop", "a", "b")}
        for r in range(REPS):
            order = ("loop", "a", "b") if r % 2 == 0 else ("b", "a", "loop")
            for name in order:
                times[name].append(seconds(run(name)))
        for name in ("a", "b"):
            same = all(torch.equal(x, y) for x, y in zip(graphs[name].state, want))
            if not same:
                raise SystemExit(f"{scene} design {name}: not the loop's bits")
        rate = {k: [B / t for t in v] for k, v in times.items()}
        med = {k: statistics.median(v) for k, v in rate.items()}
        print(f"[designs] {scene}: loop {rate['loop']} rollouts/s; (a) one step replayed "
              f"{rate['a']} (capture {capture['a']:.3f} s); (b) {H} steps unrolled {rate['b']} "
              f"(capture {capture['b']:.3f} s); medians loop {med['loop']:.1f}, a "
              f"{med['a']:.1f}, b {med['b']:.1f}; b / a {med['b'] / med['a']:.3f}; bits the "
              f"loop's")
        del graphs
        torch.cuda.empty_cache()


def controls(dev) -> None:
    from eggshell_tpu_torch.mpc.sampling import _sample, rollout_controlled_batched
    from eggshell_tpu_torch.physics.scene import State

    spec, st = scenes.living_room(device=dev, dtype=torch.float32)
    cfg = BENCH.replace(contact_capacity=32)
    gen = torch.Generator(device=dev).manual_seed(0)
    ctrls = _sample(torch.zeros((H_CONTROLS, 6), device=dev), gen, S_CONTROLS, 5.0, "constant")
    states = State(*(x.expand((S_CONTROLS,) + x.shape) for x in st))
    want, _ = rollout_controlled_batched(spec, states, cfg, ctrls, BODY, graph=False)
    graphs, capture = {}, {}
    for name, kind in (("a", StepGraph), ("b", HostFillGraph)):
        t0 = time.perf_counter()
        graphs[name] = kind(spec, cfg, states, controls=ctrls, controlled_body=BODY)
        torch.cuda.synchronize()
        capture[name] = time.perf_counter() - t0

    def run(name):
        if name == "loop":
            return lambda: rollout_controlled_batched(spec, states, cfg, ctrls, BODY, graph=False)
        g = graphs[name]
        return lambda: (g.load(states, controls=ctrls), g.replay(H_CONTROLS))

    times = {k: [] for k in ("loop", "a", "b")}
    for r in range(REPS_CONTROLS):
        order = ("loop", "a", "b") if r % 2 == 0 else ("b", "a", "loop")
        for name in order:
            times[name].append(seconds(run(name)))
    for name in ("a", "b"):
        if not all(torch.equal(x, y) for x, y in zip(graphs[name].state, want)):
            raise SystemExit(f"controls design {name}: not the loop's bits")
    rate = {k: [S_CONTROLS / t for t in v] for k, v in times.items()}
    med = {k: statistics.median(v) for k, v in rate.items()}
    print(f"[controls] living_room S={S_CONTROLS} H={H_CONTROLS}: rollouts/s loop {rate['loop']}; "
          f"(a) slot filled in the graph {rate['a']} (capture {capture['a']:.3f} s); (b) slot "
          f"filled from the host {rate['b']} (capture {capture['b']:.3f} s); medians loop "
          f"{med['loop']:.1f}, a {med['a']:.1f}, b {med['b']:.1f} (rollouts of the S samples a "
          f"second: {med['a'] / S_CONTROLS:.2f}, {med['b'] / S_CONTROLS:.2f}); b / a "
          f"{med['b'] / med['a']:.3f}; bits the loop's")


def try_capture_cond_bounds(dev) -> None:
    from eggshell_tpu_torch.physics.stepper import _cond_bounds_power

    g = torch.Generator(device="cpu").manual_seed(0)
    G = torch.randn(256, 60, 24, generator=g)
    A = (G @ G.transpose(-1, -2) / 24 + torch.eye(60)).to(dev)
    want = _cond_bounds_power(A)
    _cond_bounds_power(A)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = _cond_bounds_power(A)
    graph.replay()
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    print(f"[captures] cond_bounds_power: captured; a replay the eager bits: {same}")


def try_capture(name, dev) -> None:
    if name == "cond_bounds_power":
        return try_capture_cond_bounds(dev)
    scene, cfg = CAPTURES[name]
    spec, st, _ = scenes.baseline_batch(scene, 256, device=dev)
    want = rollout_batched(spec, st, cfg, 3, graph=False)
    g = StepGraph(spec, cfg, st)
    g.load(st)
    g.replay(3)
    same = all(torch.equal(x, y) for x, y in zip(g.state, want))
    print(f"[captures] {name}: captured; 3 replays the loop's bits: {same}")


def captures() -> None:
    for name in (*CAPTURES, "cond_bounds_power"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--try", name],
                             capture_output=True, text=True, timeout=600)
        lines = (out.stdout + out.stderr).strip().splitlines()
        said = [l for l in lines if l.startswith("[captures]")]
        if said:
            print(said[0])
            continue
        frames = [l.strip() for l in lines if l.strip().startswith("File ")]
        errors = [l.strip() for l in lines if "Error" in l]
        print(f"[captures] {name}: did not capture (exit {out.returncode}); innermost frames "
              f"{frames[-3:]}; {errors[-1] if errors else lines[-1]}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("rollout_graph_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if argv[:1] == ["--try"]:
        try_capture(argv[1], dev)
        return 0
    parts = argv or ["designs", "captures", "controls"]
    if "designs" in parts:
        designs(dev)
    if "captures" in parts:
        captures()
    if "controls" in parts:
        controls(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
