"""Where the time of one batched step goes, on the card.

    python -m eggshell_tpu_torch.profile_step [scene ...]

On B = 4096 scenarios of `box_stack(4)` with the bench's jitter, float32:

1. the fused step (bench configuration, bench.py:80-94) phase by phase,
   host clock with a synchronise after each phase, the median over REPS
   steps: packed narrowphase, compaction, prep, Jacobian blocks, A, packed
   Jacobi, integrate;
2. one torch.profiler window of REPS steps for each branch (fused, and
   the unfused conditional-CFM branch): device operations per step, device
   time per step, host clock per step over the window, the device's busy
   share, the kernels that take the most device time, and the device
   operations a step whose name shows a cumsum or scatter;
3. the host clock per step of REPS steps outside any profiler;
4. the same step captured in a CUDA graph (`parallel.rollout.StepGraph`,
   one step a graph, as `rollout_batched` replays it): 2 and 3 over REPS
   replays, and from the graph's window each replay's span (first kernel's
   start to last kernel's end: the step's kernels and the gaps between
   them).

Each BASELINE scene named on the command line (`physics.scenes.BASELINE`:
box_drop, pendulum_chain6, box_stack8, living_room) gets 1 and 2 and 3 for
its fused step too, with its capacity and jitter, and 4.  So does each name of
`CONFIGS`: slice_pyramid and slice_block (the fused chain with
Coulomb-pyramid friction, with block-Jacobi), box_stack8_k64 (box_stack8
at contact_capacity 64, the path through B6b), joints_unfused
(pendulum_chain6 on the unfused branch, 2 and 3 only), pgs (the JAX
package's default `SimConfig()`, projected Gauss-Seidel, on box_stack4;
2 and 3 over PGS_REPS steps), fdtd2d (one step of the 2D FDTD at
n = 2048; 2 and 3), mpc_living_room (living_room's step with a control
input, as the MPC update replays it: a `StepGraph` with controls, the
control slot filled inside the graph; 4 only) and living_room_bp
(living_room with the broadphase, pair capacity
`scenes.LIVING_ROOM_PAIR_CAPACITY`).  pile216 and pile512, the large-scene
cells of `scenes.LARGE` (their batch, the matrix-free step), get 2, 3 and
4.  gradient_mpc is bench.py:220-284's gradient cell at its small shape
(B = 256, H = 20, `bench_gradient`): one gradient call split into the
forward (H fused steps through `stepper._FusedStepDiff`, B6's impulses
saved), the whole backward, and, step by step over the forward's
trajectory, the backward's pieces: the twin's recompute
(`stepper._step_xla_twin` with the impulses adopted), autograd through it,
and within that the adjoint solve (`ops.lcp.ift_adjoint`); then 2 and 3
of the whole gradient call.

Prints one line per result and a JSON line.  It needs a CUDA device; it
never falls back to the CPU.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch

from eggshell_tpu_torch.fem import fdtd
from eggshell_tpu_torch.physics import scenes
from eggshell_tpu_torch.parallel.rollout import graph_capturable
from eggshell_tpu_torch.ops import lcp
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.physics.stepper import (_batched_ext, _fused_step, _is_fused, _pre_solve,
                                                _step_xla_twin, step_ode_batched)
from eggshell_tpu_torch.utils.config import BENCH, FrictionModel, SimConfig
from eggshell_tpu_torch.utils.profiling import device_window

B = 4096
REPS = 10
# a PGS step is some 20,000 row updates launched from the host
PGS_REPS = 2
UNFUSED = BENCH.replace(conditional_cfm=True, cond_estimator="power")
COMPACTION_OPS = ("cumsum", "scatter")
# name: (BASELINE scene, configuration)
CONFIGS = {
    "slice_pyramid": ("box_stack4", BENCH.replace(friction_model=FrictionModel.COULOMB_PYRAMID)),
    "slice_block": ("box_stack4", BENCH.replace(jacobi_block=True)),
    "box_stack8_k64": ("box_stack8", BENCH.replace(contact_capacity=64)),
    "joints_unfused": ("pendulum_chain6", UNFUSED.replace(contact_capacity=4)),
    "pgs": ("box_stack4", SimConfig(contact_capacity=20)),
    "living_room_bp": ("living_room", BENCH.replace(
        contact_capacity=32, pair_capacity=scenes.LIVING_ROOM_PAIR_CAPACITY,
        broadphase_margin=scenes.LIVING_ROOM_BP_MARGIN)),
}
FDTD_N = 2048
# bench.py:220-284's gradient cell: (B, H) of its two shapes
GRAD_SHAPES = {"small_B256_H20": (256, 20), "production_B4096_H50": (4096, 50)}


def bench_loss(spec, states, cfg, ext, H: int):
    """bench.py's gradient loss: sum(p[:, -1, 2]) + sum(ext^2) after H steps
    of `step_ode_batched` under the control wrenches `ext` (B, n, 6)."""
    s = states
    for _ in range(H):
        s = step_ode_batched(spec, s, cfg, ext)
    return torch.sum(s.p[:, -1, 2]) + torch.sum(ext * ext)


def bench_gradient(spec, states, cfg, ext, H: int):
    """bench.py's gradient call: `bench_loss` and its gradient with respect
    to `ext`."""
    e = ext.detach().requires_grad_()
    with torch.enable_grad():
        loss = bench_loss(spec, states, cfg, e, H)
        (g,) = torch.autograd.grad(loss, e)
    return loss.detach(), g


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def gradient_split(spec, states, cfg, H: int) -> dict:
    """Host ms (synchronised) of one `bench_gradient` call's forward and
    backward, and of the backward's pieces summed over the forward's H
    steps: the twin's recompute, autograd through it, and the adjoint solve
    inside that."""
    ext = torch.zeros(states.p.shape[:2] + (6,), dtype=states.p.dtype, device=states.p.device)
    bench_gradient(spec, states, cfg, ext, H)                # warm-up
    e = ext.clone().requires_grad_()
    with torch.enable_grad():
        fwd_ms, loss = _synced_ms(lambda: bench_loss(spec, states, cfg, e, H))
        bwd_ms, _ = _synced_ms(lambda: torch.autograd.grad(loss, e))
    out = {"forward_ms": fwd_ms, "backward_ms": bwd_ms, "twin_recompute_ms": 0.0,
           "twin_autograd_ms": 0.0, "adjoint_ms": 0.0}
    s = states
    for _ in range(H):
        nxt, lam = _fused_step(spec, s, cfg, ext, return_lam=True)
        inputs = State(*(x.clone().requires_grad_() for x in s))
        ei = ext.clone().requires_grad_()
        with torch.enable_grad():
            ms, twin = _synced_ms(lambda: _step_xla_twin(spec, inputs, cfg, ei, lam_saved=lam))
            out["twin_recompute_ms"] += ms
            grads = tuple(torch.ones_like(x) for x in twin)
            ms, _ = _synced_ms(lambda: torch.autograd.grad(tuple(twin), (ei, *inputs), grads))
            out["twin_autograd_ms"] += ms
        _, sys_, A, rhs, *_ = _pre_solve(spec, s, cfg, _batched_ext(ext, s))
        ms, _ = _synced_ms(lambda: lcp.ift_adjoint(A, rhs, sys_.is_eq, sys_.lo, sys_.hi, lam,
                                                  torch.ones_like(lam)))
        out["adjoint_ms"] += ms
        s = nxt
    print(f"[gradient split] B={states.p.shape[0]}, H={H}: forward {fwd_ms:.3f} ms, backward "
          f"{bwd_ms:.3f} ms; over the H steps the twin's recompute "
          f"{out['twin_recompute_ms']:.3f} ms, autograd through it "
          f"{out['twin_autograd_ms']:.3f} ms, of which the adjoint solve "
          f"{out['adjoint_ms']:.3f} ms (host clock, synchronised after each)")
    return out


def fused_phases(spec, st, cfg, reps: int) -> dict:
    """Host ms per phase of the fused step, synchronised after each: the
    median over `reps` steps, so that one stall of a shared host does not
    stand for the phase."""
    times: dict = {}

    def timed(name, fn, args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    step_ode_batched(spec, st, cfg)             # warm-up
    for _ in range(reps):
        _fused_step(spec, st, cfg, call=timed)
    return {name: statistics.median(ts) for name, ts in times.items()}


def host_ms_per_step(step, reps: int) -> float:
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile(tag, step, reps: int = REPS) -> dict:
    """Items 2 and 3 of the module's description for one step callable."""
    w = device_window(step, reps)
    host = host_ms_per_step(step, reps)
    top = sorted(w["by_name"].items(), key=lambda kv: -kv[1][0])[:12]
    compaction = sum(n for name, (_, n) in w["by_name"].items()
                     if any(op in name.lower() for op in COMPACTION_OPS))
    print(f"[profile {tag}] {w['launches']:.1f} device operations a step, device time "
          f"{w['device_ms']:.4f} ms, host clock {w['wall_ms']:.4f} ms a step in the window "
          f"(busy {100 * w['busy']:.1f} %); {host:.4f} ms a step unprofiled; "
          f"{compaction:.1f} cumsum/scatter operations a step")
    for name, (ms, n) in top:
        print(f"  {ms:.4f} ms, {n:.1f} a step: {name[:110]}")
    out = {k: w[k] for k in ("launches", "device_ms", "wall_ms", "busy")}
    out.update(unprofiled_ms=host, compaction_ops=compaction,
               top=[(name[:110], ms, n) for name, (ms, n) in top])
    return out


def _span_ms(events, per_replay: int, reps: int) -> float:
    """The median over the replays of a graph window (`per_replay` device
    operations each, in start order) of a replay's span in ms."""
    spans = []
    for r in range(reps):
        ev = events[r * per_replay:(r + 1) * per_replay]
        spans.append((max(e.time_range.end for e in ev) - ev[0].time_range.start) * 1e-3)
    return statistics.median(spans)


def profile_graph(tag, spec, st, cfg, reps: int = REPS, controls=None,
                  controlled_body: int = 0) -> dict:
    """Item 4 of the module's description for one step; with
    `controls` (B, H, 6), H above the 7 * reps + 2 replays this makes, the
    step with that control input."""
    from eggshell_tpu_torch.parallel.rollout import StepGraph

    t0 = time.perf_counter()
    g = StepGraph(spec, cfg, st, controls=controls, controlled_body=controlled_body)
    capture_s = time.perf_counter() - t0
    g.load(st, controls=controls)
    out = profile(f"{tag} graph", lambda: g.replay(1), reps)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):       # a window that lost events is taken again
        with torch.profiler.profile(activities=acts) as prof:
            g.replay(reps)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events and len(events) % reps == 0:
            break
    else:
        raise RuntimeError(f"[profile {tag} graph] no whole window of {reps} replays")
    out.update(span_ms=_span_ms(events, len(events) // reps, reps), capture_s=capture_s)
    print(f"[profile {tag} graph] a replay's span {out['span_ms']:.4f} ms (median); capture "
          f"{capture_s:.3f} s")
    return out


def report_phases(tag, spec, st, cfg) -> dict:
    phases = fused_phases(spec, st, cfg, REPS)
    total = sum(phases.values())
    print(f"[phases {tag}] synchronised after each phase, medians summing to {total:.4f} ms "
          f"a step:")
    for name, ms in phases.items():
        print(f"  {name}: {ms:.4f} ms ({100 * ms / total:.1f} %)")
    return phases


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    spec, st, cfg = scenes.baseline_batch("box_stack4", B, device=dev)
    result = {"B": B, "reps": REPS, "card": torch.cuda.get_device_name(0)}
    result["phases_fused_ms"] = report_phases("fused", spec, st, cfg)
    for tag, c in (("fused", cfg), ("unfused", UNFUSED)):
        result[tag] = profile(tag, lambda: step_ode_batched(spec, st, c))
    result["fused_graph"] = profile_graph("fused", spec, st, cfg)
    for name in argv:
        if name == "gradient_mpc":
            Bg, Hg = GRAD_SHAPES["small_B256_H20"]
            gspec, gst, gcfg = scenes.baseline_batch("box_stack4", Bg, device=dev)
            ext = torch.zeros(gst.p.shape[:2] + (6,), device=dev)
            result[name] = {"split": gradient_split(gspec, gst, gcfg, Hg), **profile(
                name, lambda: bench_gradient(gspec, gst, gcfg, ext, Hg), 2)}
            continue
        if name == "mpc_living_room":
            mspec, mst, mcfg = scenes.baseline_batch("living_room", B, device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            ctrls = 5.0 * torch.randn((B, 8 * REPS, 6), generator=gen, device=dev)
            result[name] = profile_graph(name, mspec, mst, mcfg, controls=ctrls,
                                         controlled_body=4)
            continue
        if name == "fdtd2d":
            grids = fdtd.fused_grids(fdtd.init_2d(FDTD_N, FDTD_N, device=dev))
            dt = fdtd.courant_dt(1.0, 2, 0.7)
            result[name] = profile(name, lambda: fdtd.step_2d_fused(*grids, dt, 1.0))
            continue
        if name in scenes.LARGE:
            sspec, sst, scfg = scenes.large_batch(name, device=dev)
        else:
            scene, scfg = CONFIGS.get(name, (name, None))
            sspec, sst, bcfg = scenes.baseline_batch(scene, B, device=dev)
            scfg = bcfg if scfg is None else scfg
        phases = report_phases(name, sspec, sst, scfg) if _is_fused(scfg) else {}
        result[name] = {"phases_ms": phases, **profile(
            name, lambda: step_ode_batched(sspec, sst, scfg), PGS_REPS if name == "pgs" else REPS)}
        if graph_capturable(scfg):
            result[name]["graph"] = profile_graph(name, sspec, sst, scfg)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
