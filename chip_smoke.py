#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`eggshell_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `eggshell_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version on the card (on random inputs and on the
inputs of the slice's first step), passes the oracle gate of
the 4-box stack (DIRECT/f64 trajectory in tests/data/oracle_stack4_f64.npz,
bound 1e-3 at every stored checkpoint), then rolls B=4096 box_stack(4)
scenarios H=50 steps through `rollout_batched` and checks that every step
went through both kernels.  Any failed phase exits nonzero.  The last
three lines of standard output are the card's name and power limit, one
JSON line of per-kernel results, and one JSON line with "ok".

It needs a CUDA device and imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(HERE, "tests", "data", "oracle_stack4_f64.npz")
B_SLICE, H_SLICE = 4096, 50
SEED = 0


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def slice_cfg():
    from eggshell_tpu_torch.utils.config import SimConfig, SolverKind

    return SimConfig(solver=SolverKind.JACOBI_KERNEL, solver_iters=16, jacobi_omega=0.3,
                     jacobi_beta=0.45, conditional_cfm=True, cond_estimator="power",
                     contact_capacity=20, contact_kernel=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() in ms over `reps` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def slice_states(B: int, dev):
    """box_stack(4) broadcast to B scenarios with the bench's jitter: every
    coordinate of scenario b shifted by b * 1e-3 / (B - 1)."""
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.scene import State

    spec, st = scenes.box_stack(4, device=dev, dtype=torch.float32)
    states = State(*[x.expand((B,) + x.shape).clone() for x in st])
    jitter = torch.linspace(0, 1e-3, B, device=dev, dtype=torch.float32)
    return spec, states._replace(p=states.p + jitter[:, None, None])


def _rotations(rng, n):
    from eggshell_tpu_torch.ops.quaternion import quat_normalize, quat_to_mat

    return quat_to_mat(quat_normalize(torch.tensor(rng.normal(size=(n, 4))))).numpy()


def narrowphase_pairs(n: int, rng):
    """n box pairs: half generic random poses, and an eighth each of boxes
    stacked with overlap, exactly touching, coincident and separated."""
    c1 = rng.uniform(-1, 1, (n, 3))
    c2 = rng.uniform(-1, 1, (n, 3))
    h1 = rng.uniform(0.05, 0.6, (n, 3))
    h2 = rng.uniform(0.05, 0.6, (n, 3))
    R1 = _rotations(rng, n)
    R2 = _rotations(rng, n)
    kind = np.arange(n) % 8          # 0-3 generic, 4 stacked, 5 touching, 6 coincident, 7 separated
    special = kind >= 4
    R1[special] = np.eye(3)
    R2[special] = np.eye(3)
    up = np.zeros((n, 3))
    up[:, 2] = h1[:, 2] + h2[:, 2]
    c2[kind == 4] = c1[kind == 4] + 0.95 * up[kind == 4]
    c2[kind == 5] = c1[kind == 5] + up[kind == 5]
    c2[kind == 6] = c1[kind == 6]
    c2[kind == 7] = c1[kind == 7] + 1.5 * up[kind == 7]
    return (c1, R1, h1, c2, R2, h2), kind


def compare_contacts(what: str, got, want, generic=None) -> float:
    """Hold the kernel's contacts against the plain version's: code
    agreement, active-lane agreement where codes agree, and the max |d|
    of positions and depths on lanes active in both (bound 1e-4)."""
    same = got.code == want.code
    agree = float(same.float().mean())
    both = got.active & want.active & same[:, None]
    act_agree = float((got.active == want.active)[same].float().mean())
    err_pos = float((got.position - want.position).abs().amax(-1)[both].max())
    err_dep = float((got.depth - want.depth).abs()[both].max())
    err = max(err_pos, err_dep)
    line = f"[narrowphase] {what}: code agreement {agree:.6f}"
    if generic is not None:
        agree_generic = float(same[generic].float().mean())
        line += f" (generic poses {agree_generic:.6f})"
        check(agree_generic >= 0.999,
              f"narrowphase code agreement on generic poses {agree_generic}")
    print(f"{line}, active-lane agreement where codes agree {act_agree:.6f}, "
          f"max |dpos| {err_pos:.3e}, max |ddepth| {err_dep:.3e} on lanes active in both "
          f"(bound 1e-4)")
    check(agree >= 0.99, f"narrowphase code agreement {agree}")
    check(act_agree >= 0.99, f"narrowphase active-lane agreement {act_agree}")
    check(err <= 1e-4, f"narrowphase max abs error {err}")
    check(bool(torch.isfinite(got.position).all() & torch.isfinite(got.depth).all()),
          "narrowphase output not finite")
    return err


def phase_narrowphase(dev, main_args):
    from eggshell_tpu_torch.ops.collision import collide_boxes
    from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes

    rng = np.random.default_rng(SEED)
    arrays, kind = narrowphase_pairs(65536, rng)
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous() for a in arrays]
    err = compare_contacts("65536 pairs", collide_boxes_lanes(*args), collide_boxes(*args),
                           generic=torch.as_tensor(kind < 4, device=dev))
    err = max(err, compare_contacts(f"main-path inputs N={main_args[0].shape[0]}",
                                    collide_boxes_lanes(*main_args), collide_boxes(*main_args)))

    ms = cuda_ms(lambda: collide_boxes_lanes(*main_args))
    plain_ms = cuda_ms(lambda: collide_boxes(*main_args))
    print(f"[narrowphase] main-path shape N={main_args[0].shape[0]}: kernel {ms:.4f} ms, "
          f"plain torch {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_jacobi(dev, main_lcp):
    from eggshell_tpu_torch.ops.pgs_kernel import solve_lcp_jacobi, solve_lcp_jacobi_plain

    B, m, iters, omega, beta = 4096, 60, 16, 0.3, 0.45
    g = torch.Generator(device="cpu").manual_seed(SEED)
    G = torch.randn(B, m, 24, generator=g, dtype=torch.float64)
    A = (G @ G.transpose(-1, -2) / 24 + torch.eye(m, dtype=torch.float64)).float().to(dev)
    b = torch.randn(B, m, generator=g).float().to(dev)
    row = torch.arange(m)
    is_eq = (row % 10 == 9).expand(B, m).contiguous().to(dev)
    normal = (row % 3 == 2).expand(B, m)
    lo = torch.where(normal, 0.0, -1.0).float().contiguous().to(dev)
    hi = torch.where(normal, float("inf"), 1.0).float().contiguous().to(dev)
    def compare(what, args):
        got = solve_lcp_jacobi(*args, iters, omega, beta)
        want = solve_lcp_jacobi_plain(*args, iters, omega, beta)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        print(f"[jacobi] {what}, iters 16: max |dx| {err:.3e}, relative {rel:.3e} "
              f"(bound 1e-4)")
        check(bool(torch.isfinite(got).all()), "jacobi output not finite")
        check(rel <= 1e-4, f"jacobi relative error {rel}")
        return err

    err = max(compare("SPD (4096, 60, 60)", (A, b, is_eq, lo, hi)),
              compare(f"main-path inputs {tuple(main_lcp[0].shape)}", main_lcp))

    ms = cuda_ms(lambda: solve_lcp_jacobi(*main_lcp, iters, omega, beta))
    plain_ms = cuda_ms(lambda: solve_lcp_jacobi_plain(*main_lcp, iters, omega, beta))
    print(f"[jacobi] main-path shape {tuple(main_lcp[0].shape)}: kernel {ms:.4f} ms, "
          f"plain torch {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def main_path_inputs(dev):
    """The kernels' inputs at the first step of the slice."""
    from eggshell_tpu_torch.physics import contacts, stepper

    spec, states = slice_states(B_SLICE, dev)
    nargs = contacts.pair_inputs(spec, states, states.R())
    sys_, A, rhs, _, _, _ = stepper._pre_solve(spec, states, slice_cfg())
    lcp = tuple(x.contiguous() for x in (A, rhs, sys_.is_eq, sys_.lo, sys_.hi))
    return nargs, lcp


def phase_oracle(dev):
    from eggshell_tpu_torch.parallel.rollout import rollout_batched
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.scene import State

    ref = np.load(ORACLE)
    spec, st = scenes.box_stack(4, device=dev, dtype=torch.float32)
    states = State(*[x.expand((8,) + x.shape).clone() for x in st])
    cfg = slice_cfg()
    prev, err_p, err_v = 0, 0.0, 0.0
    for ck in [int(s) for s in ref["steps"]]:
        states = rollout_batched(spec, states, cfg, ck - prev)
        prev = ck
        ep = float(np.abs(states.p[0].double().cpu().numpy() - ref[f"p{ck}"]).max())
        ev = float(np.abs(states.v[0].double().cpu().numpy() - ref[f"v{ck}"]).max())
        print(f"[oracle] step {ck}: err_p {ep:.3e}, err_v {ev:.3e} (bound 1e-3)")
        err_p, err_v = max(err_p, ep), max(err_v, ev)
    check(err_p < 1e-3 and err_v < 1e-3, f"oracle gate err_p {err_p} err_v {err_v}")
    return err_p, err_v


def phase_slice(dev):
    from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes
    from eggshell_tpu_torch.ops.pgs_kernel import solve_lcp_jacobi
    from eggshell_tpu_torch.parallel.rollout import rollout_batched

    cfg = slice_cfg()
    spec, states = slice_states(B_SLICE, dev)
    warm = rollout_batched(spec, states, cfg, H_SLICE)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(warm.p).all()), "warm-up rollout not finite")

    collide_boxes_lanes.launches = 0
    solve_lcp_jacobi.launches = 0
    t0 = time.perf_counter()
    final = rollout_batched(spec, states, cfg, H_SLICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"narrowphase": collide_boxes_lanes.launches, "jacobi": solve_lcp_jacobi.launches}

    finite = all(bool(torch.isfinite(x).all()) for x in final)
    shapes = [tuple(x.shape) for x in final]
    print(f"[slice] B={B_SLICE} H={H_SLICE}: {dt:.4f} s, {B_SLICE / dt:.1f} rollouts/s, "
          f"{B_SLICE * H_SLICE / dt:.1f} steps/s; launches {launches}; finite {finite}; "
          f"shapes {shapes}")
    check(finite, "slice output not finite")
    check(shapes == [(B_SLICE, 4, 3), (B_SLICE, 4, 3), (B_SLICE, 4, 4), (B_SLICE, 4, 3)],
          f"slice output shapes {shapes}")
    check(launches == {"narrowphase": H_SLICE, "jacobi": H_SLICE},
          f"kernel launches on the main path {launches}, expected {H_SLICE} each")
    # the stack stays standing: top box within 1 cm of its start height
    top = final.p[:, 3, 2] - states.p[:, 3, 2]
    check(bool(top.abs().max() < 1e-2), f"top box moved {float(top.abs().max())} m")
    return launches, B_SLICE / dt


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from eggshell_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.load()
    print(f"[card] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({kernels.library_path().name})")

    nargs, lcp = main_path_inputs(dev)
    nres = phase_narrowphase(dev, nargs)
    jres = phase_jacobi(dev, lcp)
    phase_oracle(dev)
    launches, _ = phase_slice(dev)

    print(card_line())
    print(json.dumps({"kernels": [
        {"name": "narrowphase", "route": "cuda",
         "source": "eggshell_tpu_torch/csrc/narrowphase.cu",
         "replaces": "eggshell_tpu/ops/collision_kernel.py:58",
         "launches": launches["narrowphase"], "max_abs_err": nres["max_abs_err"],
         "ms": nres["ms"], "plain_ms": nres["plain_ms"]},
        {"name": "jacobi", "route": "cuda",
         "source": "eggshell_tpu_torch/csrc/jacobi.cu",
         "replaces": "eggshell_tpu/ops/pgs_kernel.py:47",
         "launches": launches["jacobi"], "max_abs_err": jres["max_abs_err"],
         "ms": jres["ms"], "plain_ms": jres["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
