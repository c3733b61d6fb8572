#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`eggshell_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `eggshell_tpu_torch/csrc/` and holds each one
against its plain PyTorch version on the card, on seeded random inputs and
on the inputs of its path's first step, with the bound printed beside the
error.  Then it drives both ported paths through `rollout_batched` on
B=4096 `box_stack(4)` scenarios with the bench's jitter:

- the fused chain under the bench configuration (bench.py:80-94,
  `conditional_cfm=False`): narrowphase, prep, Jacobian blocks, A, packed
  Jacobi and integrate kernels (phases `[oracle_fused]`, `[slice_fused]`);
- the unfused conditional-CFM branch: narrowphase and Jacobi kernels
  (phases `[oracle]`, `[slice]`).

Each path's oracle gate holds the unjittered stack to the DIRECT/f64
trajectory in tests/data/oracle_stack4_f64.npz (bound 1e-3 at every stored
checkpoint).  Each slice sets every launch counter to 0 just before its
timed run and checks just after that each kernel of its path launched
once per step and no other kernel launched.  Any failed phase exits
nonzero.  The last three lines of standard output are the card's name and
power limit, one JSON line of per-kernel results, and one JSON line with
"ok".

It needs a CUDA device and imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(HERE, "tests", "data", "oracle_stack4_f64.npz")
B_SLICE, H_SLICE = 4096, 50
SEED = 0
# Published peaks of one H100 SXM (NVIDIA's data sheet) used for each
# kernel's bound: HBM3 bandwidth and the float32 rate outside the tensor
# cores.  The kernels are float32 and use no tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def bench_cfg():
    """The bench configuration of bench.py:80-94: the fused chain."""
    from eggshell_tpu_torch.utils.config import BENCH

    return BENCH


def slice_cfg():
    """The unfused branch: the reference's conditional CFM policy."""
    return bench_cfg().replace(conditional_cfm=True, cond_estimator="power")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timings(kernel_name: str, kernel_call, plain_call, reps: int = 20) -> dict:
    """Device time per call of the hand-written kernel `kernel_name` inside
    kernel_call() (its own launches only, not the wrapper's small torch
    ops) and of every device operation of plain_call(), each from one
    torch.profiler window.  L2 is flushed before every call, as the main
    path's kernels find most of their inputs evicted by the step's other
    work; the flush is left out of both times."""
    from eggshell_tpu_torch.utils.profiling import device_window, l2_flush

    flush = l2_flush(torch.device("cuda", 0))
    pattern = re.compile(r"(^|[^A-Za-z0-9_])" + kernel_name + r"($|[^A-Za-z0-9_])")
    k = device_window(kernel_call, reps, flush)
    mine = [v for name, v in k["by_name"].items() if pattern.search(name)]
    per_call = sum(n for _, n in mine)
    check(per_call == 1, f"{kernel_name}: {per_call} launches per call in the profile "
                         f"(names {sorted(k['by_name'])[:4]})")
    p = device_window(plain_call, reps, flush)
    for what, w in (("kernel", k), ("plain", p)):
        if w["attempts"] > 1:
            print(f"[{kernel_name}] the {what} window recorded device activity only on "
                  f"attempt {w['attempts']}")
    return {"ms": sum(ms for ms, _ in mine), "plain_ms": p["device_ms"]}


def timing_text(t: dict) -> str:
    return (f"kernel {t['ms']:.4f} ms, plain torch {t['plain_ms']:.4f} ms of device time "
            f"a call, L2 flushed before each")


def tensors(x):
    """The tensors of an argument list or a result, nested tuples included."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in tensors(item)]
    return []


def moved_bytes(args, out) -> int:
    """Bytes a function must move: each input storage read once, each
    output storage written once (a tensor passed twice counts once)."""
    seen, total = set(), 0
    for t in tensors(args) + tensors(out):
        s = t.untyped_storage()
        if s.data_ptr() not in seen:
            seen.add(s.data_ptr())
            total += s.nbytes()
    return total


def bound(nbytes: int, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the flops over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


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
    out = collide_boxes_lanes(*main_args)
    err = max(err, compare_contacts(f"main-path inputs N={main_args[0].shape[0]}",
                                    out, collide_boxes(*main_args)))

    t = timings("narrowphase_kernel", lambda: collide_boxes_lanes(*main_args),
                lambda: collide_boxes(*main_args))
    # SAT over 15 axes, face clipping and contact reduction: about 2,000
    # flops a pair, counted from csrc/narrowphase.cu; bytes dominate anyway.
    b = bound(moved_bytes(main_args, out), 2000.0 * main_args[0].shape[0])
    print(f"[narrowphase] main-path shape N={main_args[0].shape[0]}: {timing_text(t)}, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": err, **t, **b}


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

    t = timings("jacobi_kernel", lambda: solve_lcp_jacobi(*main_lcp, iters, omega, beta),
                lambda: solve_lcp_jacobi_plain(*main_lcp, iters, omega, beta))
    Bm, mm = main_lcp[1].shape
    out = solve_lcp_jacobi(*main_lcp, iters, omega, beta)
    b = bound(moved_bytes(main_lcp, out), Bm * iters * (2.0 * mm * mm + 10.0 * mm))
    print(f"[jacobi] main-path shape {tuple(main_lcp[0].shape)}: {timing_text(t)}, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": err, **t, **b}


def main_path_inputs(dev):
    """The slice-1 kernels' inputs at the first step of the unfused slice."""
    from eggshell_tpu_torch.physics import contacts, stepper

    spec, states = slice_states(B_SLICE, dev)
    nargs = contacts.pair_inputs(spec, states, states.R())
    sys_, A, rhs, _, _, _ = stepper._pre_solve(spec, states, slice_cfg())
    lcp = tuple(x.contiguous() for x in (A, rhs, sys_.is_eq, sys_.lo, sys_.hi))
    return nargs, lcp


def fused_inputs(dev):
    """Each fused-chain kernel's arguments at the first step of the fused
    slice, recorded from one call of the stepper's `_fused_step`."""
    from eggshell_tpu_torch.physics.stepper import _fused_step

    args = {}

    def record(name, fn, a):
        args[name] = a
        return fn(*a)

    spec, st = slice_states(B_SLICE, dev)
    _fused_step(spec, st, bench_cfg(), call=record)
    torch.cuda.synchronize()
    return args


def random_fused_inputs(dev, B=4096, K=20, n=4):
    """Seeded random arguments of the fused-chain kernels at the main
    path's widths: random bodies and external forces; lanes with normals
    +z, -z and generic, ground, equality, inactive and idle lanes; an SPD
    system with the A kernel's padding for the solve."""
    from eggshell_tpu_torch.ops.amat_kernel import padded_rows

    rng = np.random.default_rng(SEED + 1)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    i = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev).contiguous()
    q = rng.normal(size=(B, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    G = rng.normal(size=(n, 3, 3))
    Ib = G @ G.transpose(0, 2, 1) + np.eye(3)
    nrm = rng.normal(size=(B, K, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:, 0::4] = [0.0, 0.0, 1.0]
    nrm[:, 1::4] = [0.0, 0.0, -1.0]
    b0 = rng.integers(-1, n, size=(B, K))
    b1 = (np.maximum(b0, 0) + rng.integers(1, n, size=(B, K))) % n
    act = rng.uniform(size=(B, K)) < 0.8
    idle = rng.uniform(size=(B, K)) < 0.1
    b0[idle] = b1[idle] = -1
    act[idle] = False
    eq = torch.as_tensor(rng.uniform(size=(B, K)) < 0.1, device=dev)
    act_t = torch.as_tensor(act, device=dev)
    pos = rng.normal(size=(B, K, 3))
    p, v, w = (f(rng.normal(size=(B, n, 3))) for _ in range(3))
    inv_mass = f(rng.uniform(0.5, 2.0, n))
    F = f(rng.normal(size=(B, n, 6)))
    invIg = f(np.ascontiguousarray(np.broadcast_to(np.linalg.inv(Ib), (B, n, 3, 3))))
    uhat = f(100.0 * rng.normal(size=(B, n, 6)))
    Jc = f(rng.normal(size=(B, 3 * K, 12)))
    mp = padded_rows(K)
    Gm = torch.as_tensor(rng.normal(size=(B, mp, 24)), dtype=torch.float32, device=dev)
    A = (Gm @ Gm.transpose(-1, -2) / 24 + torch.eye(mp, device=dev)).contiguous()
    diag = torch.diagonal(A, dim1=-2, dim2=-1).contiguous()
    return {
        "prep": (f(q), v, w, inv_mass, f(Ib), f(np.linalg.inv(Ib)), 1e-3, (0.0, 0.0, -9.8),
                 f(rng.normal(size=(B, n, 6)))),
        "jassembly": (i(b0), i(b1), f(pos), f(pos + 0.05 * rng.normal(size=(B, K, 3))), f(nrm),
                      f(rng.uniform(0, 0.01, (B, K))), act_t, eq, p, uhat, 2e5),
        "amat": (Jc, i(b0), i(b1), act_t, inv_mass, invIg, K, 0.01),
        "jacobi_packed": (A, diag, f(rng.normal(size=(B, 3 * K))), act_t, eq, K, 1.0, 16, 0.3,
                          0.45),
        "integrate": (Jc, f(rng.normal(size=(B, mp))), i(b0), i(b1), p, f(q), v, w, inv_mass,
                      invIg, F, 1e-3),
    }


def _fused_flops(name, args) -> float:
    """Flops of one call of a fused-chain kernel on `args`, counted from
    its source; where the work depends on the lane bodies, only the slot
    pairs and slots that touch a body are counted."""
    if name == "prep":
        return 250.0 * args[0].shape[0] * args[0].shape[1]
    if name == "jassembly":
        return 300.0 * args[0].numel()
    if name == "amat":
        Jc, b0, b1 = args[:3]
        b = torch.stack([b0, b1], -1)                                  # (B, K, 2)
        same = (b[:, :, None, :, None] == b[:, None, :, None, :]) & (b[:, :, None, :, None] >= 0)
        return 12.0 * 9 * float(same.sum()) + 5.0 * Jc.numel()
    if name == "jacobi_packed":
        B, m, iters = args[2].shape[0], args[2].shape[1], args[7]
        return B * iters * (2.0 * m * m + 10.0 * m)
    if name == "integrate":
        b0, b1, p = args[2], args[3], args[4]
        slots = float((b0 >= 0).sum() + (b1 >= 0).sum())
        return 36.0 * slots + 120.0 * p.shape[0] * p.shape[1]
    raise KeyError(name)


FUSED_KERNELS = {
    # name: (wrapper, plain, relative bound, source, replaces)
    "prep": ("prep_kernel", "prep_bodies", 1e-5, "eggshell_tpu_torch/csrc/prep.cu",
             "eggshell_tpu/ops/prep_kernel.py:50"),
    "jassembly": ("jassembly_kernel", "contact_jacobian_blocks", 1e-5,
                  "eggshell_tpu_torch/csrc/jassembly.cu", "eggshell_tpu/ops/jassembly_kernel.py:80"),
    "amat": ("amat_kernel", "contact_system_matrix", 1e-5, "eggshell_tpu_torch/csrc/amat.cu",
             "eggshell_tpu/ops/amat_kernel.py:38"),
    "jacobi_packed": ("pgs_kernel", "solve_lcp_jacobi_packed", 1e-4,
                      "eggshell_tpu_torch/csrc/jacobi_packed.cu", "eggshell_tpu/ops/pgs_kernel.py:164"),
    "integrate": ("integrate_kernel", "integrate_step", 1e-5,
                  "eggshell_tpu_torch/csrc/integrate.cu", "eggshell_tpu/ops/integrate_kernel.py:29"),
}


def fused_wrapper(name):
    import importlib

    module, fn = FUSED_KERNELS[name][:2]
    mod = importlib.import_module(f"eggshell_tpu_torch.ops.{module}")
    return getattr(mod, fn), getattr(mod, fn + "_plain")


def phase_fused_kernel(name, cases):
    """Hold one fused-chain kernel against its plain version on each case;
    the error is max |kernel - plain| over every output, and the bound is
    relative to the output's scale, max(1, max |plain|)."""
    kernel, plain = fused_wrapper(name)
    rel_bound = FUSED_KERNELS[name][2]
    err_abs = 0.0
    for what, args in cases:
        got, want = tensors(kernel(*args)), tensors(plain(*args))
        check(len(got) == len(want), f"{name}: {len(got)} outputs, plain has {len(want)}")
        case_abs, worst = 0.0, 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"{name}: output {g.shape} {g.dtype}")
            check(bool(torch.isfinite(g).all()), f"{name} output not finite on {what}")
            e = float((g - w).abs().max())
            case_abs = max(case_abs, e)
            worst = max(worst, e / max(1.0, float(w.abs().max())))
        err_abs = max(err_abs, case_abs)
        print(f"[{name}] {what}: max |d| {case_abs:.3e}, relative to scale {worst:.3e} "
              f"(bound {rel_bound:.0e})")
        check(worst <= rel_bound, f"{name} relative error {worst} on {what}")
    main_args = cases[-1][1]
    t = timings(name + "_kernel", lambda: kernel(*main_args), lambda: plain(*main_args))
    b = bound(moved_bytes(main_args, kernel(*main_args)), _fused_flops(name, main_args))
    print(f"[{name}] main-path shapes: {timing_text(t)}, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: {b['bytes']} bytes, {b['flops']:.4g} flops)")
    return {"max_abs_err": err_abs, **t, **b}


def phase_oracle(dev, cfg, tag):
    from eggshell_tpu_torch.parallel.rollout import rollout_batched
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.scene import State

    ref = np.load(ORACLE)
    spec, st = scenes.box_stack(4, device=dev, dtype=torch.float32)
    states = State(*[x.expand((8,) + x.shape).clone() for x in st])
    prev, err_p, err_v = 0, 0.0, 0.0
    for ck in [int(s) for s in ref["steps"]]:
        states = rollout_batched(spec, states, cfg, ck - prev)
        prev = ck
        ep = float(np.abs(states.p[0].double().cpu().numpy() - ref[f"p{ck}"]).max())
        ev = float(np.abs(states.v[0].double().cpu().numpy() - ref[f"v{ck}"]).max())
        print(f"[{tag}] step {ck}: err_p {ep:.3e}, err_v {ev:.3e} (bound 1e-3)")
        err_p, err_v = max(err_p, ep), max(err_v, ev)
    check(err_p < 1e-3 and err_v < 1e-3, f"{tag} gate err_p {err_p} err_v {err_v}")
    return err_p, err_v


def launch_counters():
    from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes
    from eggshell_tpu_torch.ops.pgs_kernel import solve_lcp_jacobi

    out = {"narrowphase": collide_boxes_lanes, "jacobi": solve_lcp_jacobi}
    out.update({name: fused_wrapper(name)[0] for name in FUSED_KERNELS})
    return out


def phase_slice(dev, cfg, tag, path):
    """Roll B_SLICE scenarios H_SLICE steps once to warm up, then once
    timed with every launch counter set to 0 just before; the kernels of
    `path` must each have launched once a step and no other kernel at all."""
    from eggshell_tpu_torch.parallel.rollout import rollout_batched

    spec, states = slice_states(B_SLICE, dev)
    warm = rollout_batched(spec, states, cfg, H_SLICE)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(warm.p).all()), f"{tag} warm-up rollout not finite")

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    final = rollout_batched(spec, states, cfg, H_SLICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    finite = all(bool(torch.isfinite(x).all()) for x in final)
    shapes = [tuple(x.shape) for x in final]
    print(f"[{tag}] B={B_SLICE} H={H_SLICE}: {dt:.4f} s, {B_SLICE / dt:.1f} rollouts/s, "
          f"{B_SLICE * H_SLICE / dt:.1f} steps/s; launches {launches}; finite {finite}; "
          f"shapes {shapes}")
    check(finite, f"{tag} output not finite")
    check(shapes == [(B_SLICE, 4, 3), (B_SLICE, 4, 3), (B_SLICE, 4, 4), (B_SLICE, 4, 3)],
          f"{tag} output shapes {shapes}")
    want = {name: H_SLICE if name in path else 0 for name in counters}
    check(launches == want, f"{tag} kernel launches {launches}, expected {want}")
    # the stack stays standing: top box within 1 cm of its start height
    top = final.p[:, 3, 2] - states.p[:, 3, 2]
    check(bool(top.abs().max() < 1e-2), f"{tag}: top box moved {float(top.abs().max())} m")
    return launches, B_SLICE / dt


FUSED_PATH = ("narrowphase", "prep", "jassembly", "amat", "jacobi_packed", "integrate")
UNFUSED_PATH = ("narrowphase", "jacobi")


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
    res = {"narrowphase": phase_narrowphase(dev, nargs), "jacobi": phase_jacobi(dev, lcp)}
    first, rand = fused_inputs(dev), random_fused_inputs(dev)
    for name in FUSED_KERNELS:
        res[name] = phase_fused_kernel(name, [("seeded random inputs", rand[name]),
                                              ("first-step inputs of [slice_fused]", first[name])])

    phase_oracle(dev, bench_cfg(), "oracle_fused")
    fused_launches, _ = phase_slice(dev, bench_cfg(), "slice_fused", FUSED_PATH)
    phase_oracle(dev, slice_cfg(), "oracle")
    unfused_launches, _ = phase_slice(dev, slice_cfg(), "slice", UNFUSED_PATH)

    rows = [("narrowphase", "eggshell_tpu_torch/csrc/narrowphase.cu",
             "eggshell_tpu/ops/collision_kernel.py:58", "fused", fused_launches["narrowphase"]),
            ("jacobi", "eggshell_tpu_torch/csrc/jacobi.cu", "eggshell_tpu/ops/pgs_kernel.py:47",
             "unfused", unfused_launches["jacobi"])]
    rows += [(name, FUSED_KERNELS[name][3], FUSED_KERNELS[name][4], "fused",
              fused_launches[name]) for name in FUSED_KERNELS]
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces, "path": path,
         "launches": launches, "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"], "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "library_ms": None}
        for name, source, replaces, path, launches in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
