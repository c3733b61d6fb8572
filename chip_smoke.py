#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`eggshell_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `eggshell_tpu_torch/csrc/`, prints the
registers, stack and spills ptxas reported for the Jacobi kernels (B6,
B6b's cluster, streamed and global-rows forms, and B6c's and B6c''s
resident, cluster, streamed and global-rows forms), the
narrowphase's two entries B2 and B2p, B4, B5, B7, B3 and B3g (`[ptxas]`;
none may spill), and holds each kernel against its
plain PyTorch version on the card, on seeded random inputs and on the
inputs of its path's first step, with the bound printed beside the error,
the device times of kernel and plain version, and the kernel's bound and
its ratio to it.  `[narrowphase]` and `[narrowphase_packed]` also run
seven degenerate poses (aligned stacks, touching, coincident, separated,
deep penetration, a turned stack, generic) at B = 4099, where B2's
contact codes must agree with the plain version's on every pair, its
flags on every lane off the reference face and, on each pose, as the card
measured them, and `[narrowphase_packed]` is timed on box_stack8's first
step too.  `[jacobi]` and `[jacobi_block]` also run the joints
slice's first LCP (m = 30, rows copied by element loads) and print the
route and copy each case took.  `[jacobi_packed]` also holds the resident
B6 on box_stack8's and living_room's first-step solves (mp = 96, the
register row of 96 that those paths launch).  `[jacobi_packed_stream]`
also requires the cluster solve B6b to return the resident B6's bits at
mp = 192, past the crossing where the fused solve takes B6b, and times
both there.  `[prep]` times B1 on the first steps of the bench,
box_stack8, living_room and box_drop, of the bench with control
wrenches `ext_forces` (B, n, 6), and of the MPC update's first step (its
4096 samples of living_room with their first controls, (S, 7, 6)).
Then it drives the ported paths through `rollout_batched` at B=4096, H=50,
where the configuration is `parallel.rollout.graph_capturable` (every
fused path) as a captured CUDA graph, timed in turns with the eager loop
(`graph=False`) in the same phase, both giving the same bits; the
unfused paths stay the loop:

- the fused chain under the bench configuration (bench.py:80-94,
  `conditional_cfm=False`) on `box_stack(4)` with the bench's jitter: packed
  narrowphase, compaction, prep, Jacobian blocks, A, packed Jacobi and
  integrate kernels (phases `[oracle_fused]`, `[slice_fused]`);
- the unfused conditional-CFM branch: narrowphase and Jacobi kernels
  (phases `[oracle]`, `[slice]`);
- the four BASELINE scenes of bench.py:148-176 on the fused chain, with
  their contact capacities and jitters (phases `[scene_box_drop]`,
  `[scene_pendulum_chain6]`, `[scene_box_stack8]`, `[scene_living_room]`):
  the ground-only compaction where a scene has no pairs, the resident B6
  at every scene's row count (mp 32 to 96); box_stack8 at
  contact_capacity 64 (mp = 192, `[scene_box_stack8_k64]`) takes the
  cluster B6b, and at contact_capacity 296 (mp = 888,
  `[scene_box_stack8_k296]`, B = B_WIDE) B6b on a cluster of 9 to 16
  blocks, its first-step solve held to the plain version and to the
  global-rows form's bits;
- the fused chain with Coulomb-pyramid friction and with block-Jacobi on
  `box_stack(4)` (phases `[slice_pyramid]`, `[slice_block]`; the B6 forms
  are held alone in `[jacobi_packed_pyramid]`, `[jacobi_packed_block]`),
  and `pendulum_chain(6)`'s ball joints on the unfused branch
  (`[slice_joints_unfused]`, m = 30).

Then `[mpc_living_room]`, bench.py:181-218's MPC cell: one MPPI update
(`mpc.sampling.mppi_update_batched`) on living_room at S = 4096 samples,
H = 20, float32, controlled body 4, sigma 5, temperature 1, "constant"
noise, cost sum((p[4] - (0, 0, 0.5))^2), zero mean.  The captured update
(the rollout replays a control period captured with its control input)
and the eager one (`graph=False`) are timed in turns, three each, and
must give the same bits in the costs and the new mean; each must launch
each fused kernel H times and nothing else.  It prints MPC solves/s,
rollouts/s, steps/s and their ratio, holds 8 of the sampled sequences
against the plain path on the CPU in float64 (p, q within 2e-3, costs
within 2e-3 relative), recomputes the new mean in float64 within 1e-5,
and prints the device ms of a controlled replay of living_room against
the uncontrolled one.

Then the large-scene tier of bench.py:286-318, through `rollout_batched`
under SolverKind.MATRIX_FREE (60 sweeps, the "mask" broadphase, margin
0.05, max_correcting_vel 2): `[pile216]` (box_pile(216), B = 8, K = 4096,
pair capacity 2048) and `[pile512]` (box_pile(512), B = 4, K = 8192, pair
capacity 4096), H = 50, f32, captured and eager in turns with the same
bits; each prints steps/s and body-steps/s, the capture seconds, B2's
launches (one a step, and nothing else), `count_dropped_contacts` on the
first and last state, a replayed step's device operations and device ms,
no box corner more than 0.03 m below the floor, and 1 scenario over 10
steps against the CPU f64 plain path (p, q within 2e-3); `[pile512]` also
times the broadphase in both kinds ("mask", "sap" with window 64) and the
last state's matrix-free solve in each matvec form ("segment",
`index_add_`; "onehot", matmuls, TF32 off; "sorted", the deterministic
per-body sum "auto" takes on the card).  B2 is held against its plain
version and timed at the piles' shape before any graph is replayed.
`[scene_living_room_bp]` rolls living_room on the fused chain with the
broadphase (margin 0.1) at the smallest pair capacity at which no contact
is dropped over the run (found from the all-pairs rollout, one less must
drop), captured and eager, and must give the all-pairs `[scene_living_room]`
rollout's bits; B2p and B3 on its per-scenario pair lists and gate are
held against their plain versions and timed first (`[narrowphase_packed]`,
`[compact]`).

The block-Jacobi solve B6c' has no stepping path: `[jacobi_block]` calls
its entry `solve_lcp_jacobi(block=True)` on the unfused slice's first LCP.
`[jacobi_cluster]` and `[jacobi_block_cluster]` hold B6c and B6c' in their
cluster form (the unfused slice's first LCP at contact_capacity 80,
m = 240, a seeded m = 480 system, and past the portable 8 blocks, a
cluster of 9 to 16, a seeded m = 672 system and the unfused slice's first
LCP at contact_capacity 224, m = 672, B = B_WIDE), `[jacobi_streamed]`
and `[jacobi_block_streamed]` in their streamed form past what 16 blocks
hold (m = 1,200), and `[jacobi_global]` and `[jacobi_block_global]` in
their global-rows form past the streamed form's reach (m = 6,627, B = 1;
also forced at m = 672, the route the parent took there), each bit for
bit the global-rows form's; `[jacobi_packed_rows]` does the same for B6b
(a cluster of 9 to 16 at mp = 672 and 888, streamed at 1,200, global
rows at 6,648 and forced at 888), each timed against its one-read bound
and the floor of 16 reads of A.  B4, B5
and B7 (`[jassembly]`, `[amat]`, `[integrate]`) and B3 (`[compact]`) are
also timed at K = 32 on box_stack8's first step, `[amat]` also checks B5's
slab route (K = 64) and Jc-chunk route (K = 400) on seeded inputs, and
every fused-chain kernel phase and `[compact]` say whether the kernel
returned its plain version's bits.
The 2D FDTD step B8 is held against its plain version at n = 512 and
2048 (`[fdtd2d]`), and `fem.fdtd.simulate_2d` runs 200 steps at n = 2048
(`[fdtd2d_rollout]`), with the example's aperture at n = 160 against the
plain path on the CPU and a cavity's energy over 2000 steps.

The rest of the single-scene stepper and the FEM tier: `[stabilize]`
(`init_stabilize` and `post_stabilize` of pendulum_chain6 with a joint
pulled 0.05 m apart and `init_stabilize` of a box sunk 1 mm into the floor,
float64 on the card against the CPU float64 plain path: the same iteration
counts, err^2 at most 1e-9, the states within 1e-8; then the hanging
chain with its 15 link pairs in float32, B2 launched once a contact
detection), `[implicit_midpoint]` (box_stack(4) at K = 20 and
pendulum_chain6, 120 steps under JACOBI and 30 under DIRECT, float32,
within 2e-3 of the CPU float64 plain path after 30 steps, the stack
standing or the joints holding, B2 once a step; one PGS step as a launch
check), `[explicit_euler]` (pendulum_chain6, 100 steps, the joints
holding), `[step_diagnostics]` (a sunk, moving box_stack(4) under PGS and
DIRECT, every key against the CPU float64 plain path), `[fem_driven]`
(bench_fem.py's WR-12 guide at h = 0.4, 0.15 and 0.12, up to 56,295 nodes:
the BCR on the card in complex64 and complex128 against the host SuperLU,
|S21| within 1e-3 and the field within 1e-8, solves/s cold and warm),
`[fem_sweep]` (16 frequencies as one batched BCR, each S21 within 1e-6 of
its single solve; `fields.solve_sweep` on the host SuperLU) and
`[fem_modes]` (6 modes of a 16,035-node cavity, shift-invert on the card
within 1e-2 of the host ARPACK; LOBPCG printed).

The last slice: `[c3_float64]` (`init_stabilize` of box_stack(3) in
float64 on the card, as built and sunk 1 mm, its box pairs through the
plain narrowphase with B2 unlaunched, within 1e-10 of the CPU float64
plain path; contact_kernel=True in float64 raising; float32 launching B2
once a contact detection, a launch count only), `[utils_tail]` (`utils.trace.scope` around a
fused bench step, its label in a torch.profiler window; a checkpoint round
trip of a card State, the same bits back on the card), `[examples_physics]`
(fdtd_aperture, chain_swing, box_drop, push_mpc and living_room_mpc of
`eggshell_tpu_torch.examples` through their entries with render=False at
their scripts' widths, float32, each cut in depth where its default does
not fit (`EX_*`; push_mpc one MPPI update at its horizon 40), printing
the cut, its seconds a step and its launches, checking the outcome
asserts of tests/test_examples_physics.py that its depth allows, and
holding B2 to its plain version on living_room_mpc's settled room, one
scene and S = 256), `[examples_rama]` (the 11 FEM models at their
scripts' mesh sizes with their outcome checks and seconds) and `[viewer]`
(`viz.InteractiveViewer.step_once` on box_stack(3) in float32, B2 once a
step and held to its plain version on every frame's state, the state
within 1e-5 of the CPU float64 viewer's).

Each path's oracle gate holds the unjittered stack to the DIRECT/f64
trajectory in tests/data/oracle_stack4_f64.npz (bound 1e-3 at every stored
checkpoint).  Each rollout phase sets every launch counter to 0 just before
each timed run (captured and eager) and checks just after it that each
kernel of its path launched once per step and no other kernel launched (a
replay counts the launches its capture made), prints both rollouts/s,
their ratio and the seconds of the first, capturing call, and checks one
physical property with a stated bound.  Each scene phase also holds 8 of its
scenarios, 30 steps on the card in float32, against the port's plain path
on the CPU in float64.  Any failed phase exits nonzero.  The last three
lines of standard output are the card's name and power limit, one JSON line
of per-kernel results, and one JSON line with "ok".

It needs a CUDA device and imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
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


def pyramid_cfg():
    """The fused chain with Coulomb-pyramid friction (friction_mu 0.5)."""
    from eggshell_tpu_torch.utils.config import FrictionModel

    return bench_cfg().replace(friction_model=FrictionModel.COULOMB_PYRAMID)


def block_cfg():
    """The fused chain with 3x3 block-Jacobi sweeps (omega 0.3, beta 0.45:
    on the CPU's plain path they hold box_stack(4), as the scalar sweeps do)."""
    return bench_cfg().replace(jacobi_block=True)


def joints_unfused_cfg():
    """pendulum_chain6's capacity on the unfused conditional-CFM branch."""
    return slice_cfg().replace(contact_capacity=4)


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
            print(f"[{kernel_name}] the {what} window was whole (device activity, each call "
                  f"after its flush) only on attempt {w['attempts']}")
    return {"ms": sum(ms for ms, _ in mine), "plain_ms": p["device_ms"]}


def timing_text(t: dict) -> str:
    return (f"kernel {t['ms']:.4f} ms, plain torch {t['plain_ms']:.4f} ms of device time "
            f"a call, L2 flushed before each")


def ratio_text(t: dict, b: dict) -> str:
    return f"{t['ms'] / b['bound_ms']:.2f}x the bound"


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


def compare_contacts(what: str, got, want, generic=None, tag="narrowphase") -> float:
    """Hold the kernel's contacts against the plain version's: code
    agreement, active-lane agreement where codes agree, and the max |d|
    of positions and depths on lanes active in both (bound 1e-4)."""
    same = got.code == want.code
    agree = float(same.float().mean())
    both = got.active & want.active & same[:, None]
    act_agree = float((got.active == want.active)[same].float().mean())
    none = not bool(both.any())          # e.g. a pile's first step: no box touches another
    err_pos = 0.0 if none else float((got.position - want.position).abs().amax(-1)[both].max())
    err_dep = 0.0 if none else float((got.depth - want.depth).abs()[both].max())
    err = max(err_pos, err_dep)
    line = f"[{tag}] {what}: code agreement {agree:.6f}"
    if generic is not None:
        agree_generic = float(same[generic].float().mean())
        line += f" (generic poses {agree_generic:.6f})"
        check(agree_generic >= 0.999,
              f"narrowphase code agreement on generic poses {agree_generic}")
    print(f"{line}, active-lane agreement where codes agree {act_agree:.6f}, "
          f"max |dpos| {err_pos:.3e}, max |ddepth| {err_dep:.3e} on lanes active in both "
          f"(bound 1e-4){'; no lane is active in both' if none else ''}")
    check(agree >= 0.99, f"{tag} {what}: narrowphase code agreement {agree}")
    check(act_agree >= 0.99, f"{tag} {what}: narrowphase active-lane agreement {act_agree}")
    check(err <= 1e-4, f"{tag} {what}: narrowphase max abs error {err}")
    check(bool(torch.isfinite(got.position).all() & torch.isfinite(got.depth).all()),
          f"{tag} {what}: narrowphase output not finite")
    return err


def b2_on_states(tag: str, what: str, spec, p, q) -> float:
    """B2 (`collide_boxes_lanes`) against the plain `collide_boxes` on the
    box pairs of `spec` at positions p (B, n, 3) and orientations q
    (B, n, 4) on the card, gathered as the unfused contacts gather them
    (`gather_pairs`), with `compare_contacts`' bounds.  Returns the max
    abs error."""
    from eggshell_tpu_torch.ops.collision import collide_boxes
    from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes, gather_pairs
    from eggshell_tpu_torch.ops.quaternion import quat_to_mat

    args = gather_pairs(p, quat_to_mat(q), spec.half_extents, spec.pair_i, spec.pair_j)
    return compare_contacts(f"B2 against the plain narrowphase, {what}, N={args[0].shape[0]}",
                            collide_boxes_lanes(*args), collide_boxes(*args), tag=tag)


def phase_narrowphase(dev, main_args):
    """B2 against its plain version on 65,536 seeded pairs, on the
    degenerate poses of `ops.collision_poses` (N = 4099; every code from 0
    to 16 but the edge-edge codes must occur, the codes must agree on every
    pair, the flags on every lane off the reference face and on each pose
    as the card measured them) and on the main path's inputs; timed on the
    main path's inputs."""
    from eggshell_tpu_torch.ops.collision import collide_boxes
    from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes, gather_pairs
    from eggshell_tpu_torch.ops.collision_poses import (DEGENERATE_FLAG_AGREEMENT,
                                                        class_agreement, degenerate_args)
    from eggshell_tpu_torch.ops.quaternion import quat_to_mat

    rng = np.random.default_rng(SEED)
    arrays, kind = narrowphase_pairs(65536, rng)
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous() for a in arrays]
    err = compare_contacts("65536 pairs", collide_boxes_lanes(*args), collide_boxes(*args),
                           generic=torch.as_tensor(kind < 4, device=dev))
    (p, q, hs, pi, pj), pose = degenerate_args(dev, seed=SEED + 3)
    dargs = gather_pairs(p, quat_to_mat(q), hs, pi, pj)
    dout = collide_boxes_lanes(*dargs)
    dwant = collide_boxes(*dargs)
    err = max(err, compare_contacts(f"degenerate poses N={p.shape[0]}", dout, dwant))
    codes = torch.bincount(dout.code.long(), minlength=17).tolist()
    print(f"[narrowphase] degenerate poses: pairs a contact code 0-16 {codes}")
    check(codes[0] > 0 and codes[16] > 0 and sum(codes[1:7]) > 0,
          f"degenerate poses miss codes 0, 16 or a face code: {codes}")
    agreement = class_agreement(dout, dwant, pose)
    for name, (code_agree, flag_agree, off_face) in agreement.items():
        print(f"[narrowphase] degenerate poses, {name}: code agreement {code_agree:.6f} "
              f"(bound 1), active-lane agreement where codes agree {flag_agree:.6f} "
              f"(bound {DEGENERATE_FLAG_AGREEMENT[name]:.6f}), on lanes off the reference "
              f"face {off_face:.6f} (bound 1)")
    for name, (code_agree, flag_agree, off_face) in agreement.items():
        check(code_agree == 1.0, f"narrowphase code agreement {code_agree} on {name}")
        check(flag_agree >= DEGENERATE_FLAG_AGREEMENT[name],
              f"narrowphase flag agreement {flag_agree} on {name}")
        check(off_face == 1.0, f"narrowphase flag agreement off the face {off_face} on {name}")
    out = collide_boxes_lanes(*main_args)
    want = collide_boxes(*main_args)
    err = max(err, compare_contacts(f"main-path inputs N={main_args[0].shape[0]}", out, want))
    same = torch.equal(out.code, want.code)
    print(f"[narrowphase] main-path inputs: code agreement on every pair: {same}")
    check(same, "narrowphase codes differ from the plain version's on the main path")

    t = timings("narrowphase_kernel", lambda: collide_boxes_lanes(*main_args),
                lambda: collide_boxes(*main_args))
    # SAT over 15 axes, face clipping and contact reduction: about 2,000
    # flops a pair, counted from csrc/narrowphase.cu; bytes dominate anyway.
    b = bound(moved_bytes(main_args, out), 2000.0 * main_args[0].shape[0])
    print(f"[narrowphase] main-path shape N={main_args[0].shape[0]}: {timing_text(t)}, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": err, **t, **b}


def random_spd_lcp(dev, B=4096, m=60):
    """A seeded SPD system (4096, 60, 60) with contact-like rows: tangents
    in [-1, 1], normals in [0, inf), every tenth row an equality."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    G = torch.randn(B, m, 24, generator=g, dtype=torch.float64)
    A = (G @ G.transpose(-1, -2) / 24 + torch.eye(m, dtype=torch.float64)).float().to(dev)
    b = torch.randn(B, m, generator=g).float().to(dev)
    row = torch.arange(m)
    is_eq = (row % 10 == 9).expand(B, m).contiguous().to(dev)
    normal = (row % 3 == 2).expand(B, m)
    lo = torch.where(normal, 0.0, -1.0).float().contiguous().to(dev)
    hi = torch.where(normal, float("inf"), 1.0).float().contiguous().to(dev)
    return A, b, is_eq, lo, hi


def plan_text(m: int, block: bool) -> str:
    """The route and the copy `jacobi_launch_plan` names for B6c or B6c'."""
    from eggshell_tpu_torch.ops.pgs_kernel import jacobi_launch_plan

    p = jacobi_launch_plan(m, block)
    if p.route == "global rows":
        return f"global rows ({p.threads} threads, {p.shared_bytes} bytes of shared memory)"
    blocks = f", cluster of {p.cluster}, {p.rows} rows a block" if p.route == "cluster" else ""
    return f"{p.route}, {p.copy}, {min(p.reg_rows, p.mp)} of {p.mp} columns in registers{blocks}"


def phase_jacobi(dev, main_lcp, joints_lcp):
    """B6c against its plain version (relative bound 1e-4 of max |x|) on the
    seeded SPD system, the unfused slice's first LCP (m = 60, one tensor
    copy) and the joints slice's (m = 30, rows copied by element loads),
    each with the route and the copy it took; timed on the slice's."""
    from eggshell_tpu_torch.ops.pgs_kernel import solve_lcp_jacobi, solve_lcp_jacobi_plain

    iters, omega, beta = 16, 0.3, 0.45
    A, b, is_eq, lo, hi = random_spd_lcp(dev)

    def compare(what, args):
        got = solve_lcp_jacobi(*args, iters, omega, beta)
        want = solve_lcp_jacobi_plain(*args, iters, omega, beta)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        print(f"[jacobi] {what}, iters 16, {plan_text(args[1].shape[1], False)}: max |dx| "
              f"{err:.3e}, relative {rel:.3e} (bound 1e-4)")
        check(bool(torch.isfinite(got).all()), "jacobi output not finite")
        check(rel <= 1e-4, f"jacobi relative error {rel}")
        return err

    err = max(compare("SPD (4096, 60, 60)", (A, b, is_eq, lo, hi)),
              compare(f"main-path inputs {tuple(main_lcp[0].shape)}", main_lcp),
              compare(f"first-step inputs of [slice_joints_unfused] {tuple(joints_lcp[0].shape)}",
                      joints_lcp))

    res = {"max_abs_err": err}
    for what, args in (("joints slice", joints_lcp), ("main-path", main_lcp)):
        t = timings("jacobi_kernel", lambda: solve_lcp_jacobi(*args, iters, omega, beta),
                    lambda: solve_lcp_jacobi_plain(*args, iters, omega, beta))
        Bm, mm = args[1].shape
        out = solve_lcp_jacobi(*args, iters, omega, beta)
        b = bound(moved_bytes(args, out), Bm * iters * (2.0 * mm * mm + 10.0 * mm))
        print(f"[jacobi] {what} shape {tuple(args[0].shape)}: {timing_text(t)}, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} bytes), "
              f"{ratio_text(t, b)}")
        res.update({**t, **b} if what == "main-path" else
                   {"ms_extra": t["ms"], "plain_ms_extra": t["plain_ms"],
                    "bound_ms_extra": b["bound_ms"]})
    return res


def unfused_first_lcp(dev, scene="box_stack4", cfg=None, batch=B_SLICE):
    """B6c's inputs at the first step of `batch` scenarios of `scene` on the
    unfused branch (the slice's configuration, or `cfg`)."""
    from eggshell_tpu_torch.physics import scenes, stepper

    spec, states, _ = scenes.baseline_batch(scene, batch, device=dev)
    _, sys_, A, rhs, _, _, _ = stepper._pre_solve(spec, states, slice_cfg() if cfg is None else cfg)
    return tuple(x.contiguous() for x in (A, rhs, sys_.is_eq, sys_.lo, sys_.hi))


def main_path_inputs(dev):
    """The slice-1 kernels' inputs at the first step of the unfused slice."""
    from eggshell_tpu_torch.ops.collision_kernel import gather_pairs
    from eggshell_tpu_torch.physics import scenes

    spec, states, _ = scenes.baseline_batch("box_stack4", B_SLICE, device=dev)
    nargs = gather_pairs(states.p, states.R(), spec.half_extents, spec.pair_i, spec.pair_j)
    return nargs, unfused_first_lcp(dev)


def fused_inputs(dev, name="box_stack4", cfg=None, batch=B_SLICE):
    """Each fused-chain kernel's arguments at the first step of `batch`
    scenarios of the BASELINE scene `name` (bench configuration, the
    scene's capacity and jitter, or `cfg`), recorded from one call of the
    stepper's `_fused_step`, keyed by phase name."""
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.stepper import _fused_step

    args = {}

    def record(phase, fn, a):
        args[phase] = a
        return fn(*a)

    spec, st, scene_cfg = scenes.baseline_batch(name, batch, device=dev)
    _fused_step(spec, st, scene_cfg if cfg is None else cfg, call=record)
    torch.cuda.synchronize()
    return args


# bench.py:181-218's mpc_living_room: living_room, the bench solver at
# contact_capacity 32, S samples, horizon H, controlled body 4, sigma 5,
# temperature 1, "constant" noise, target (0, 0, 0.5), zero mean
MPC_S, MPC_H, MPC_BODY, MPC_SIGMA, MPC_T = 4096, 20, 4, 5.0, 1.0
MPC_TARGET = (0.0, 0.0, 0.5)


def mpc_problem(dev, dtype=torch.float32):
    """(spec, state, cfg, cost) of the MPC cell: one living_room scene, the
    bench configuration at contact_capacity 32, and the cost
    sum((p[4] - target)^2) of one scene's final state."""
    from eggshell_tpu_torch.physics import scenes

    spec, st = scenes.living_room(device=dev, dtype=dtype)
    target = torch.tensor(MPC_TARGET, dtype=dtype, device=dev)

    def cost(final):
        return torch.sum((final.p[MPC_BODY] - target) ** 2)

    return spec, st, bench_cfg().replace(contact_capacity=32), cost


def mpc_controls(dev, horizon=None):
    """The MPC update's sampled controls (S, horizon or H, 6) from a
    generator seeded with SEED on the card, as `mppi_update_batched` draws
    them."""
    from eggshell_tpu_torch.mpc.sampling import _sample

    gen = torch.Generator(device=dev).manual_seed(SEED)
    mean = torch.zeros((MPC_H if horizon is None else horizon, 6), device=dev)
    return _sample(mean, gen, MPC_S, MPC_SIGMA, "constant")


def mpc_first_prep(dev):
    """B1's arguments at the MPC update's first step: the S samples of the
    start state with their first control wrenches, ext_forces (S, 7, 6)."""
    from eggshell_tpu_torch.physics.scene import State
    from eggshell_tpu_torch.physics.stepper import _fused_step

    spec, st, cfg, _ = mpc_problem(dev)
    states = State(*(x.expand((MPC_S,) + x.shape).contiguous() for x in st))
    ext = torch.zeros((MPC_S, spec.num_bodies, 6), device=dev)
    ext[:, MPC_BODY] = mpc_controls(dev)[:, 0]
    args = {}

    def record(phase, fn, a):
        args[phase] = a
        return fn(*a)

    _fused_step(spec, states, cfg, ext, call=record)
    torch.cuda.synchronize()
    return args["prep"]


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
        # a block sweep adds three products and sums a row (y from rv)
        B, m, iters = args[2].shape[0], args[2].shape[1], args[7]
        block = len(args) > 10 and args[10]
        return B * iters * (2.0 * m * m + (16.0 if block else 10.0) * m)
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


def phase_fused_kernel(name, cases, extras=()):
    """Hold one fused-chain kernel against its plain version on each case,
    and say whether it returned the plain version's bits (`torch.equal`,
    which takes -0 for 0); the error is max |kernel - plain| over every
    output, and the bound is relative to the output's scale,
    max(1, max |plain|).  Timed on the last case, the main path's; each of
    `extras`, (what, args), is checked and timed too: the first under the
    keys ms_extra, plain_ms_extra and bound_ms_extra, all of them under
    `shapes` (what: ms, plain_ms, bound_ms)."""
    kernel, plain = fused_wrapper(name)
    rel_bound = FUSED_KERNELS[name][2]
    err_abs = 0.0
    for what, args in list(cases) + list(extras):
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
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"[{name}] {what}: max |d| {case_abs:.3e}, relative to scale {worst:.3e} "
              f"(bound {rel_bound:.0e}); bit for bit the plain version's: {same}")
        check(worst <= rel_bound, f"{name} relative error {worst} on {what}")

    def timed(what, args):
        t = timings(name + "_kernel", lambda: kernel(*args), lambda: plain(*args))
        b = bound(moved_bytes(args, kernel(*args)), _fused_flops(name, args))
        print(f"[{name}] {what}: {timing_text(t)}, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: {b['bytes']} bytes, {b['flops']:.4g} flops), {ratio_text(t, b)}")
        return t, b

    t, b = timed("main-path shapes", cases[-1][1])
    out = {"max_abs_err": err_abs, **t, **b}
    shapes = {}
    for what, args in extras:
        te, be = timed(what, args)
        shapes[what] = {"ms": te["ms"], "plain_ms": te["plain_ms"], "bound_ms": be["bound_ms"]}
    if extras:
        first = shapes[extras[0][0]]
        out.update(ms_extra=first["ms"], plain_ms_extra=first["plain_ms"],
                   bound_ms_extra=first["bound_ms"], shapes=shapes)
    return out


def packed_pair_agreement(what, got, want):
    """Hold the packed narrowphase's lanes against the plain version's.
    The contact normal must agree within 1e-4 on at least 99 % of the
    pairs, and the activity flags on at least 99 % of those pairs' lanes:
    exactly tied SAT axes and clip vertices on a clip plane are decided by
    rounding, as in `[narrowphase]` (there is no contact code to compare
    here).  On pairs whose normal and 12 flags all agree, positions and
    depths of the active lanes within 1e-4."""
    pos, nrm, dep, act = got
    wpos, wnrm, wdep, wact = want
    normal_ok = (nrm - wnrm).abs().amax(-1) <= 1e-4
    frac_n = float(normal_ok.float().mean())
    frac_l = float((act == wact)[normal_ok].float().mean())
    full = normal_ok & (act == wact).all(-1)
    lanes = act & full[..., None]
    err_pos = float((pos - wpos).abs().amax(-1)[lanes].max()) if bool(lanes.any()) else 0.0
    err_dep = float((dep - wdep).abs()[lanes].max()) if bool(lanes.any()) else 0.0
    err = max(err_pos, err_dep)
    print(f"[narrowphase_packed] {what}: normal agreement {frac_n:.6f}, flag agreement "
          f"{frac_l:.6f}, all 12 flags and the normal on {float(full.float().mean()):.6f} of "
          f"the pairs, {int(act.sum())} active lanes; there max |dpos| {err_pos:.3e}, "
          f"|ddepth| {err_dep:.3e} (bound 1e-4)")
    check(frac_n >= 0.99, f"narrowphase_packed normal agreement {frac_n} on {what}")
    check(frac_l >= 0.99, f"narrowphase_packed flag agreement {frac_l} on {what}")
    check(err <= 1e-4, f"narrowphase_packed max abs error {err} on {what}")
    check(all(bool(torch.isfinite(x).all()) for x in (pos, nrm, dep)),
          f"narrowphase_packed output not finite on {what}")
    return err


def phase_narrowphase_packed(dev, firsts):
    """B2p: seeded random bodies (8 boxes in [-1, 1]^3, half extents 0.05
    to 0.6, all 28 pairs, B=4096), the degenerate poses of
    `ops.collision_poses` and the first-step inputs of each path with
    pairs; on each, the kernel against its plain version, and against the
    lanes entry (B2) on the same gathered pairs, which runs the same device
    function and must agree bit for bit.  Timed on the main path's inputs
    and on box_stack8's first step."""
    from eggshell_tpu_torch.ops.collision_kernel import (collide_boxes_lanes,
                                                        collide_boxes_lanes_packed,
                                                        collide_boxes_lanes_packed_plain,
                                                        gather_pairs)
    from eggshell_tpu_torch.ops.collision_poses import degenerate_args, pair_list, random_bodies
    from eggshell_tpu_torch.ops.quaternion import quat_to_mat

    rng = np.random.default_rng(SEED + 2)
    p, q, _ = random_bodies(rng, 4096, 8, xy=(-1.0, 1.0), z=(-1.0, 1.0))
    hs = rng.uniform(0.05, 0.6, (8, 3))
    pi, pj = pair_list(8)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    i = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev).contiguous()
    cases = [("seeded random, B=4096, 8 boxes, 28 pairs", (f(p), f(q), f(hs), i(pi), i(pj))),
             ("degenerate poses, B=4099, 1 pair", degenerate_args(dev, seed=SEED + 3)[0])]
    cases += [(f"first-step inputs of {tag}", a) for tag, a in firsts]
    err = 0.0
    for what, args in cases:
        got = collide_boxes_lanes_packed(*args)
        err = max(err, packed_pair_agreement(what, got, collide_boxes_lanes_packed_plain(*args)))
        pp, qq, hh, ii, jj = args
        B, P = pp.shape[0], ii.shape[0]
        lanes = collide_boxes_lanes(*gather_pairs(pp, quat_to_mat(qq), hh, ii, jj))
        same = (torch.equal(got[0], lanes.position.reshape(B, P, 12, 3))
                and torch.equal(got[1], lanes.normal[:, 0].reshape(B, P, 3))
                and torch.equal(got[2], lanes.depth.reshape(B, P, 12))
                and torch.equal(got[3], lanes.active.reshape(B, P, 12)))
        print(f"[narrowphase_packed] {what}: bit for bit the lanes entry's on the gathered "
              f"pairs: {same}")
        check(same, f"narrowphase_packed differs from the lanes entry on {what}")

    def timed(what, args):
        t = timings("narrowphase_packed_kernel", lambda: collide_boxes_lanes_packed(*args),
                    lambda: collide_boxes_lanes_packed_plain(*args))
        pairs = args[0].shape[0] * args[3].shape[0]
        # the SAT of csrc/narrowphase.cu, about 2,000 flops a pair, and R from q
        b = bound(moved_bytes(args, collide_boxes_lanes_packed(*args)), 2060.0 * pairs)
        print(f"[narrowphase_packed] {what} ({pairs} pairs): {timing_text(t)}, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} bytes), {ratio_text(t, b)}")
        return t, b

    # the main path's, then box_stack8's first step
    t, b = timed("main-path shapes", cases[2][1])
    te, be = timed("first-step shapes of [scene_box_stack8]", cases[3][1])
    return {"max_abs_err": err, **t, **b, "ms_extra": te["ms"], "plain_ms_extra": te["plain_ms"],
            "bound_ms_extra": be["bound_ms"]}


def random_compact_cases(dev, B=4096, n=4):
    """Seeded random inputs of B3 at the bench widths (n=4 bodies, 6 pairs):
    more active candidates than K; clusters of near-coincident lanes of one
    pair with min_constraint_distance raised to 0.05, so the dedupe drops
    lanes; a finite depth cap; and the ground-only variant (K=8).  One body
    has ground contacts disabled."""
    from eggshell_tpu_torch.ops.collision_poses import pair_list, random_bodies

    rng = np.random.default_rng(SEED + 3)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    i = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev).contiguous()
    p, q, hs = random_bodies(rng, B, n, z=(0.0, 0.3))
    gen = torch.tensor([True, True, False, True], device=dev)
    pi, pj = pair_list(n)
    P = len(pi)
    nrm = rng.normal(size=(B, P, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    body = (f(p), f(q), f(hs), gen)
    ids = (i(pi), i(pj))

    def lanes(pos, dep, act):
        return (f(pos), f(nrm), f(dep), torch.as_tensor(act, device=dev))

    spread = rng.normal(size=(B, P, 12, 3))
    clustered = rng.normal(size=(B, P, 1, 3)) + 0.01 * spread
    dep = rng.uniform(0.0, 0.01, (B, P, 12))
    return [
        ("seeded random, overflow (K=20)",
         (*body, lanes(spread, dep, rng.uniform(size=(B, P, 12)) < 0.5), *ids, 20, 1e-12, None)),
        ("seeded random, dedupe (K=32, min distance 0.05)",
         (*body, lanes(clustered, dep, rng.uniform(size=(B, P, 12)) < 0.4), *ids, 32, 0.05 ** 2,
          None)),
        ("seeded random, depth cap 0.005 (K=20)",
         (*body, lanes(spread, dep, rng.uniform(size=(B, P, 12)) < 0.3), *ids, 20, 1e-12, 0.005)),
        ("seeded random, ground only (K=8)", (*body, None, *ids, 8, 1e-12, None)),
    ]


def compare_lanes(tag, what, got, want) -> float:
    """B3's ids and active flags must be identical to the plain version's,
    and its positions, normals and depths within 1e-6; prints whether they
    are the plain version's bits."""
    same = all(torch.equal(getattr(got, k), getattr(want, k)) for k in ("b0", "b1", "active"))
    err = max(float((getattr(got, k) - getattr(want, k)).abs().max())
              for k in ("position", "normal", "depth"))
    bits = all(torch.equal(getattr(got, k).view(torch.int32), getattr(want, k).view(torch.int32))
               for k in ("position", "normal", "depth"))
    filled = int((want.b1 != -1).sum())          # b1 is -1 on never-filled lanes only
    print(f"[{tag}] {what}: ids and active identical {same}; {int(want.active.sum())} active "
          f"lanes ({filled} filled); max |d| geometry {err:.3e} (bound 1e-6); bit for bit the "
          f"plain version's: {same and bits}")
    check(same, f"{tag} ids or active flags differ on {what}")
    check(err <= 1e-6, f"{tag} geometry error {err} on {what}")
    return err


def compact_bytes(args, cs) -> int:
    """Bytes B3 must move on these inputs: the bodies' state, every output,
    the activity flag of each pair candidate scanned before K lanes are
    filled, and the 28 bytes of position, normal and depth of each pair
    candidate that lands in a lane."""
    from eggshell_tpu_torch.physics import contacts

    p, q, hs, gen, pair, pi, pj, K = args[:8]
    nb = moved_bytes((p, q, hs, gen), tuple(cs))
    if pair is None:
        return nb
    B, n = p.shape[:2]
    act = torch.cat([contacts.ground_candidates(p, q, hs, gen)[5],
                     pair[3].reshape(B, -1)], 1).to(torch.int32)
    full = torch.cumsum(act, 1) >= K
    scanned = torch.where(full.any(1), full.to(torch.int32).argmax(1) + 1,
                          torch.full_like(full[:, 0], act.shape[1], dtype=torch.int64))
    flags = int((scanned - 8 * n).clamp(min=0).sum())
    # the ids of the landing pair candidates: the scene's list, or each
    # scenario's (the broadphase's) read where its candidates land
    ids = pi.nbytes + pj.nbytes if pi.dim() == 1 else 16 * int((cs.b0 >= 0).sum())
    return nb + flags + int((cs.b0 >= 0).sum()) * 28 + ids


def phase_compact(dev, firsts):
    """B3 and its ground-only variant B3g against their plain version;
    B3 timed on the main path's first step and on box_stack8's, B3g on
    box_drop's."""
    from eggshell_tpu_torch.ops.compact_kernel import compact_contacts, compact_contacts_plain

    res = {}
    cases = random_compact_cases(dev) + [(f"first-step inputs of {tag}", a) for tag, a in firsts]
    errs = {"compact": 0.0, "compact_ground": 0.0}
    for what, args in cases:
        name = "compact" if args[4] is not None else "compact_ground"
        errs[name] = max(errs[name], compare_lanes(name, what, compact_contacts(*args),
                                                   compact_contacts_plain(*args)))
    def timed(name, kname, tag, args):
        t = timings(kname, lambda: compact_contacts(*args), lambda: compact_contacts_plain(*args))
        B, n = args[0].shape[:2]
        K = args[7]
        P = 0 if args[4] is None else args[5].shape[0]
        b = bound(compact_bytes(args, compact_contacts(*args)),
                  B * (40.0 * 8 * n + 5.0 * K * K + 2.0 * 12 * P))
        print(f"[{name}] inputs of {tag}: {timing_text(t)}, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: {b['bytes']} bytes), {ratio_text(t, b)}")
        return t, b

    t, b = timed("compact", "compact_kernel", *firsts[0])
    te, be = timed("compact", "compact_kernel", *firsts[1])
    res["compact"] = {"max_abs_err": errs["compact"], **t, **b, "ms_extra": te["ms"],
                      "plain_ms_extra": te["plain_ms"], "bound_ms_extra": be["bound_ms"]}
    t, b = timed("compact_ground", "compact_ground_kernel", *firsts[-1])
    res["compact_ground"] = {"max_abs_err": errs["compact_ground"], **t, **b}
    return res


def random_lcp(dev, B, K, seed):
    """A seeded SPD system with the A kernel's padding at K lanes: rhs,
    active (80 %) and equality (10 %) lanes."""
    from eggshell_tpu_torch.ops.amat_kernel import padded_rows

    rng = np.random.default_rng(seed)
    mp = padded_rows(K)
    Gm = torch.as_tensor(rng.normal(size=(B, mp, 24)), dtype=torch.float32, device=dev)
    A = (Gm @ Gm.transpose(-1, -2) / 24 + torch.eye(mp, device=dev)).contiguous()
    diag = torch.diagonal(A, dim1=-2, dim2=-1).contiguous()
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    act = torch.as_tensor(rng.uniform(size=(B, K)) < 0.8, device=dev)
    eq = torch.as_tensor(rng.uniform(size=(B, K)) < 0.1, device=dev)
    return (A, diag, f(rng.normal(size=(B, 3 * K))), act, eq, K, 1.0, 16, 0.3, 0.45)


def phase_jacobi_packed_stream(dev, firsts):
    """B6b, taken past the crossing measured on the card (`packed_streams`),
    against its plain version (relative bound 1e-4, as B6) and bit for bit
    against the resident B6 (`stream=False`: both sum each row in the same
    order) on a seeded SPD system at K=64 (mp=192, A 604 MB) and on the
    first-step inputs of the paths that take it; the resident B6 against
    the plain version too.  Then B6b and B6 timed on the first of those."""
    from eggshell_tpu_torch.ops.pgs_kernel import (packed_launch_plan, packed_streams,
                                                   solve_lcp_jacobi_packed,
                                                   solve_lcp_jacobi_packed_plain,
                                                   solve_lcp_jacobi_packed_stream)

    cases = [("seeded random SPD (4096, 192, 192)", random_lcp(dev, 4096, 64, SEED + 6))]
    cases += [(f"first-step inputs of {tag}", a[:10]) for tag, a in firsts]
    err = 0.0
    for what, args in cases:   # the fused step also passes block=False, pyramid_mu=0: dropped
        mp = args[1].shape[1]
        check(packed_streams(mp), f"jacobi_packed_stream: mp = {mp} takes the resident B6")
        got = solve_lcp_jacobi_packed_stream(*args)
        want = solve_lcp_jacobi_packed_plain(*args)
        resident = solve_lcp_jacobi_packed(*args, stream=False)
        scale = max(1.0, float(want.abs().max()))
        e = float((got - want).abs().max())
        rel, rel_res = e / scale, float((resident - want).abs().max()) / scale
        same = torch.equal(got, resident)
        err = max(err, e)
        plan = packed_launch_plan(mp)
        print(f"[jacobi_packed_stream] {what}: max |dx| {e:.3e}, relative to scale {rel:.3e}, "
              f"resident B6 {rel_res:.3e} (bound 1e-4); bit for bit the resident kernel's: "
              f"{same}; cluster of {plan.cluster.cluster}, {plan.cluster.rows} rows a block, "
              f"rows in {'registers' if plan.cluster.reg_rows else 'shared memory'}")
        check(bool(torch.isfinite(got).all()), f"jacobi_packed_stream output not finite on {what}")
        check(rel <= 1e-4, f"jacobi_packed_stream relative error {rel} on {what}")
        check(rel_res <= 1e-4, f"resident jacobi_packed relative error {rel_res} on {what}")
        check(same, f"jacobi_packed_stream differs from the resident kernel on {what}")

    tag, main_args = firsts[0][0], cases[1][1]
    t = timings("jacobi_packed_stream_kernel", lambda: solve_lcp_jacobi_packed_stream(*main_args),
                lambda: solve_lcp_jacobi_packed_plain(*main_args))
    tr = timings("jacobi_packed_kernel", lambda: solve_lcp_jacobi_packed(*main_args, stream=False),
                 lambda: solve_lcp_jacobi_packed_plain(*main_args))
    b = bound(moved_bytes(main_args, solve_lcp_jacobi_packed_stream(*main_args)),
              _fused_flops("jacobi_packed", main_args))
    print(f"[jacobi_packed_stream] inputs of {tag}, A {tuple(main_args[0].shape)}: "
          f"{timing_text(t)}, {ratio_text(t, b)}; resident B6 on the same inputs {tr['ms']:.4f} "
          f"ms, {ratio_text(tr, b)}; bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
          f"{b['bytes']} bytes, {b['flops']:.4g} flops)")
    return {"max_abs_err": err, **t, **b, "resident_ms": tr["ms"]}


def phase_jacobi_packed_form(dev, tag, kernel_name, block, pyramid_mu, first):
    """One B6 form (3x3 block sweeps, or pyramid bounds) against the plain
    version on a seeded SPD system at K=20 (mp=64) and on the first-step
    inputs of its rollout `first` (relative bound 1e-5 of max |x|; only
    A x is summed in another order), then timed on the latter."""
    from eggshell_tpu_torch.ops.pgs_kernel import (solve_lcp_jacobi_packed,
                                                   solve_lcp_jacobi_packed_plain)

    cases = [("seeded random SPD (4096, 64, 64)",
              random_lcp(dev, 4096, 20, SEED + 5) + (block, pyramid_mu)),
             (f"first-step inputs of [{first[0]}]", first[1])]
    err = 0.0
    for what, args in cases:
        check(args[10:12] == (block, pyramid_mu), f"{tag}: inputs of another form {args[10:12]}")
        got = solve_lcp_jacobi_packed(*args)
        want = solve_lcp_jacobi_packed_plain(*args)
        e = float((got - want).abs().max())
        rel = e / float(want.abs().max())
        err = max(err, e)
        print(f"[{tag}] {what}: max |dx| {e:.3e}, relative to max |x| {rel:.3e} (bound 1e-5); "
              f"bit for bit {torch.equal(got, want)}")
        check(bool(torch.isfinite(got).all()), f"{tag} output not finite on {what}")
        check(rel <= 1e-5, f"{tag} relative error {rel} on {what}")
    main_args = cases[1][1]
    t = timings(kernel_name, lambda: solve_lcp_jacobi_packed(*main_args),
                lambda: solve_lcp_jacobi_packed_plain(*main_args))
    b = bound(moved_bytes(main_args, solve_lcp_jacobi_packed(*main_args)),
              _fused_flops("jacobi_packed", main_args))
    print(f"[{tag}] main-path shapes, A {tuple(main_args[0].shape)}: {timing_text(t)}, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} bytes, {b['flops']:.4g} flops), "
          f"{ratio_text(t, b)}")
    return {"max_abs_err": err, **t, **b}


def phase_jacobi_block(dev, main_lcp, joints_lcp):
    """B6c' against its plain version on the seeded SPD system, the unfused
    slice's first LCP and the joints slice's (m = 30, element loads)
    (relative bound 1e-5 of max |x|), then its path: one call of its entry
    `solve_lcp_jacobi(block=True)` with every launch counter at 0 just
    before must launch it once and nothing else."""
    from eggshell_tpu_torch.ops.pgs_kernel import solve_lcp_jacobi, solve_lcp_jacobi_plain

    iters, omega, beta = 16, 0.3, 0.45
    cases = [("SPD (4096, 60, 60)", random_spd_lcp(dev)),
             (f"main-path inputs {tuple(main_lcp[0].shape)}", main_lcp),
             (f"first-step inputs of [slice_joints_unfused] {tuple(joints_lcp[0].shape)}",
              joints_lcp)]
    err = 0.0
    for what, args in cases:
        got = solve_lcp_jacobi(*args, iters, omega, beta, block=True)
        want = solve_lcp_jacobi_plain(*args, iters, omega, block=True)
        e = float((got - want).abs().max())
        rel = e / float(want.abs().max())
        err = max(err, e)
        print(f"[jacobi_block] {what}, iters 16, {plan_text(args[1].shape[1], True)}: max |dx| "
              f"{e:.3e}, relative {rel:.3e} (bound 1e-5); bit for bit {torch.equal(got, want)}")
        check(bool(torch.isfinite(got).all()), "jacobi_block output not finite")
        check(rel <= 1e-5, f"jacobi_block relative error {rel}")

    out, launches = one_call_launches(
        "jacobi_block", "jacobi_block",
        lambda: solve_lcp_jacobi(*main_lcp, iters, omega, beta, block=True))

    res = {"max_abs_err": err, "launches": launches}
    for what, args in (("joints slice", joints_lcp), ("main-path", main_lcp)):
        t = timings("block_jacobi_kernel",
                    lambda: solve_lcp_jacobi(*args, iters, omega, beta, block=True),
                    lambda: solve_lcp_jacobi_plain(*args, iters, omega, block=True))
        Bm, mm = args[1].shape
        b = bound(moved_bytes(args, solve_lcp_jacobi(*args, iters, omega, beta, block=True)),
                  Bm * iters * (2.0 * mm * mm + 16.0 * mm))
        print(f"[jacobi_block] {what} shape {tuple(args[0].shape)}: {timing_text(t)}, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} bytes), "
              f"{ratio_text(t, b)}")
        res.update({**t, **b} if what == "main-path" else
                   {"ms_extra": t["ms"], "plain_ms_extra": t["plain_ms"],
                    "bound_ms_extra": b["bound_ms"]})
    return res


def wide_unfused_lcp(dev):
    """B6c's inputs at the first step of the unfused slice with
    contact_capacity 80: m = 240 rows, past the resident form's 128 rows."""
    return unfused_first_lcp(dev, cfg=slice_cfg().replace(contact_capacity=80))


def one_call_launches(tag, counter_name, fn):
    """Launch counts of one call of `fn` with every counter at 0 just
    before: `counter_name` once and nothing else."""
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    want = {name: int(name == counter_name) for name in counters}
    print(f"[{tag}] one call: launches {launches}")
    check(launches == want, f"{tag} launches {launches}, expected {want}")
    return out, launches[counter_name]


# Past the portable cluster's 664 rows (ROADMAP B item 8): the unfused
# slice at contact_capacity 224 (m = 672) and box_stack8 on the fused chain
# at contact_capacity 296 (mp = 888), at B_WIDE scenarios (A 1.8 and 3.2 GB;
# B_SLICE would add two 7-13 GB systems and their rollouts to a script
# near half its time limit); the kernels timed at B = 64 (B6c, B6c',
# m = 672 and 1,200; B6b mp = 1,200) and 256 (B6b, mp = 888); the
# global-rows forms, the plans' route past 6,560 rows, at B = 1.
B_WIDE = 1024
UNFUSED_WIDE_CAPACITY = 224
WIDE_ROWS_CAPACITY = 296
PAST_STREAMED = 6627
PACKED_PAST_STREAMED = 6648


def floor_ms(args) -> float:
    """iters reads of A over the HBM rate: the floor of a route that reads
    A every sweep (the streamed and global-rows routes)."""
    return 16 * args[0].numel() * 4 / PEAK_BYTES_PER_S * 1e3


def phase_jacobi_cluster(dev):
    """B6c and B6c' past the resident form's 128 rows, each against its
    plain version (relative bounds 1e-4 and 1e-5 of max |x|, as `[jacobi]`
    and `[jacobi_block]`) and bit for bit against the global-rows form forced
    by its plan: the cluster form (`jacobi_launch_plan` splits a scenario's
    rows over a thread-block cluster) at m = 240 (the unfused slice's first
    LCP at contact_capacity 80, B=4096, one tensor copy), m = 480 (seeded,
    B=512, one bulk copy a row), m = 672 (seeded, B=64, and the unfused
    slice's first LCP at contact_capacity 224, B=B_WIDE: past the portable 8
    blocks, a cluster of 9 to 16); the streamed form at m = 1,200 (seeded,
    B=64) and 4,200 (B=2, two tensor copies a stage); the global-rows form
    at m = 6,627 (seeded, B=1), past the streamed form's reach.  One call
    of each form counted and timed: the cluster at m = 240 and 672, the
    streamed at 1,200; global rows counted at 6,627 and timed at 672,
    forced by its plan (the route the parent took there); each against the
    one-read bound and the floor of iters reads."""
    from eggshell_tpu_torch.ops.pgs_kernel import (jacobi_global_plan, jacobi_launch_plan,
                                                   launch_jacobi_plan, solve_lcp_jacobi,
                                                   solve_lcp_jacobi_plain)

    iters, omega, beta = 16, 0.3, 0.45
    wide = wide_unfused_lcp(dev)
    k224 = unfused_first_lcp(dev, cfg=slice_cfg().replace(contact_capacity=UNFUSED_WIDE_CAPACITY),
                             batch=B_WIDE)
    m672 = random_spd_lcp(dev, B=64, m=672)
    m1200 = random_spd_lcp(dev, B=64, m=1200)
    past = random_spd_lcp(dev, B=1, m=PAST_STREAMED)
    cases = [(f"first-step inputs of the unfused slice at contact_capacity 80, "
              f"{tuple(wide[0].shape)}", wide, "cluster"),
             ("seeded random SPD (512, 480, 480)", random_spd_lcp(dev, B=512, m=480), "cluster"),
             ("seeded random SPD (64, 672, 672)", m672, "cluster"),
             (f"first-step inputs of the unfused slice at contact_capacity "
              f"{UNFUSED_WIDE_CAPACITY}, {tuple(k224[0].shape)}", k224, "cluster"),
             ("seeded random SPD (64, 1200, 1200)", m1200, "streamed"),
             ("seeded random SPD (2, 4200, 4200), two tensor copies a stage",
              random_spd_lcp(dev, B=2, m=4200), "streamed"),
             (f"seeded random SPD (1, {PAST_STREAMED}, {PAST_STREAMED})", past, "global rows")]
    tags = {"cluster": "cluster", "streamed": "streamed", "global rows": "global"}
    res = {}
    for block, bound_rel in ((False, 1e-4), (True, 1e-5)):
        name = "jacobi_block" if block else "jacobi"
        fn = "eggshell_jacobi_block_f32" if block else "eggshell_jacobi_f32"
        params = (iters, omega) if block else (iters, omega, beta)
        err = {route: 0.0 for route in tags}
        for what, args, route in cases:
            m = args[1].shape[1]
            check(jacobi_launch_plan(m, block).route == route,
                  f"{name}: m = {m} takes the {jacobi_launch_plan(m, block).route} form")
            got = solve_lcp_jacobi(*args, iters, omega, beta, block=block)
            want = (solve_lcp_jacobi_plain(*args, iters, omega, block=True) if block
                    else solve_lcp_jacobi_plain(*args, iters, omega, beta))
            rows = launch_jacobi_plan(fn, jacobi_global_plan(m, block), *args, *params)
            e = float((got - want).abs().max())
            rel = e / float(want.abs().max())
            same = torch.equal(got, rows)
            err[route] = max(err[route], e)
            tag = f"{name}_{tags[route]}"
            print(f"[{tag}] {what}, iters 16, {plan_text(m, block)}: max |dx| {e:.3e}, "
                  f"relative {rel:.3e} (bound {bound_rel:.0e}); bit for bit the plain "
                  f"version's {torch.equal(got, want)}, the global-rows form's {same}")
            check(bool(torch.isfinite(got).all()), f"{tag} output not finite on {what}")
            check(rel <= bound_rel, f"{tag} relative error {rel} on {what}")
            check(same, f"{tag} differs from the global-rows form on {what}")
        per_row = 16.0 if block else 10.0
        kname = f"{'block_' if block else ''}jacobi"

        def timed(tag, args, kernel, call=None):
            call = call or (lambda: solve_lcp_jacobi(*args, iters, omega, beta, block=block))
            plain = ((lambda: solve_lcp_jacobi_plain(*args, iters, omega, block=True)) if block
                     else (lambda: solve_lcp_jacobi_plain(*args, iters, omega, beta)))
            t = timings(kernel, call, plain)
            Bm, mm = args[1].shape
            b = bound(moved_bytes(args, call()), Bm * iters * (2.0 * mm * mm + per_row * mm))
            fl = floor_ms(args)
            print(f"[{tag}] m={mm}, B={Bm}: {timing_text(t)}, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']}: {b['bytes']} bytes), {ratio_text(t, b)}; floor of 16 "
                  f"reads of A {fl:.4f} ms, {t['ms'] / fl:.2f}x it")
            return {**t, **b, "floor_ms": fl}

        for route, args in (("cluster", wide), ("cluster", m672), ("streamed", m1200),
                            ("global rows", past)):
            tag = f"{name}_{tags[route]}"
            m = args[1].shape[1]
            out, launches = one_call_launches(
                tag, name, lambda: solve_lcp_jacobi(*args, iters, omega, beta, block=block))
            if route == "global rows":
                # timed at m = 672, B = 64, forced by its plan (the route the
                # parent took there): at m = 6,627 one block runs a call
                t = timed(tag, m672, f"{kname}_global_kernel",
                          lambda: launch_jacobi_plan(fn, jacobi_global_plan(672, block), *m672,
                                                     *params))
            else:
                t = timed(tag, args, f"{kname}_{tags[route]}_kernel")
            if m == 672:   # the wide cluster's shape: beside the m = 240 numbers
                res[tag].update({"launches_672": launches, **{f"{k}_672": t[k] for k in (
                    "ms", "plain_ms", "bound_ms", "floor_ms")}})
                continue
            res[tag] = {"max_abs_err": err[route], **t, "launches": launches}
    return res


def phase_jacobi_packed_rows(dev):
    """B6b past the portable cluster's mp = 664, each against its plain
    version (relative bound 1e-4, as `[jacobi_packed_stream]`) and bit for
    bit against the global-rows form forced by its plan: a cluster of 9 to
    16 blocks at mp = 672 and 888 (seeded, B=256; 888 with a shorter last
    block), the streamed form at mp = 1,200 (seeded, B=64) and 4,200 (B=2,
    two tensor copies a stage: more rows a block than a box holds), and the
    global-rows form at mp = 6,648 (seeded, B=1), past the streamed form's
    reach.  One call of each counted and timed (the cluster at mp = 888,
    B = 256, the streamed at 1,200, B = 64; global rows counted at 6,648
    and timed, forced, at 888: the route the parent took there), each
    against the one-read bound and the floor of iters reads."""
    from eggshell_tpu_torch.ops.pgs_kernel import (launch_packed_plan, packed_launch_plan,
                                                   rows_plan, solve_lcp_jacobi_packed_plain,
                                                   solve_lcp_jacobi_packed_stream)

    cases = [(f"seeded random SPD ({B}, {mp}, {mp})", random_lcp(dev, B, mp // 3, SEED + mp), route)
             for B, mp, route in ((256, 672, "cluster"), (256, 888, "cluster"),
                                  (64, 1200, "streamed"), (1, PACKED_PAST_STREAMED, "rows"),
                                  (2, 4200, "streamed"))]
    err = {}
    for what, args, route in cases:
        mp = args[1].shape[1]
        plan = packed_launch_plan(mp)
        chosen = plan.cluster or plan.streamed or plan.rows
        check(getattr(plan, route) is not None,
              f"jacobi_packed_rows: the plan at mp = {mp} is {chosen}, expected {route}")
        got = solve_lcp_jacobi_packed_stream(*args)
        want = solve_lcp_jacobi_packed_plain(*args)
        rows = launch_packed_plan(rows_plan(mp, 3), *args)
        e = float((got - want).abs().max())
        rel = e / max(1.0, float(want.abs().max()))
        err[route] = max(err.get(route, 0.0), e)
        same = torch.equal(got, rows)
        print(f"[jacobi_packed_rows] {what}: {chosen}: max |dx| {e:.3e}, relative to scale "
              f"{rel:.3e} (bound 1e-4); bit for bit the global-rows form's {same}")
        check(bool(torch.isfinite(got).all()), f"jacobi_packed_rows output not finite on {what}")
        check(rel <= 1e-4, f"jacobi_packed_rows relative error {rel} on {what}")
        check(same, f"jacobi_packed_rows differs from the global-rows form on {what}")

    def timed(what, args, kernel, call=None):
        call = call or (lambda: solve_lcp_jacobi_packed_stream(*args))
        t = timings(kernel, call, lambda: solve_lcp_jacobi_packed_plain(*args))
        b = bound(moved_bytes(args, call()), _fused_flops("jacobi_packed", args))
        fl = floor_ms(args)
        print(f"[jacobi_packed_rows] {what}, mp={args[1].shape[1]}, B={args[1].shape[0]}: "
              f"{timing_text(t)}, bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} "
              f"bytes), {ratio_text(t, b)}; floor of 16 reads of A {fl:.4f} ms, "
              f"{t['ms'] / fl:.2f}x it")
        return {**t, **b, "floor_ms": fl}

    res = {}
    for (what, args, route), key in zip(
            cases[1:4], ("jacobi_packed_stream", "jacobi_packed_streamed", "jacobi_packed_rows")):
        out, launches = one_call_launches(f"jacobi_packed_rows/{route}", "jacobi_packed_stream",
                                          lambda: solve_lcp_jacobi_packed_stream(*args))
        if route == "rows":
            # timed at mp = 888, B = 256, forced by its plan (the route the
            # parent took there): at mp = 6,648 one block runs a call
            wide = cases[1][1]
            t = timed("global rows forced at the cluster's shape", wide,
                      "jacobi_packed_rows_kernel",
                      lambda: launch_packed_plan(rows_plan(888, 3), *wide))
        else:
            t = timed(route, args, f"{key}_kernel")
        res[key] = {"max_abs_err": err[route], **t, "launches": launches}
    return res


def phase_wide_rows_first_step(dev, first):
    """B6b on box_stack8's first step at contact_capacity 296 (mp = 888,
    B = B_WIDE, the inputs `[scene_box_stack8_k296]` starts from) against
    its plain version (1e-4) and bit for bit against the global-rows form
    forced by its plan, timed."""
    from eggshell_tpu_torch.ops.pgs_kernel import (launch_packed_plan, packed_launch_plan,
                                                   rows_plan, solve_lcp_jacobi_packed_plain,
                                                   solve_lcp_jacobi_packed_stream)

    args = first[:10]
    mp = args[1].shape[1]
    got = solve_lcp_jacobi_packed_stream(*args)
    want = solve_lcp_jacobi_packed_plain(*args)
    rows = launch_packed_plan(rows_plan(mp, 3), *args)
    e = float((got - want).abs().max())
    rel = e / max(1.0, float(want.abs().max()))
    same = torch.equal(got, rows)
    t = timings("jacobi_packed_stream_kernel", lambda: solve_lcp_jacobi_packed_stream(*args),
                lambda: solve_lcp_jacobi_packed_plain(*args))
    b = bound(moved_bytes(args, got), _fused_flops("jacobi_packed", args))
    print(f"[scene_box_stack8_k296] first-step inputs, A {tuple(args[0].shape)}, "
          f"{packed_launch_plan(mp).cluster}: max |dx| {e:.3e}, relative to scale {rel:.3e} "
          f"(bound 1e-4); bit for bit the global-rows form's {same}; {timing_text(t)}, "
          f"{ratio_text(t, b)}")
    check(bool(torch.isfinite(got).all()), "scene_box_stack8_k296 B6b output not finite")
    check(rel <= 1e-4, f"scene_box_stack8_k296 B6b relative error {rel}")
    check(same, "scene_box_stack8_k296 B6b differs from the global-rows form")
    return e


def fdtd_grids(dev, n, seed):
    """Seeded random Ez, Hx, Hy on an n x n grid with a relative
    permittivity in [1, 4] and a PEC wall across column n/2 (with an
    aperture) plus 5 % random PEC cells, as the fused step's grids."""
    from eggshell_tpu_torch.fem.fdtd import Field2D, fused_grids

    rng = np.random.default_rng(SEED + n)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    field = Field2D(f(rng.normal(size=(n, n))), f(rng.normal(size=(n, n - 1))),
                    f(rng.normal(size=(n - 1, n))))
    pec = rng.uniform(size=(n, n)) < 0.05
    pec[:, n // 2] = True
    pec[n // 2 - n // 20:n // 2 + n // 20, n // 2] = False
    return fused_grids(field, f(rng.uniform(1.0, 4.0, (n, n))), torch.as_tensor(pec, device=dev))


def phase_fdtd2d(dev):
    """B8 against its plain version at n = 512 and 2048 (bit for bit
    expected: no sums; 1e-6 of max |ez| required), timed at both; the row
    of the kernels line is n = 2048's, the rollout's size."""
    from eggshell_tpu_torch.fem.fdtd import courant_dt, step_2d_fused, step_2d_fused_plain

    res = {}
    for n in (512, 2048):
        grids = fdtd_grids(dev, n, SEED)
        dx = 1.0 / (n - 1)
        dt = courant_dt(dx, 2, 0.7)
        got = step_2d_fused(*grids, dt, dx)
        want = step_2d_fused_plain(*grids, dt, dx)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = float(want[0].abs().max())
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"[fdtd2d] n={n}, seeded random fields, eps_r and PEC: max |d| {err:.3e} of max "
              f"|ez| {scale:.3e} (bound 1e-6 of it); bit for bit {same}")
        check(all(bool(torch.isfinite(g).all()) for g in got), f"fdtd2d output not finite, n={n}")
        check(err <= 1e-6 * scale, f"fdtd2d error {err} at n={n}")
        t = timings("fdtd2d_kernel", lambda: step_2d_fused(*grids, dt, dx),
                    lambda: step_2d_fused_plain(*grids, dt, dx))
        b = bound(moved_bytes(grids, got), 15.0 * n * n)
        print(f"[fdtd2d] n={n}: {timing_text(t)}, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: {b['bytes']} bytes)")
        res = {"max_abs_err": err, **t, **b}
    return res


def aperture_run(dev, n, steps, dtype=torch.float32, source_col=None):
    """examples/fdtd_aperture.py's run at n: dx = 1 / (n - 1), the Courant
    step at safety 0.7, a PEC wall across column n/2 with an aperture of
    rows n/2 - n/20 .. n/2 + n/20, a Gaussian soft source (t0 40 dt, sigma
    12 dt) at row n/2, column n/5 or `source_col`.  Returns (pec, final
    field, probe trace at the aperture)."""
    from eggshell_tpu_torch.fem.fdtd import courant_dt, init_2d, simulate_2d

    dx = 1.0 / (n - 1)
    dt = courant_dt(dx, 2, 0.7)
    pec = torch.zeros((n, n), dtype=torch.bool, device=dev)
    pec[:, n // 2] = True
    pec[n // 2 - n // 20:n // 2 + n // 20, n // 2] = False
    t0, sig = 40 * dt, 12 * dt
    col = n // 5 if source_col is None else source_col
    fin, trace = simulate_2d(init_2d(n, n, dtype, device=dev), steps, dt, dx, pec=pec,
                             source_ij=(n // 2, col),
                             source_fn=lambda t: torch.exp(-((t - t0) ** 2) / (2 * sig ** 2)),
                             probe_ij=(n // 2, n // 2))
    return pec, fin, trace


FDTD_N, FDTD_STEPS = 2048, 200


def phase_fdtd2d_rollout(dev):
    """`simulate_2d` at n = 2048 for 200 steps, once to warm up and once
    timed with every launch counter at 0 just before: B8 must launch once a
    step and nothing else.  The example's wall and aperture scaled to n;
    the source 48 cells before the wall (at column n/5 the pulse would need
    about 1,300 steps to reach it).  Then the example itself at n = 160,
    260 steps, on the card in float32 against the plain path on the CPU in
    float64 (1e-4 of max |ez|), and the energy of a source-free TM11 cavity
    (n = 512) over 2000 steps (within 5 %, as tests/test_fdtd.py)."""
    from eggshell_tpu_torch.fem.fdtd import courant_dt, energy_2d, init_2d, simulate_2d

    n, steps = FDTD_N, FDTD_STEPS
    col = n // 2 - 48
    aperture_run(dev, n, steps, source_col=col)
    torch.cuda.synchronize()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pec, fin, trace = aperture_run(dev, n, steps, source_col=col)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    ez = fin.ez
    on_pec = float(ez[pec].abs().max())
    leak = float(ez[:, n // 2 + 4:].abs().max())
    peak = float(ez.abs().max())
    print(f"[fdtd2d_rollout] n={n}, {steps} steps: {wall:.4f} s, {n * n * steps / wall:.1f} "
          f"cell-steps/s; launches {launches}; max |ez| {peak:.3e}, on PEC cells {on_pec:.3e} "
          f"(bound 0), past the wall {leak:.3e} (bound > 0)")
    check(all(bool(torch.isfinite(x).all()) for x in fin) and bool(torch.isfinite(trace).all()),
          "fdtd2d_rollout output not finite")
    want = {name: steps if name == "fdtd2d" else 0 for name in counters}
    check(launches == want, f"fdtd2d_rollout launches {launches}, expected {want}")
    check(on_pec == 0.0, f"fdtd2d_rollout |ez| {on_pec} on a PEC cell")
    check(leak > 0.0, "fdtd2d_rollout: no field past the wall")

    _, card, card_trace = aperture_run(dev, 160, 260)
    _, cpu, cpu_trace = aperture_run(torch.device("cpu"), 160, 260, torch.float64)
    err = max(float((card.ez.double().cpu() - cpu.ez).abs().max()),
              float((card_trace.double().cpu() - cpu_trace).abs().max()))
    scale = float(cpu.ez.abs().max())
    leak160 = float(cpu.ez[:, 84:].abs().max()) / scale
    print(f"[fdtd2d_rollout] examples/fdtd_aperture.py (n=160, 260 steps), card f32 against CPU "
          f"f64 plain path: max |d| {err:.3e} of max |ez| {scale:.3e} (bound 1e-4 of it); leak "
          f"ratio past the wall {leak160:.3e}")
    check(err <= 1e-4 * scale, f"fdtd2d_rollout disagrees with the plain path: {err}")

    nc = 512
    dx = 1.0 / (nc - 1)
    dt = courant_dt(dx, 2, 0.7)
    x = torch.linspace(0, 1, nc, device=dev)
    f = init_2d(nc, nc, device=dev)
    f = f._replace(ez=(torch.sin(np.pi * x)[:, None] * torch.sin(np.pi * x)[None, :]).contiguous())
    f1, _ = simulate_2d(f, 5, dt, dx)
    e0 = float(energy_2d(f1, dx))
    f2, _ = simulate_2d(f1, 2000, dt, dx)
    e1 = float(energy_2d(f2, dx))
    drift = abs(e1 - e0) / e0
    print(f"[fdtd2d_rollout] TM11 cavity n={nc}, 2000 steps: energy {e0:.6e} -> {e1:.6e}, "
          f"drift {drift:.3e} (bound 5e-2)")
    check(drift < 5e-2, f"fdtd2d_rollout cavity energy drift {drift}")
    return launches["fdtd2d"], n * n * steps / wall


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
    from eggshell_tpu_torch.ops import launch_counters

    return launch_counters()


def lowest_corners(spec, st):
    """z of each box's lowest corner, (B, n)."""
    from eggshell_tpu_torch.ops.quaternion import quat_to_mat

    R = quat_to_mat(st.q)
    return st.p[..., 2] - (R[..., 2, :].abs() * spec.half_extents).sum(-1)


def stands(spec, start, final):
    """Every box of the stack within 1 cm of its start."""
    moved = float((final.p - start.p).abs().max())
    check(moved < 1e-2, f"a box of the stack moved {moved} m")
    return f"largest move {moved:.3e} m (bound 1e-2)"


def rests(spec, start, final):
    """The dropped box rests: its bottom within 1 mm of the ground, |v| below 1 mm/s."""
    gap = float(lowest_corners(spec, final).abs().max())
    speed = float(final.v.abs().max())
    check(gap < 1e-3 and speed < 1e-3, f"box does not rest: gap {gap} m, |v| {speed} m/s")
    return f"bottom {gap:.3e} m from the ground (bound 1e-3), max |v| {speed:.3e} m/s (bound 1e-3)"


def joints_hold(spec, start, final):
    """Every ball joint's two anchors within 1 mm of each other."""
    from eggshell_tpu_torch.physics.contacts import joint_anchors

    a0, a1 = joint_anchors(spec, final)
    sep = float((a0 - a1).norm(dim=-1).max())
    check(sep < 1e-3, f"joint separation {sep} m")
    return f"max joint separation {sep:.3e} m (bound 1e-3)"


def above_floor(spec, start, final):
    """The free bodies' lowest corners no more than 1 cm below the floor."""
    low = float(lowest_corners(spec, final)[:, spec.inv_mass > 0].min())
    check(low > -1e-2, f"a free body sank to {low} m")
    return f"lowest corner of a free body at {low:.3e} m (bound -1e-2)"


def timed_rollout(spec, states, cfg, graph):
    """(final states, host seconds) of one synchronised rollout_batched
    call of H_SLICE steps."""
    from eggshell_tpu_torch.parallel.rollout import rollout_batched

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = rollout_batched(spec, states, cfg, H_SLICE, graph=graph)
    torch.cuda.synchronize()
    return final, time.perf_counter() - t0


def phase_rollout(dev, tag, scene, path, physical, cfg=None, batch=None, info=None):
    """Roll B_SLICE scenarios of the BASELINE scene `scene` H_SLICE steps
    through `rollout_batched`: where the configuration is
    `graph_capturable`, the captured rollout (its first call, warm-up step
    and capture included, then timed) and the eager loop (`graph=False`,
    after a warm-up call) in turns, graph, loop, loop, graph; they must
    give the same bits.  Before each timed call every launch counter is set
    to 0 and after it the kernels of `path` must each have launched once a
    step and no other kernel at all.  `cfg` replaces the scene's bench
    configuration, `batch` = (spec, states, cfg) the scene's batch and
    configuration; `physical(spec, start, final)` checks the outcome.
    Returns (launches of the main path's run, its rollouts/s); `info`, a
    dict, gets the spec, start and final states, the mean captured and
    eager seconds and the first call's."""
    from eggshell_tpu_torch.parallel.rollout import capture_refusal
    from eggshell_tpu_torch.physics import scenes

    if batch is None:
        spec, states, scene_cfg = scenes.baseline_batch(scene, B_SLICE, device=dev)
    else:
        spec, states, scene_cfg = batch
    cfg = scene_cfg if cfg is None else cfg
    B = states.p.shape[0]
    refusal = capture_refusal(cfg)
    counters = launch_counters()
    want = {name: H_SLICE if name in path else 0 for name in counters}

    def counted(graph):
        for fn in counters.values():
            fn.launches = 0
        final, dt = timed_rollout(spec, states, cfg, graph)
        launches = {name: fn.launches for name, fn in counters.items()}
        check(launches == want, f"{tag} kernel launches {launches} ({'graph' if graph else 'loop'})"
                                f", expected {want}")
        return final, dt, launches

    warm, _ = timed_rollout(spec, states, cfg, False)
    check(bool(torch.isfinite(warm.p).all()), f"{tag} warm-up rollout not finite")
    if refusal is None:
        cold, cold_s = timed_rollout(spec, states, cfg, True)
        times = {True: [], False: []}
        for graph in (True, False, False, True):
            final, dt, launches = counted(graph)
            times[graph].append(dt)
            if graph:
                main_final, main_launches = final, launches
            else:
                eager_final = final
        same = all(torch.equal(a, b) for a, b in zip(main_final, eager_final))
        same_cold = all(torch.equal(a, b) for a, b in zip(main_final, cold))
        g, e = (sum(times[k]) / 2 for k in (True, False))
        print(f"[{tag}] captured rollout: {B / times[True][0]:.1f}, "
              f"{B / times[True][1]:.1f} rollouts/s; eager loop: "
              f"{B / times[False][0]:.1f}, {B / times[False][1]:.1f} rollouts/s; "
              f"graph / loop {e / g:.2f}x (mean seconds); first graph call {cold_s:.4f} s, of "
              f"which warm-up and capture {cold_s - g:.4f} s; the graph's bits the loop's: {same}"
              f" (and the first call's: {same_cold})")
        check(same and same_cold, f"{tag} captured rollout differs from the eager loop")
        dt, rate, final, launches = g, B / g, main_final, main_launches
        if info is not None:
            info.update(graph_s=g, eager_s=e, cold_s=cold_s)
    else:
        final, dt, launches = counted(None)
        rate = B / dt
        print(f"[{tag}] eager loop only ({refusal}): {rate:.1f} rollouts/s")

    finite = all(bool(torch.isfinite(x).all()) for x in final)
    shapes = [tuple(x.shape) for x in final]
    n = spec.num_bodies
    print(f"[{tag}] {scene} B={B} H={H_SLICE} K={cfg.contact_capacity}: {dt:.4f} s, "
          f"{rate:.1f} rollouts/s, {B * H_SLICE / dt:.1f} steps/s; launches "
          f"{launches}; finite {finite}; shapes {shapes}")
    check(finite, f"{tag} output not finite")
    check(shapes == [(B, n, 3), (B, n, 3), (B, n, 4), (B, n, 3)],
          f"{tag} output shapes {shapes}")
    print(f"[{tag}] {physical.__doc__.strip()} {physical(spec, states, final)}")
    if info is not None:
        info.update(spec=spec, start=states, final=final, cfg=cfg)
    return launches, rate


AGREE_STEPS = 30
AGREE_BOUND = 2e-3


def phase_agreement(dev, tag, scene, cfg=None):
    """8 of the scene's B_SLICE scenarios, spread over the batch, rolled
    AGREE_STEPS steps (its bench configuration, or `cfg`) on the card in
    float32 and by the plain path on the CPU in float64 from the same
    start: positions and quaternions within
    AGREE_BOUND.  Velocities are printed beside their scale: under 16
    Jacobi sweeps the 8-box stack's contact impulses amplify rounding, and
    its velocities differ between float32 and float64 by up to their own
    size while positions stay within 1 mm."""
    from eggshell_tpu_torch.parallel.rollout import rollout_batched
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.scene import State

    spec, states, scene_cfg = scenes.baseline_batch(scene, B_SLICE, device=dev)
    cfg = scene_cfg if cfg is None else cfg
    idx = torch.linspace(0, B_SLICE - 1, 8, device=dev).round().long()
    start = State(*[x[idx].contiguous() for x in states])
    got = rollout_batched(spec, start, cfg, AGREE_STEPS)
    spec64, _ = scenes.BASELINE[scene][0](device="cpu", dtype=torch.float64)
    want = rollout_batched(spec64, State(*[x.double().cpu() for x in start]), cfg, AGREE_STEPS)
    err = {k: float((getattr(got, k).double().cpu() - getattr(want, k)).abs().max()) for k in "pqvw"}
    scale = {k: float(getattr(want, k).abs().max()) for k in "vw"}
    print(f"[{tag}] card f32 against CPU f64 plain path, 8 scenarios, {AGREE_STEPS} steps: "
          f"max |dp| {err['p']:.3e}, |dq| {err['q']:.3e} (bound {AGREE_BOUND:.0e}); |dv| "
          f"{err['v']:.3e} of |v| up to {scale['v']:.3e}, |dw| {err['w']:.3e} of |w| up to "
          f"{scale['w']:.3e}")
    check(err["p"] <= AGREE_BOUND and err["q"] <= AGREE_BOUND,
          f"{tag} disagrees with the plain path: {err}")
    return err


def controlled_step_ms(dev):
    """Device ms a replay of living_room's step captured with a control
    input (a StepGraph with controls, `controls[:, t]` filled into the
    controlled body's slot inside the graph) against the same step without
    one (the [scene_living_room] replay), from the same B_SLICE scenarios;
    each from one torch.profiler window of 10 replays, L2 not flushed."""
    from eggshell_tpu_torch.parallel.rollout import StepGraph
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.utils.profiling import device_window

    spec, states, cfg = scenes.baseline_batch("living_room", B_SLICE, device=dev)
    ctrls = mpc_controls(dev, horizon=64)[:B_SLICE]    # 31 replays at most
    out = {}
    for what, g in (("uncontrolled", StepGraph(spec, cfg, states)),
                    ("controlled", StepGraph(spec, cfg, states, controls=ctrls,
                                             controlled_body=MPC_BODY))):
        g.load(states, controls=ctrls if what == "controlled" else None)
        w = device_window(lambda: g.replay(1), 10)
        out[what] = w
        del g
    torch.cuda.empty_cache()
    c, u = out["controlled"], out["uncontrolled"]
    print(f"[mpc_living_room] a replayed step of living_room, B={B_SLICE}: controlled "
          f"{c['device_ms']:.4f} ms of device time in {c['launches']:.1f} device operations, "
          f"uncontrolled ([scene_living_room]) {u['device_ms']:.4f} ms in {u['launches']:.1f}; "
          f"controlled / uncontrolled {c['device_ms'] / u['device_ms']:.3f}")
    return {"controlled_ms": c["device_ms"], "uncontrolled_ms": u["device_ms"]}


def phase_mpc(dev):
    """The MPC cell of bench.py:181-218 through `mppi_update_batched`:
    living_room, S = MPC_S samples, H = MPC_H, float32.  The captured
    update (its first call, warm-up and capture included, untimed) and the
    eager one (`graph=False`, after a warm-up call) in turns, graph, loop,
    loop, graph, graph, loop, each from a generator seeded with SEED; all
    must give the same bits in the costs and the new mean.  Before each
    timed update every launch counter is set to 0, and after it each kernel
    of the fused path must have launched H times and no other.  Then 8 of
    the sampled control sequences, rolled on the CPU in float64 by the
    plain path: p and q within AGREE_BOUND of the card's, each cost within
    AGREE_BOUND relative; the new mean recomputed in float64 on the CPU
    from the card's costs and controls within 1e-5; every cost finite.
    Returns the launches of a captured update."""
    from eggshell_tpu_torch.mpc.sampling import mppi_update_batched, rollout_controlled_batched
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.scene import State

    tag = "mpc_living_room"
    spec, st, cfg, cost = mpc_problem(dev)
    mean = torch.zeros((MPC_H, 6), device=dev)
    counters = launch_counters()
    want = {name: MPC_H if name in FUSED_PATH else 0 for name in counters}

    def update(graph):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_mean, costs = mppi_update_batched(
            spec, st, cfg, mean, gen, cost, controlled_body=MPC_BODY, num_samples=MPC_S,
            noise_sigma=MPC_SIGMA, temperature=MPC_T, noise_mode="constant", graph=graph)
        torch.cuda.synchronize()
        return new_mean, costs, time.perf_counter() - t0

    update(False)
    cold = update(True)
    times, results = {True: [], False: []}, {True: [], False: []}
    for graph in (True, False, False, True, True, False):
        for fn in counters.values():
            fn.launches = 0
        new_mean, costs, dt = update(graph)
        launches = {name: fn.launches for name, fn in counters.items()}
        check(launches == want, f"{tag} kernel launches {launches} "
                                f"({'graph' if graph else 'loop'}), expected {want}")
        times[graph].append(dt)
        results[graph].append((new_mean, costs))
        if graph:
            main_launches = launches
    new_mean, costs = results[False][0]
    same = all(torch.equal(m, new_mean) and torch.equal(c, costs)
               for m, c in results[True] + results[False] + [cold[:2]])
    g, e = (sum(times[k]) / len(times[k]) for k in (True, False))
    rates = {k: [1.0 / t for t in times[k]] for k in (True, False)}
    print(f"[{tag}] living_room S={MPC_S} H={MPC_H} K={cfg.contact_capacity}, body {MPC_BODY}, "
          f"sigma {MPC_SIGMA}, T {MPC_T}, constant noise: captured update "
          f"{', '.join(f'{r:.2f}' for r in rates[True])} MPC solves/s, eager loop "
          f"{', '.join(f'{r:.2f}' for r in rates[False])}; mean {1 / g:.2f} and {1 / e:.2f} MPC "
          f"solves/s, {MPC_S / g:.1f} and {MPC_S / e:.1f} rollouts/s, {MPC_S * MPC_H / g:.1f} and "
          f"{MPC_S * MPC_H / e:.1f} steps/s; graph / loop {e / g:.2f}x (mean seconds); first "
          f"graph call {cold[2]:.4f} s, of which warm-up and capture {cold[2] - g:.4f} s; every "
          f"update the same bits in costs and new mean: {same}; launches {main_launches}")
    check(same, f"{tag} captured and eager updates differ")
    check(bool(torch.isfinite(costs).all()), f"{tag} a cost is not finite")
    check(tuple(new_mean.shape) == (MPC_H, 6) and tuple(costs.shape) == (MPC_S,),
          f"{tag} shapes {tuple(new_mean.shape)}, {tuple(costs.shape)}")

    ctrls = mpc_controls(dev)
    states = State(*(x.expand((MPC_S,) + x.shape) for x in st))
    final, _ = rollout_controlled_batched(spec, states, cfg, ctrls, MPC_BODY, graph=True)
    check(torch.equal(torch.func.vmap(cost)(final), costs),
          f"{tag} the captured rollout's costs are not the update's")
    idx = torch.linspace(0, MPC_S - 1, 8, device=dev).round().long()
    spec64, _, _, cost64 = mpc_problem("cpu", torch.float64)
    start64 = State(*(x.double().cpu().expand((8,) + x.shape) for x in st))
    want64, _ = rollout_controlled_batched(spec64, start64, cfg, ctrls[idx].double().cpu(),
                                           MPC_BODY, graph=False)
    err = {k: float((getattr(final, k)[idx].double().cpu() - getattr(want64, k)).abs().max())
           for k in "pq"}
    c64 = torch.func.vmap(cost64)(want64)
    cost_rel = float(((costs[idx].double().cpu() - c64).abs() / c64.abs()).max())
    costs64, ctrls64 = costs.double().cpu(), ctrls.double().cpu()
    wts = torch.exp(-(costs64 - costs64.min()) / MPC_T)
    mean64 = torch.einsum("s,shc->hc", wts / wts.sum(), ctrls64)
    mean_err = float((new_mean.double().cpu() - mean64).abs().max())
    print(f"[{tag}] 8 sampled sequences, card f32 against CPU f64 plain path, {MPC_H} steps: "
          f"max |dp| {err['p']:.3e}, |dq| {err['q']:.3e} (bound {AGREE_BOUND:.0e}); costs "
          f"{c64.min():.4f} to {c64.max():.4f}, max relative |dcost| {cost_rel:.3e} (bound "
          f"{AGREE_BOUND:.0e}); new mean recomputed in f64 from the card's costs and controls: "
          f"max |d| {mean_err:.3e} (bound 1e-5)")
    check(err["p"] <= AGREE_BOUND and err["q"] <= AGREE_BOUND,
          f"{tag} disagrees with the plain path: {err}")
    check(cost_rel <= AGREE_BOUND, f"{tag} costs disagree with the plain path: {cost_rel}")
    check(mean_err <= 1e-5, f"{tag} new mean differs from its f64 recomputation: {mean_err}")
    controlled_step_ms(dev)
    return main_launches


PILE_PATH = ("narrowphase",)
PILE_SINK = 0.03          # a tenth of a box side
PILE_AGREE_STEPS = 10


def sunk_no_deeper(spec, start, final):
    """Every body finite, and no box corner more than PILE_SINK below the floor."""
    finite = all(bool(torch.isfinite(x).all()) for x in final)
    low = float(lowest_corners(spec, final).min())
    check(finite and low > -PILE_SINK, f"pile: finite {finite}, lowest corner at {low} m")
    return f"every body finite, lowest corner at {low:.3e} m (bound -{PILE_SINK})"


def pile_first_b2(spec, states, cfg):
    """B2's inputs at the first step of the pile: each scenario's
    broadphase pairs, gathered (B * pair_capacity pairs)."""
    from eggshell_tpu_torch.ops.collision_kernel import gather_pairs
    from eggshell_tpu_torch.physics.contacts import scene_pairs

    pi, pj, _ = scene_pairs(spec, states, cfg)
    return gather_pairs(states.p, states.R(), spec.half_extents, pi, pj)


def pile_agreement(dev, tag, name):
    """1 scenario of the pile, PILE_AGREE_STEPS steps on the card in
    float32 against the plain path on the CPU in float64 from the same
    start: p and q within AGREE_BOUND."""
    from eggshell_tpu_torch.parallel.rollout import rollout_batched
    from eggshell_tpu_torch.physics import scenes

    spec, states, cfg = scenes.large_batch(name, 1, device=dev)
    got = rollout_batched(spec, states, cfg, PILE_AGREE_STEPS)
    spec64, states64, _ = scenes.large_batch(name, 1, device="cpu", dtype=torch.float64)
    want = rollout_batched(spec64, states64, cfg, PILE_AGREE_STEPS)
    err = {k: float((getattr(got, k).double().cpu() - getattr(want, k)).abs().max()) for k in "pq"}
    moved = float((want.p - states64.p).abs().max())
    print(f"[{tag}] card f32 against CPU f64 plain path, 1 scenario, {PILE_AGREE_STEPS} steps: "
          f"max |dp| {err['p']:.3e}, |dq| {err['q']:.3e} (bound {AGREE_BOUND:.0e}); the bodies "
          f"moved up to {moved:.3e} m")
    check(err["p"] <= AGREE_BOUND and err["q"] <= AGREE_BOUND,
          f"{tag} disagrees with the plain path: {err}")
    return err


def matvec_forms(tag, spec, states, cfg):
    """The step's matrix-free solve at `states` (the rollout's last state:
    the first has no contact yet; its rhs -erp/dt^2 err - J (u/dt +
    M^-1 F)) with cfg.solver_iters sweeps, in each matvec form: device ms
    and device operations a solve (one torch.profiler window of 5 solves,
    L2 not flushed), whether two runs give the same bits, and the largest
    difference from the "sorted" form's solution."""
    from eggshell_tpu_torch.ops import lcp_matrix_free as mf
    from eggshell_tpu_torch.physics import scene as scn
    from eggshell_tpu_torch.physics.constraints import build_compact_constraints
    from eggshell_tpu_torch.physics.contacts import make_contacts_batched
    from eggshell_tpu_torch.utils.profiling import device_window

    cs = make_contacts_batched(spec, states, cfg)
    sysc = build_compact_constraints(spec, states, cs, cfg)
    Minv = scn.inv_mass_blocks(spec, states)
    F = scn.external_forces(spec, states, cfg.gravity)
    u = scn.pack_velocity(states) / cfg.dt + torch.einsum("bnij,bnj->bni", Minv, F)
    rhs = (-cfg.erp / cfg.dt / cfg.dt * sysc.err
           - mf.j_v(sysc.blocks, sysc.b0, sysc.b1, u)).contiguous()
    out, x = {}, {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for mode in mf.MODES:
            def solve():
                return mf.solve_lcp_matrix_free(
                    sysc.blocks, sysc.b0, sysc.b1, Minv, rhs, sysc.is_eq, sysc.lo, sysc.hi,
                    iters=cfg.solver_iters, omega=cfg.jacobi_omega, beta=cfg.jacobi_beta,
                    cfm=float(cfg.cfm_always), matvec_mode=mode)
            x[mode] = solve()
            same = torch.equal(x[mode], solve())
            w = device_window(solve, 5)
            out[mode] = {"ms": w["device_ms"], "ops": w["launches"], "same_bits": same}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for mode in mf.MODES:
        d = float((x[mode] - x["sorted"]).abs().max())
        o = out[mode]
        print(f"[{tag}] matvec form {mode!r}: the last state's solve ({cfg.solver_iters} sweeps, "
              f"{int(cs.active.sum())} active lanes of {cs.b0.numel()}) {o['ms']:.4f} ms of "
              f"device time in {o['ops']:.1f} device operations; two runs the same bits: "
              f"{o['same_bits']}; max |dx| from 'sorted' {d:.3e}")
        check(d <= 1e-3 * max(1.0, float(x["sorted"].abs().max())),
              f"{tag} matvec form {mode} disagrees with 'sorted' by {d}")
    print(f"[{tag}] matvec form 'auto' on the card: {mf.AUTO_CUDA!r}")
    check(out[mf.AUTO_CUDA]["same_bits"], f"{tag} the 'auto' form is not deterministic")
    return {mode: o["ms"] for mode, o in out.items()}


def broadphase_kinds(tag, spec, states, cfg):
    """Device ms of the pile's broadphase (`select_scene_pairs`) in both
    kinds, "mask" and "sap" (window cfg.sap_window), on the first step's
    states, from one profiler window of 10 calls each; whether they select
    the same lanes."""
    from eggshell_tpu_torch.ops.broadphase import select_scene_pairs
    from eggshell_tpu_torch.utils.profiling import device_window

    got = {}
    for kind in ("mask", "sap"):
        c = cfg.replace(broadphase_kind=kind)
        w = device_window(lambda: select_scene_pairs(spec, states, c), 10)
        got[kind] = (w, select_scene_pairs(spec, states, c))
        print(f"[{tag}] broadphase {kind!r}"
              f"{f' (window {cfg.sap_window})' if kind == 'sap' else ''}: {w['device_ms']:.4f} ms "
              f"of device time in {w['launches']:.1f} device operations; "
              f"{int(got[kind][1][2].sum())} pairs selected")
    same = all(torch.equal(a, b) for a, b in zip(got["mask"][1], got["sap"][1]))
    print(f"[{tag}] the two kinds select the same lanes: {same}")
    return {k: w["device_ms"] for k, (w, _) in got.items()}


def phase_pile_b2(dev):
    """B2 at the piles' shape: the first step's pairs of pile216 and
    pile512 (each scenario's broadphase selection, 16,384 pairs at both)
    against the plain version, and timed with its bound.  Run before any
    graph is replayed: a profiler window after many replays can lose an
    event, and the flushed timing refuses such a window."""
    from eggshell_tpu_torch.ops.collision import collide_boxes
    from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes
    from eggshell_tpu_torch.physics import scenes

    out = {}
    for name in ("pile216", "pile512"):
        args = pile_first_b2(*scenes.large_batch(name, device=dev))
        N = args[0].shape[0]
        err = compare_contacts(f"[{name}] first-step inputs N={N}", collide_boxes_lanes(*args),
                               collide_boxes(*args))
        t = timings("narrowphase_kernel", lambda: collide_boxes_lanes(*args),
                    lambda: collide_boxes(*args))
        b = bound(moved_bytes(args, collide_boxes_lanes(*args)), 2000.0 * N)
        print(f"[narrowphase] [{name}] first-step shape N={N}: {timing_text(t)}, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), {ratio_text(t, b)}")
        out[name] = {"max_abs_err": err, **t, **b}
    return out


def phase_gated_kernels(dev):
    """B2p and B3 on the first-step inputs of `[scene_living_room_bp]`
    (each scenario's broadphase pair list of LIVING_ROOM_PAIR_CAPACITY
    pairs and its gate) against their plain versions, timed with their
    bounds; before any graph is replayed, as `phase_pile_b2`."""
    from eggshell_tpu_torch.ops.collision_kernel import (collide_boxes_lanes_packed,
                                                        collide_boxes_lanes_packed_plain)
    from eggshell_tpu_torch.ops.compact_kernel import compact_contacts, compact_contacts_plain
    from eggshell_tpu_torch.physics import scenes

    tag = "scene_living_room_bp"
    pc = scenes.LIVING_ROOM_PAIR_CAPACITY
    first = fused_inputs(dev, "living_room", bp_cfg(pc))
    nargs, cargs = first["narrowphase"], first["compact"]
    res = {}
    got = collide_boxes_lanes_packed(*nargs)
    plain = collide_boxes_lanes_packed_plain(*nargs)
    err = packed_pair_agreement(f"first-step inputs of [{tag}] (gated, pair lists (B, {pc}))",
                                got, plain)
    print(f"[narrowphase_packed] first-step inputs of [{tag}]: bit for bit the plain "
          f"version's: {all(torch.equal(a, b) for a, b in zip(got, plain))}")
    t = timings("narrowphase_packed_kernel", lambda: collide_boxes_lanes_packed(*nargs),
                lambda: collide_boxes_lanes_packed_plain(*nargs))
    pairs = nargs[0].shape[0] * nargs[3].shape[-1]
    b = bound(moved_bytes(nargs, got), 2060.0 * pairs)
    print(f"[narrowphase_packed] [{tag}] first-step shapes ({pairs} pairs, gated): "
          f"{timing_text(t)}, bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} bytes), "
          f"{ratio_text(t, b)}")
    res["narrowphase_packed"] = {"max_abs_err": err, "ms_bp": t["ms"], "plain_ms_bp":
                                 t["plain_ms"], "bound_ms_bp": b["bound_ms"]}
    err = compare_lanes("compact", f"first-step inputs of [{tag}] (pair lists (B, {pc}))",
                        compact_contacts(*cargs), compact_contacts_plain(*cargs))
    t = timings("compact_kernel", lambda: compact_contacts(*cargs),
                lambda: compact_contacts_plain(*cargs))
    Bc, nc = cargs[0].shape[:2]
    K = cargs[7]
    b = bound(compact_bytes(cargs, compact_contacts(*cargs)),
              Bc * (40.0 * 8 * nc + 5.0 * K * K + 2.0 * 12 * pc))
    print(f"[compact] inputs of [{tag}]: {timing_text(t)}, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: {b['bytes']} bytes), {ratio_text(t, b)}")
    res["compact"] = {"max_abs_err": err, "ms_bp": t["ms"], "plain_ms_bp": t["plain_ms"],
                      "bound_ms_bp": b["bound_ms"]}
    return res


def phase_pile(dev, name):
    """The large-scene cell `name` of bench.py:286-318 (`scenes.LARGE`):
    `rollout_batched` of its batch under the matrix-free step, H_SLICE
    steps, captured and eager in turns with the same bits, B2's launches,
    the dropped contacts on the first and last state, the replayed step's
    device operations and device ms, the physical check, and 1 scenario
    against the CPU f64 plain path.  pile512 also times the broadphase's
    two kinds and the solve's matvec forms.  (B2 is held and timed at the
    piles' shape in `phase_pile_b2`, before any graph is replayed.)
    Returns the phase's results."""
    from eggshell_tpu_torch.parallel.rollout import StepGraph, capture_refusal
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.contacts import count_dropped_contacts
    from eggshell_tpu_torch.utils.profiling import device_window

    tag = name
    spec, states, cfg = scenes.large_batch(name, device=dev)
    B, n = states.p.shape[:2]
    refusal = capture_refusal(cfg)
    print(f"[{tag}] box_pile({n}), B={B}, H={H_SLICE}, MATRIX_FREE {cfg.solver_iters} sweeps, "
          f"K={cfg.contact_capacity}, pair capacity {cfg.pair_capacity} of {spec.num_pairs}, "
          f"margin {cfg.broadphase_margin}, broadphase {cfg.broadphase_kind!r}; capture_refusal: "
          f"{refusal}")
    check(refusal is None, f"{tag} is refused a capture: {refusal}")
    info = {}
    launches, rate = phase_rollout(dev, tag, f"box_pile({n})", PILE_PATH, sunk_no_deeper,
                                   batch=(spec, states, cfg), info=info)
    steps = {k: B * H_SLICE / info[k] for k in ("graph_s", "eager_s")}
    print(f"[{tag}] captured {steps['graph_s']:.1f} steps/s, {n * steps['graph_s']:.1f} "
          f"body-steps/s; eager {steps['eager_s']:.1f} steps/s, {n * steps['eager_s']:.1f} "
          f"body-steps/s; capture (first call less a timed one) "
          f"{info['cold_s'] - info['graph_s']:.4f} s")
    dropped = [count_dropped_contacts(spec, st, cfg).tolist() for st in (states, info["final"])]
    print(f"[{tag}] count_dropped_contacts per scenario: first state {dropped[0]}, last state "
          f"{dropped[1]}")

    g = StepGraph(spec, cfg, states)
    g.load(states)
    w = device_window(lambda: g.replay(1), 5)
    print(f"[{tag}] a replayed step: {w['launches']:.1f} device operations, {w['device_ms']:.4f} "
          f"ms of device time, {w['wall_ms']:.4f} ms host clock (busy {100 * w['busy']:.1f} %)")
    del g
    res = {"launches": launches, "steps_per_s": steps, "dropped": dropped, "step_ops":
           w["launches"], "step_ms": w["device_ms"]}
    if name == "pile512":
        res["broadphase_ms"] = broadphase_kinds(tag, spec, states, cfg)
        res["matvec_ms"] = matvec_forms(tag, spec, info["final"], cfg)
    res["agreement"] = pile_agreement(dev, tag, name)
    torch.cuda.empty_cache()
    return res


def bp_cfg(pair_capacity):
    """living_room's bench configuration with the broadphase."""
    from eggshell_tpu_torch.physics import scenes

    return bench_cfg().replace(contact_capacity=scenes.BASELINE["living_room"][1],
                               pair_capacity=pair_capacity,
                               broadphase_margin=scenes.LIVING_ROOM_BP_MARGIN)


def phase_living_room_bp(dev, all_pairs_final):
    """living_room on the fused chain with the broadphase (margin 0.1):
    the pair capacity is the most pairs that overlap in any scenario at
    any step of the all-pairs eager rollout (B_SLICE, H_SLICE); at it
    `count_dropped_contacts` stays 0 over the broadphase's own rollout, one
    less drops contacts; it must be below the 15 candidate pairs and equal
    `scenes.LIVING_ROOM_PAIR_CAPACITY`.  The broadphase rollout (captured
    and eager in turns) must give the bits of the all-pairs
    `[scene_living_room]` rollout from the same start.  (B2p and B3 are
    held on this path's first-step inputs in `phase_gated_kernels`.)
    Returns (launches, the pair capacity)."""
    from eggshell_tpu_torch.ops.broadphase import pair_overlap_mask
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.contacts import count_dropped_contacts
    from eggshell_tpu_torch.physics.stepper import step_ode_batched

    tag = "scene_living_room_bp"
    spec, states, cfg = scenes.baseline_batch("living_room", B_SLICE, device=dev)
    margin = scenes.LIVING_ROOM_BP_MARGIN

    def trajectory(c):
        st, out = states, [states]
        for _ in range(H_SLICE):
            st = step_ode_batched(spec, st, c)
            out.append(st)
        return out

    need = max(int(pair_overlap_mask(st.p, st.q, spec.half_extents, spec.pair_i, spec.pair_j,
                                     margin).sum(1).max()) for st in trajectory(cfg))
    pc = max(1, need)
    dropped = max(int(count_dropped_contacts(spec, st, bp_cfg(pc)).max())
                  for st in trajectory(bp_cfg(pc)))
    fewer = (max(int(count_dropped_contacts(spec, st, bp_cfg(pc - 1)).max())
                 for st in trajectory(bp_cfg(pc - 1))) if pc > 1 else None)
    print(f"[{tag}] at most {need} of the {spec.num_pairs} candidate pairs overlap (margin "
          f"{margin}) in any scenario at any step of the all-pairs rollout: pair capacity {pc}; "
          f"the most contacts dropped in a scenario at a step over the broadphase rollout: "
          f"{dropped}, at pair capacity {pc - 1}: {fewer}")
    check(pc < spec.num_pairs and dropped == 0 and (fewer is None or fewer > 0),
          f"{tag} pair capacity {pc}: dropped {dropped}, at one less {fewer}")
    check(pc == scenes.LIVING_ROOM_PAIR_CAPACITY,
          f"{tag} pair capacity {pc}, scenes.LIVING_ROOM_PAIR_CAPACITY "
          f"{scenes.LIVING_ROOM_PAIR_CAPACITY}")
    cfg = bp_cfg(pc)
    info = {}
    launches, _ = phase_rollout(dev, tag, "living_room", FUSED_PATH, above_floor, cfg=cfg,
                                info=info)
    same = all(torch.equal(a, b) for a, b in zip(info["final"], all_pairs_final))
    print(f"[{tag}] the bits of the all-pairs [scene_living_room] rollout from the same start: "
          f"{same}")
    check(same, f"{tag} differs from the all-pairs rollout")
    return launches, pc


GRAD_CHECK_H = 5
GRAD_CHECK_BOUND = 1e-2     # tests/test_diff_kernel.py:96-103
# Steps the check's scenarios settle first.  From the bench's start, where
# the boxes touch at zero depth, a float32 gradient changes by 70-100 % of
# its scale under a one-ulp change of the positions (contacts appear or not
# by rounding); after GRAD_SETTLE steps by about 1e-6 (measured on the CPU's
# plain path).
GRAD_SETTLE = 200
GRAD_REPS = 3


def _zero_counters(counters):
    for fn in counters.values():
        fn.launches = 0


def counted_gradient(spec, states, cfg, H, counters):
    """One `profile_step.bench_gradient` call, the launches of its forward
    (H steps) and of its backward read apart."""
    from eggshell_tpu_torch.profile_step import bench_loss

    e = torch.zeros(states.p.shape[:2] + (6,), dtype=states.p.dtype,
                    device=states.p.device).requires_grad_()
    _zero_counters(counters)
    with torch.enable_grad():
        loss = bench_loss(spec, states, cfg, e, H)
        torch.cuda.synchronize()
        fwd = {name: fn.launches for name, fn in counters.items()}
        _zero_counters(counters)
        (g,) = torch.autograd.grad(loss, e)
    torch.cuda.synchronize()
    return g, fwd, {name: fn.launches for name, fn in counters.items()}


def phase_gradient_mpc(dev):
    """bench.py:220-284's gradient cell: the value and gradient with respect
    to the control wrenches (B, n, 6), held over H steps, of
    sum(p[:, -1, 2]) + sum(e^2) on box_stack(4) with the bench's jitter,
    float32, ext zero, at small_B256_H20 and production_B4096_H50, in two
    arms: kernel_ift (the bench configuration: the fused chain forward, its
    Function's backward the plain twin adopting B6's impulses) and
    xla_unrolled (SolverKind.JACOBI: the unfused branch, reverse through
    its 16 sweeps).  Each arm: one warm-up call, then GRAD_REPS synchronised
    calls; grad_steps_per_s = GRAD_REPS * B * H / s; the peak of
    max_memory_allocated over the timed calls; finite gradients.  A
    kernel_ift call's forward must launch each fused kernel H times and
    nothing else, its backward B2 H times (the twin's contacts) and
    nothing else.  Then scenarios 0-7 of the small shape, settled
    GRAD_SETTLE steps on the card: the kernel_ift gradient at H =
    GRAD_CHECK_H from the settled state against the same Function's on the
    CPU (its plain path) from the same state in float32, within
    GRAD_CHECK_BOUND of the latter's largest magnitude, and, printed
    without a bound, against it in float64: float32 and float64 find other
    contact points on the same stack (clip points whose depth rounds to
    either side of zero), so the two precisions' gradients differ by their
    own size on the CPU's plain path already.
    Returns (per-shape results, the launches of a small-shape kernel_ift
    call)."""
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.scene import State
    from eggshell_tpu_torch.profile_step import GRAD_SHAPES, bench_gradient
    from eggshell_tpu_torch.utils.config import SolverKind

    tag = "gradient_mpc"
    counters = launch_counters()
    out, grad_launches = {}, None
    for shape, (Bg, Hg) in GRAD_SHAPES.items():
        spec, st, kcfg = scenes.baseline_batch("box_stack4", Bg, device=dev)
        ext = torch.zeros(st.p.shape[:2] + (6,), device=dev)
        res, grads = {}, {}
        for arm, cfg in (("kernel_ift", kcfg),
                         ("xla_unrolled", kcfg.replace(solver=SolverKind.JACOBI))):
            bench_gradient(spec, st, cfg, ext, Hg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            for _ in range(GRAD_REPS):
                val, g = bench_gradient(spec, st, cfg, ext, Hg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) - base
            check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(val)),
                  f"{tag} {shape} {arm}: gradient not finite")
            res[arm] = {"grad_steps_per_s": GRAD_REPS * Bg * Hg / dt, "s_a_call": dt / GRAD_REPS,
                        "peak_bytes": peak, "value": float(val)}
            grads[arm] = g
        g_k, fwd, bwd = counted_gradient(spec, st, kcfg, Hg, counters)
        want_fwd = {name: Hg if name in FUSED_PATH else 0 for name in counters}
        want_bwd = {name: Hg if name == "narrowphase" else 0 for name in counters}
        check(fwd == want_fwd, f"{tag} {shape} forward launches {fwd}, expected {want_fwd}")
        check(bwd == want_bwd, f"{tag} {shape} backward launches {bwd}, expected {want_bwd}")
        # the backward's scatters (autograd of the gathers) add by atomics
        # in any order: a call's gradient is not bit for bit the last one's
        rerun = float((g_k - grads["kernel_ift"]).abs().max() / grads["kernel_ift"].abs().max())
        check(rerun <= 1e-4, f"{tag} {shape}: two kernel_ift calls' gradients differ by "
                             f"{rerun} of the scale")
        if grad_launches is None:
            grad_launches = {name: fwd[name] + bwd[name] for name in counters}
        gap = float((grads["kernel_ift"] - grads["xla_unrolled"]).abs().max()
                    / grads["xla_unrolled"].abs().max())
        k, x = res["kernel_ift"], res["xla_unrolled"]
        res["speedup"] = k["grad_steps_per_s"] / x["grad_steps_per_s"]
        res["relative_gap"] = gap
        print(f"[{tag}] {shape} (box_stack4, B={Bg}, H={Hg}, f32): kernel_ift "
              f"{k['grad_steps_per_s']:.1f} grad steps/s ({k['s_a_call']:.4f} s a call, peak "
              f"{k['peak_bytes'] / 2**20:.1f} MiB), xla_unrolled {x['grad_steps_per_s']:.1f} "
              f"grad steps/s ({x['s_a_call']:.4f} s a call, peak {x['peak_bytes'] / 2**20:.1f} "
              f"MiB); kernel_ift / xla_unrolled {res['speedup']:.2f}x; launches of a kernel_ift "
              f"call: forward {fwd}, backward {bwd}; two kernel_ift calls {rerun:.3e} of the "
              f"scale apart (bound 1e-4: atomics in the backward's scatters); max |g_ift - g_unrolled| / max |g_unrolled| "
              f"{gap:.3e} (no bound: IFT at 16 unconverged sweeps is not reverse through them)")
        out[shape] = res

    from eggshell_tpu_torch.parallel.rollout import rollout_batched

    Bs = GRAD_SHAPES["small_B256_H20"][0]
    spec, st, kcfg = scenes.baseline_batch("box_stack4", Bs, device=dev)
    settled = rollout_batched(spec, State(*(x[:8].contiguous() for x in st)), kcfg, GRAD_SETTLE)
    g_card, _, _ = counted_gradient(spec, settled, kcfg, GRAD_CHECK_H, counters)
    errs = {}
    for dtype in (torch.float32, torch.float64):
        spec_c, _ = scenes.BASELINE["box_stack4"][0](device="cpu", dtype=dtype)
        st_c = State(*(x.to("cpu", dtype) for x in settled))
        g = bench_gradient(spec_c, st_c, kcfg, torch.zeros(st_c.p.shape[:2] + (6,), dtype=dtype),
                           GRAD_CHECK_H)[1].double()
        errs[dtype] = (float((g_card.double().cpu() - g).abs().max()), float(g.abs().max()))
    (e32, s32), (e64, s64) = errs[torch.float32], errs[torch.float64]
    print(f"[{tag}] scenarios 0-7 settled {GRAD_SETTLE} steps on the card, H={GRAD_CHECK_H}: "
          f"kernel_ift gradient on the card (f32) against the same Function on the CPU (plain "
          f"path) from the same state: f32 max |dg| {e32:.3e}, {e32 / s32:.3e} of max |g| "
          f"{s32:.3e} (bound {GRAD_CHECK_BOUND:.0e}); f64 {e64:.3e}, {e64 / s64:.3e} of max |g| "
          f"{s64:.3e} (no bound: the precisions find other contact points)")
    check(s32 > 0 and e32 <= GRAD_CHECK_BOUND * s32, f"{tag} H={GRAD_CHECK_H} gradient "
                                                     f"disagrees: {e32} of scale {s32}")
    return out, grad_launches


def narrowphase_vjp_inputs(dev):
    """tests/test_diff_kernel.py:147-187's five pairs, float32."""
    from eggshell_tpu_torch.ops.quaternion import quat_to_mat

    rng = np.random.default_rng(3)
    n = 5
    p1 = rng.uniform(-0.1, 0.1, (n, 3))
    p2 = p1 + np.asarray([0.25, 0.0, 0.1]) + rng.uniform(-0.02, 0.02, (n, 3))
    q = rng.normal(size=(n, 4))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    R1 = f(np.broadcast_to(np.eye(3), (n, 3, 3)))
    return f(p1), R1, f(np.full((n, 3), 0.15)), f(p2), quat_to_mat(f(q)).contiguous(), \
        f(np.full((n, 3), 0.15))


def phase_narrowphase_vjp(dev):
    """The gradient of sum(depth of active lanes) + sum(position . normal)
    + sum(info_depth) with respect to p1 and R2 through
    `collide_boxes_lanes_diff` (B2 forward) against autograd of the plain
    `collide_boxes`, both on the card: within 1e-5 of the gradient's
    largest magnitude (the kernel's positions and normals, which the
    backward multiplies by, differ from the plain version's in the last
    bits); B2 launched once."""
    from eggshell_tpu_torch.ops.collision import collide_boxes
    from eggshell_tpu_torch.ops.collision_kernel import (collide_boxes_lanes,
                                                        collide_boxes_lanes_diff)

    tag = "narrowphase_vjp"

    def grads(fn):
        p1, R1, hs1, p2, R2, hs2 = narrowphase_vjp_inputs(dev)
        p1.requires_grad_()
        R2.requires_grad_()
        out = fn(p1, R1, hs1, p2, R2, hs2)
        zero = torch.zeros((), device=dev)
        loss = (torch.sum(torch.where(out.active, out.depth, zero))
                + torch.sum(out.position * out.normal) + torch.sum(out.info_depth))
        loss.backward()
        return p1.grad, R2.grad

    before = collide_boxes_lanes.launches
    got = grads(collide_boxes_lanes_diff)
    launched = collide_boxes_lanes.launches - before
    want = grads(collide_boxes)
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"[{tag}] d/dp1 and d/dR2 of 5 pairs (tests/test_diff_kernel.py:147-187, f32): "
          f"B2 forward and the plain backward against autograd of the plain narrowphase: max "
          f"|d| {err:.3e} of max |g| {scale:.3e} (bound 1e-5 of it); B2 launches {launched}")
    check(launched == 1, f"{tag}: B2 launched {launched} times")
    check(scale > 0.1 and err <= 1e-5 * scale, f"{tag} gradients differ: {err} of {scale}")
    return err


GRAD_PATHS = ("JACOBI", "PGS", "SOR", "DIRECT", "MATRIX_FREE")


def _paths_problem(dev, dtype):
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.physics.scene import State

    spec, st = scenes.box_stack(2, jitter=0.01, seed=1, device=dev, dtype=dtype)
    states = State(*(x.expand((2,) + x.shape).clone() for x in st))
    return spec, states._replace(p=states.p + torch.tensor([0.0, 1e-4], device=dev,
                                                           dtype=dtype)[:, None, None])


def _paths_gradient(spec, states, cfg):
    from eggshell_tpu_torch.physics.stepper import step_ode_batched

    e = torch.zeros(states.p.shape[:2] + (6,), dtype=states.p.dtype,
                    device=states.p.device).requires_grad_()
    with torch.enable_grad():
        out = step_ode_batched(spec, states, cfg, e)
        (g,) = torch.autograd.grad(torch.sum(out.p[:, -1, 2]) + torch.sum(out.v ** 2), e)
    return g


def phase_gradient_paths(dev):
    """One step of box_stack(2, jitter=0.01) at B = 2 under each solver of
    GRAD_PATHS (tests/test_diff_kernel.py:106-145's configuration with
    cfm_always 0.01 for float32): the gradient of sum(p[:, -1, 2]) +
    sum(v^2) with respect to the wrench on the card (float32, B2 forward)
    finite and within 1e-3 of its largest magnitude of the CPU's plain path
    in float64, and in float32 for DIRECT, whose float64 gap is printed:
    the boxes touch at zero depth, float32 rounds the depth to about 1e-7,
    and ERP turns that into normal impulses of 7e-4 where float64 finds
    1e-12, so DIRECT's exact solve has another active set in each
    precision (1.3e-2 of the scale apart on the CPU's plain path).  Then the guard: a kernel wrapper called outside its
    Function with a tensor that requires grad, and JACOBI_KERNEL's unfused
    solve (B6c, no backward), raise."""
    from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes
    from eggshell_tpu_torch.physics.stepper import step_ode_batched
    from eggshell_tpu_torch.utils.config import SimConfig, SolverKind

    tag = "gradient_paths"
    counters = launch_counters()
    spec, states = _paths_problem(dev, torch.float32)
    cpu = {dtype: _paths_problem("cpu", dtype) for dtype in (torch.float32, torch.float64)}
    errs = {}
    for name in GRAD_PATHS:
        cfg = SimConfig(conditional_cfm=False, cfm_always=0.01,
                        solver_iters=0 if name == "DIRECT" else 40, jacobi_omega=0.3,
                        contact_capacity=16, solver=SolverKind[name])
        _zero_counters(counters)
        g = _paths_gradient(spec, states, cfg)
        b2 = counters["narrowphase"].launches
        rel = {}
        for dtype, (spec_c, states_c) in cpu.items():
            g_c = _paths_gradient(spec_c, states_c, cfg).double()
            rel[dtype] = float((g.double().cpu() - g_c).abs().max() / g_c.abs().max())
        errs[name] = rel
        bounded = torch.float32 if name == "DIRECT" else torch.float64
        check(bool(torch.isfinite(g).all()), f"{tag} {name}: gradient not finite")
        check(b2 == 1, f"{tag} {name}: B2 launched {b2} times")
        check(rel[bounded] <= 1e-3, f"{tag} {name}: card against CPU {bounded} "
                                    f"{rel[bounded]} of scale")
    refused = []
    x = narrowphase_vjp_inputs(dev)
    p1 = x[0].clone().requires_grad_()
    for what, call in (
            ("collide_boxes_lanes", lambda: collide_boxes_lanes(p1, *x[1:])),
            ("JACOBI_KERNEL unfused (B6c)", lambda: _paths_gradient(
                spec, states, SimConfig(solver=SolverKind.JACOBI_KERNEL, conditional_cfm=True,
                                        contact_capacity=16)))):
        try:
            call()
        except RuntimeError as exc:
            check("requires grad" in str(exc), f"{tag} {what} raised {exc}")
            refused.append(what)
    check(len(refused) == 2, f"{tag}: only {refused} refused a gradient")
    print(f"[{tag}] box_stack(2) B=2 one step, card f32 against the CPU's plain path, max |dg| "
          f"/ max |g| against f64 and f32: "
          + ", ".join(f"{k} {v[torch.float64]:.3e} and {v[torch.float32]:.3e}"
                      for k, v in errs.items())
          + f" (bound 1e-3: f64, and f32 for DIRECT); B2 once on each; refused under grad: "
          + ", ".join(refused))
    return errs


def lcp_problems(n_problems=30, size=50):
    """tests/test_lcp.py:18-37's problems (numpy, seed 0), its bounded
    Murty test's bounds (seed 1) and an equality split of its mixed test
    (seed 3, 40 %, bounds +-5)."""
    def gen_spd(rng, n, cond_limit=1e7):
        while True:
            m = rng.uniform(-1, 1, (n, n))
            A = m.T @ m
            s = np.linalg.svd(A, compute_uv=False)
            if s[0] / s[-1] < cond_limit:
                return A

    rng = np.random.default_rng(0)
    probs = [(gen_spd(rng, size), rng.uniform(-1, 1, size)) for _ in range(n_problems)]
    rb, re = np.random.default_rng(1), np.random.default_rng(3)
    lo_b, hi_b, eq = [], [], []
    for _ in probs:
        lo_b.append(np.full(size, -rb.uniform(0, 2)))
        hi_b.append(np.full(size, rb.uniform(0.01, 2)))
        eq.append(re.uniform(size=size) < 0.4)
    return {"A": np.stack([p[0] for p in probs]), "b": np.stack([p[1] for p in probs]),
            "lo_b": np.stack(lo_b), "hi_b": np.stack(hi_b), "eq": np.stack(eq)}


def phase_direct(dev):
    """`murty_principal_pivot` without bounds ([0, inf)) and with
    tests/test_lcp.py's bounds, and `mixed_constraints_solver` (40 %
    equality rows, bounds +-5), float64 on the card, batched over the 30
    problems of tests/test_lcp.py's generator: every solution certified by
    the port's `oracle.lcp_oracle.check_lcp_solution` at 1e-8, every
    problem converged, and each problem's pivots equal to a call on it
    alone.  Prints the pivots and the ms of a batched call."""
    from eggshell_tpu_torch.ops import lcp_direct
    from eggshell_tpu_torch.oracle import lcp_oracle

    tag = "direct"
    pr = lcp_problems()
    N, n = pr["b"].shape
    t = {k: torch.tensor(v, device=dev) for k, v in pr.items()}
    cases = {
        "murty": (lcp_direct.murty_principal_pivot, (t["A"], t["b"], torch.zeros_like(t["b"]),
                                                     torch.full_like(t["b"], float("inf")))),
        "murty_bounds": (lcp_direct.murty_principal_pivot, (t["A"], t["b"], t["lo_b"],
                                                            t["hi_b"])),
        "mixed": (lcp_direct.mixed_constraints_solver, (t["A"], t["b"], t["eq"],
                                                        torch.full_like(t["b"], -5.0),
                                                        torch.full_like(t["b"], 5.0))),
    }
    out = {}
    for name, (fn, args) in cases.items():
        fn(*args, return_info=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, w, info = fn(*args, return_info=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        eq = args[2].cpu().numpy() if name == "mixed" else np.zeros((N, n), bool)
        lo, hi = (args[-2].cpu().numpy(), args[-1].cpu().numpy())
        ok = [lcp_oracle.check_lcp_solution(pr["A"][i], pr["b"][i], x[i].cpu().numpy(),
                                            w[i].cpu().numpy(), eq[i], lo[i], hi[i], 1e-8)
              for i in range(N)]
        alone = [int(fn(*(a[i:i + 1] for a in args), return_info=True)[2].iterations[0])
                 for i in range(N)]
        pivots = info.iterations.tolist()
        print(f"[{tag}] {name}, {N} problems of n={n}, f64, batched: {ms:.2f} ms a call; pivots "
              f"{min(pivots)} to {max(pivots)} (mean {sum(pivots) / N:.1f}); certified at 1e-8: "
              f"{sum(ok)}/{N}; converged {int(info.converged.sum())}/{N}; pivots equal to a call "
              f"on the problem alone: {pivots == alone}")
        check(all(ok), f"{tag} {name}: {N - sum(ok)} solutions fail the certificate")
        check(bool(info.converged.all()), f"{tag} {name}: not every problem converged")
        check(pivots == alone, f"{tag} {name}: batched pivots {pivots} against alone {alone}")
        out[name] = {"ms": ms, "pivots": pivots}
    return out


def direct_cfg():
    """tools/golden/gen_oracle_npz.py's configuration: DIRECT, cfm 0.01
    always, contact capacity 64."""
    from eggshell_tpu_torch.utils.config import SimConfig, SolverKind

    return SimConfig(solver=SolverKind.DIRECT, conditional_cfm=False, cfm_always=0.01,
                     contact_capacity=64)


def phase_gradient_mpc_update(dev):
    """tests/test_mpc_parallel.py:57-75 on the card: `gradient_mpc_update`
    on box_drop(height=5), H = 20, learning rate 1e7, 60 updates, float32,
    under JACOBI with 40 sweeps (the test's PGS is a Python row loop in the
    port: some 2,000 row updates a step, each a few launches); the final
    cost below 0.2 of the zero plan's and the mean force along +x."""
    from eggshell_tpu_torch.mpc import gradient_mpc_update
    from eggshell_tpu_torch.mpc.sampling import rollout_controlled
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.utils.config import SimConfig, SolverKind

    tag = "gradient_mpc_update"
    cfg = SimConfig(solver=SolverKind.JACOBI, solver_iters=40, conditional_cfm=False,
                    cfm_always=0.01, contact_capacity=16)
    spec, st = scenes.box_drop(height=5.0, device=dev, dtype=torch.float32)
    H = 20
    target = torch.tensor([0.2, 0.0, 5.0 - 0.5 * 9.8 * (H * cfg.dt) ** 2], device=dev)

    def cost(final):
        return torch.sum((final.p[0] - target) ** 2)

    ctrl = torch.zeros((H, 6), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctrl2, c2 = gradient_mpc_update(spec, st, cfg, ctrl, cost, learning_rate=1e7, steps=60)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c0 = float(cost(rollout_controlled(spec, st, cfg, ctrl, 0)[0]))
    fx = float(ctrl2[:, 0].mean())
    print(f"[{tag}] box_drop(5), H={H}, lr 1e7, 60 updates, f32, JACOBI 40 sweeps (not the "
          f"test's PGS: the port's PGS is a Python row loop): cost {c0:.4e} -> {float(c2):.4e} "
          f"(bound 0.2x), mean force along x {fx:.3f} N (bound > 0); {dt:.2f} s, "
          f"{dt / 60 * 1e3:.1f} ms an update")
    check(float(c2) < 0.2 * c0, f"{tag}: cost {float(c2)} not below 0.2 x {c0}")
    check(fx > 0.0, f"{tag}: mean force along x {fx}")
    return float(c2), c0


# ---------------------------------------------------------------------------
# The rest of the single-scene stepper and the FEM tier


STAB_TOL = 1e-9             # the stabilizers' err^2 stopping rule
STAB_STATE_BOUND = 1e-8     # card f64 against the CPU f64 plain path


def _max_state_diff(a, b) -> float:
    return max(float((getattr(a, k).double().cpu() - getattr(b, k).double().cpu()).abs().max())
               for k in "pqvw")


def _pulled_chain(dev, dtype, collide=False):
    """pendulum_chain6 (collide: the hanging chain(6) with the ground and its
    15 link pairs) with link 2 pulled 0.05 m along y, two joints apart."""
    from eggshell_tpu_torch.physics import scenes

    spec, st = (scenes.chain(6, collide=True, device=dev, dtype=dtype) if collide
                else scenes.pendulum_chain(6, device=dev, dtype=dtype))
    p = st.p.clone()
    p[2, 1] += 0.05
    return spec, st._replace(p=p)


def _sunk_box(dev, dtype):
    """box_drop's box with its bottom 1 mm below the floor."""
    from eggshell_tpu_torch.physics import scenes

    spec, st = scenes.box_drop(device=dev, dtype=dtype)
    p = st.p.clone()
    p[:, 2] = spec.half_extents[:, 2] - 1e-3
    return spec, st._replace(p=p)


def phase_stabilize(dev):
    """`init_stabilize` on pendulum_chain6 with a joint pulled 0.05 m apart
    and on box_drop's box sunk 1 mm into the floor (ground contacts
    re-detected every iteration), `post_stabilize` on the chain: float64 on
    the card against the CPU float64 plain path, the same iteration count,
    the final err^2 at most 1e-9 and the states within 1e-8.  Then B2's
    launches: `init_stabilize` of the chain with its 15 link pairs (and the
    ground) in float32 on the card, one B2 launch for each contact
    detection (iterations + 1), the CPU float32 plain path's iteration
    count, err^2 at most 1e-9, the state within AGREE_BOUND of the CPU
    float64 plain path's.  (B2 takes float32 only; in float32 the
    Tikhonov 1e-10 falls below the matrix's resolution, and a resting face
    contact, living_room's, makes J J^T exactly singular.)"""
    from eggshell_tpu_torch.physics import stepper
    from eggshell_tpu_torch.utils.config import SimConfig

    tag = "stabilize"
    cfg = SimConfig(contact_capacity=16)
    cases = (("init_stabilize, pendulum_chain6, a joint pulled 0.05 m", _pulled_chain,
              stepper.init_stabilize),
             ("post_stabilize, pendulum_chain6, a joint pulled 0.05 m", _pulled_chain,
              stepper.post_stabilize),
             ("init_stabilize, box_drop sunk 1 mm into the floor", _sunk_box,
              stepper.init_stabilize))
    out = {}
    for what, build, fn in cases:
        spec, st = build(dev, torch.float64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, iters = fn(spec, st, cfg, return_iterations=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        cspec, cst = build("cpu", torch.float64)
        want, citers = fn(cspec, cst, cfg, return_iterations=True)
        e = stepper.position_constraint_error(spec, got, cfg)
        e2 = float(e @ e)
        diff = _max_state_diff(got, want)
        print(f"[{tag}] {what}, f64: {iters} iterations on the card, {citers} on the CPU plain "
              f"path; err^2 {e2:.3e} (bound {STAB_TOL:.0e}); states within {diff:.3e} (bound "
              f"{STAB_STATE_BOUND:.0e}); {dt * 1e3 / max(iters, 1):.2f} ms an iteration")
        check(iters == citers, f"{tag} {what}: {iters} iterations against {citers}")
        check(e2 <= STAB_TOL, f"{tag} {what}: err^2 {e2}")
        check(diff <= STAB_STATE_BOUND, f"{tag} {what}: states differ by {diff}")
        out[what] = iters

    counters = launch_counters()
    spec, st = _pulled_chain(dev, torch.float32, collide=True)
    _zero_counters(counters)
    got, iters = stepper.init_stabilize(spec, st, cfg, return_iterations=True)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    cspec, cst = _pulled_chain("cpu", torch.float32, collide=True)
    _, citers = stepper.init_stabilize(cspec, cst, cfg, return_iterations=True)
    want64 = stepper.init_stabilize(*_pulled_chain("cpu", torch.float64, collide=True), cfg)
    e = stepper.position_constraint_error(spec, got, cfg)
    e2 = float(e @ e)
    diff = _max_state_diff(got, want64)
    print(f"[{tag}] init_stabilize, chain(6) with its {spec.num_pairs} link pairs, f32: {iters} "
          f"iterations (CPU f32 plain path {citers}); launches {launches} (B2 once a contact "
          f"detection: {iters + 1}); err^2 {e2:.3e} (bound {STAB_TOL:.0e}); against the CPU f64 "
          f"plain path {diff:.3e} (bound {AGREE_BOUND:.0e})")
    check(launches == {"narrowphase": iters + 1}, f"{tag}: launches {launches}, {iters} iterations")
    check(iters == citers, f"{tag} f32: {iters} iterations against {citers}")
    check(e2 <= STAB_TOL, f"{tag} f32: err^2 {e2}")
    check(diff <= AGREE_BOUND, f"{tag} f32: states differ from f64 by {diff}")
    out["b2_launches"] = launches.get("narrowphase", 0)
    return out


def _single_scene_runs(dev, build, cfg, steps, fn, agree_at=AGREE_STEPS):
    """`steps` steps of `fn(spec, state, cfg)` -> state (or (state, cs)) of
    one scene in float32 on the card, B2's launches counted, and the same
    steps' first `agree_at` by the CPU float64 plain path.  Returns (start,
    final, state at agree_at, CPU state at agree_at, launches, ms a step)."""
    from eggshell_tpu_torch.physics.scene import State

    def state_of(out):
        return out if isinstance(out, State) else out[0]

    counters = launch_counters()
    spec, st = build(dev, torch.float32)
    start, at = st, None
    _zero_counters(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        st = state_of(fn(spec, st, cfg))
        if i + 1 == agree_at:
            at = st
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    cspec, cst = build("cpu", torch.float64)
    for _ in range(agree_at):
        cst = state_of(fn(cspec, cst, cfg))
    return spec, start, st, at, cst, launches, ms


def _one_scene_joints_hold(spec, start, final):
    from eggshell_tpu_torch.physics.scene import State

    return joints_hold(spec, State(*(x[None] for x in start)), State(*(x[None] for x in final)))


def phase_implicit_midpoint(dev):
    """`step_implicit_midpoint` (4 fixed-point sweeps) on box_stack(4) at the
    bench's contact capacity (K = 20) and on pendulum_chain6 (K = 4), the
    bench configuration under JACOBI for 120 steps and under DIRECT for 30,
    float32 on the card: p and q within AGREE_BOUND of the CPU float64 plain
    path after AGREE_STEPS steps, the stack standing (or the joints holding)
    at the end, B2 launched once a step where the scene has box pairs and
    no other kernel.  Prints ms a step.  One PGS step at K = 8 is a launch
    check only."""
    from eggshell_tpu_torch.physics import scenes, stepper
    from eggshell_tpu_torch.utils.config import SolverKind

    tag = "implicit_midpoint"
    builds = {"box_stack4": (lambda d, t: scenes.box_stack(4, device=d, dtype=t), 20, stands),
              "pendulum_chain6": (lambda d, t: scenes.pendulum_chain(6, device=d, dtype=t), 4,
                                  _one_scene_joints_hold)}
    out = {}
    for scene, (build, K, physical) in builds.items():
        for solver, steps in (("JACOBI", 120), ("DIRECT", AGREE_STEPS)):
            cfg = bench_cfg().replace(solver=getattr(SolverKind, solver), contact_capacity=K)
            spec, start, final, at, want, launches, ms = _single_scene_runs(
                dev, build, cfg, steps, stepper.step_implicit_midpoint)
            err = {k: float((getattr(at, k).double().cpu() - getattr(want, k)).abs().max())
                   for k in "pq"}
            phys = physical(spec, start, final)
            expect = {"narrowphase": steps} if spec.num_pairs else {}
            print(f"[{tag}] {scene}, {solver}, {steps} steps, f32: {ms:.2f} ms a step; against "
                  f"the CPU f64 plain path after {AGREE_STEPS} steps |dp| {err['p']:.3e}, |dq| "
                  f"{err['q']:.3e} (bound {AGREE_BOUND:.0e}); {phys}; launches {launches}")
            check(err["p"] <= AGREE_BOUND and err["q"] <= AGREE_BOUND,
                  f"{tag} {scene} {solver}: {err}")
            check(launches == expect, f"{tag} {scene} {solver}: launches {launches}")
            out[f"{scene}_{solver}"] = {"ms": ms, "launches": launches}
    # PGS, the port's Python row loop (PERF.md section 5): one step at K = 8
    # as a launch check
    cfg = bench_cfg().replace(solver=SolverKind.PGS, contact_capacity=8)
    counters = launch_counters()
    spec, st = scenes.box_stack(4, device=dev, dtype=torch.float32)
    _zero_counters(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt, _ = stepper.step_implicit_midpoint(spec, st, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    print(f"[{tag}] box_stack4, PGS, K=8, one step, f32: {ms:.2f} ms; launches {launches}; "
          f"finite {bool(torch.isfinite(nxt.p).all())}")
    check(launches == {"narrowphase": 1} and bool(torch.isfinite(nxt.p).all()),
          f"{tag} PGS: launches {launches}")
    out["box_stack4_PGS"] = {"ms": ms, "launches": launches}
    return out


def phase_explicit_euler(dev):
    """`step_explicit_euler` on pendulum_chain6, 100 steps, float32 on the
    card, CFM off (the equality solve exact): the joints hold; against the
    CPU float64 plain path after AGREE_STEPS steps within AGREE_BOUND."""
    from eggshell_tpu_torch.physics import scenes, stepper

    tag = "explicit_euler"
    cfg = bench_cfg().replace(contact_capacity=4, cfm_always=0.0)
    spec, start, final, at, want, launches, ms = _single_scene_runs(
        dev, lambda d, t: scenes.pendulum_chain(6, device=d, dtype=t), cfg, 100,
        stepper.step_explicit_euler)
    err = {k: float((getattr(at, k).double().cpu() - getattr(want, k)).abs().max()) for k in "pq"}
    phys = _one_scene_joints_hold(spec, start, final)
    print(f"[{tag}] pendulum_chain6, 100 steps, f32: {ms:.2f} ms a step; {phys}; against the "
          f"CPU f64 plain path after {AGREE_STEPS} steps |dp| {err['p']:.3e}, |dq| "
          f"{err['q']:.3e} (bound {AGREE_BOUND:.0e}); launches {launches}")
    check(err["p"] <= AGREE_BOUND and err["q"] <= AGREE_BOUND, f"{tag}: {err}")
    check(not launches, f"{tag}: launches {launches}")
    return ms


DIAG_BOUND = 2e-3           # each value within DIAG_BOUND * max(1, |f64 value|)
DIAG_RESIDUAL_BOUND = 1e-2  # |A lambda - b| in f32 with impulses near 500


def _diag_stack(dev, dtype):
    """box_stack(4), box i lowered (i + 1) mm (every interface 1 mm deep),
    sliding along x at 0.1 i m/s and spinning at 0.2 rad/s about z."""
    from eggshell_tpu_torch.physics import scenes

    spec, st = scenes.box_stack(4, device=dev, dtype=dtype)
    n = st.p.shape[0]
    k = torch.arange(1, n + 1, dtype=dtype, device=dev)
    p, v, w = st.p.clone(), st.v.clone(), st.w.clone()
    p[:, 2] -= 1e-3 * k
    v[:, 0] = 0.1 * (k - 1)
    w[:, 2] = 0.2
    return spec, st._replace(p=p, v=v, w=w)


def phase_step_diagnostics(dev):
    """`step_diagnostics` on a sunk, moving box_stack(4) under PGS and
    DIRECT (the bench configuration otherwise, K = 20), float32 on the
    card, every key against the CPU float64 plain path: counts and flags
    equal, DIRECT's pivots equal, every other value within DIAG_BOUND of its
    scale (the residual within DIAG_RESIDUAL_BOUND)."""
    from eggshell_tpu_torch.physics import stepper
    from eggshell_tpu_torch.utils.config import SolverKind

    tag = "step_diagnostics"
    out = {}
    for solver in ("PGS", "DIRECT"):
        cfg = bench_cfg().replace(solver=getattr(SolverKind, solver))
        spec, st = _diag_stack(dev, torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = stepper.step_diagnostics(spec, st, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = stepper.step_diagnostics(*_diag_stack("cpu", torch.float64), cfg)
        check(sorted(got) == sorted(want), f"{tag} {solver}: keys {sorted(got)}")
        worst = 0.0
        for k, w in want.items():
            g = got[k].cpu()
            if w.dtype in (torch.bool, torch.int32, torch.int64):
                check(bool(g == w), f"{tag} {solver} {k}: {g} against {w}")
                continue
            d = abs(float(g) - float(w))
            bound = (DIAG_RESIDUAL_BOUND if k == "solver_residual"
                     else DIAG_BOUND * max(1.0, abs(float(w))))
            check(d <= bound, f"{tag} {solver} {k}: {float(g)} against {float(w)}")
            worst = max(worst, d / bound)
        print(f"[{tag}] {solver}, sunk box_stack4, f32 against the CPU f64 plain path: "
              + ", ".join(f"{k} {float(got[k]):.6g} ({float(want[k]):.6g})" for k in want)
              + f"; largest difference {worst:.3f} of its bound; {ms:.2f} ms a call")
        out[solver] = ms
    return out


FEM_W, FEM_H = 250.0, 3.0988          # bench_fem.py:34-48's WR-12 guide, mm
FEM_SIZES = (0.4, 0.15, 0.12)
FEM_S21_BOUND = 1e-3                  # bench_fem.py's parity gate, complex64
FEM_FIELD_BOUND = 1e-8                # tests/test_block_tridiag.py's gate, complex128
FEM_SWEEP_BOUND = 1e-6
FEM_MODES_BOUND = 1e-2                # bench_fem.py:288's gate


def fem_guide(h):
    from eggshell_tpu_torch.fem.mesher import mesh_structured
    from eggshell_tpu_torch.fem.shape import Rectangle

    W, H = FEM_W, FEM_H
    cd = Rectangle(-W / 2, -H / 2, W / 2, H / 2)
    cd.Port((-W / 2, -H / 2), (-W / 2, H / 2), 1)
    cd.Port((W / 2, -H / 2), (W / 2, H / 2), 2)
    return mesh_structured(cd, (-W / 2, -H / 2), (W, 0), (0, H), h)


def fem_cfg(frequency=75e9):
    from eggshell_tpu_torch.fem.helmholtz import FemConfig

    return FemConfig(type="EZ", frequency=frequency, unit=1e-3, excited_port=1)


def _timed(fn, reps=3):
    """(first call's seconds, mean seconds of `reps` more, last result),
    synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return cold, (time.perf_counter() - t0) / reps, out


def phase_fem_driven(dev):
    """bench_fem.py's driven solve (the WR-12 guide, EZ, 75 GHz, ports 1
    and 2) through `mesh_structured` at h = 0.4, 0.15 and 0.12: the BCR on
    the card in complex64 and complex128 against the JAX package's host
    solve, SciPy's SuperLU, in complex128: |S21| within 1e-3 in complex64
    and the field within 1e-8 of its scale in complex128.  Prints solves/s,
    cold (the first call) and warm (3 more), and the plan's host seconds."""
    from eggshell_tpu_torch.fem.helmholtz import make_driven_fn, mesh_tensors

    tag = "fem_driven"
    cfg = fem_cfg()
    out = {}
    with torch.no_grad():
        for h in FEM_SIZES:
            mesh = fem_guide(h)
            fs, _ = make_driven_fn(mesh, cfg, solver="sparse")
            hargs = mesh_tensors(mesh, torch.complex128, "cpu")
            t0 = time.perf_counter()
            u_ref, s_ref = fs(*hargs, cfg.k0)
            t_host = time.perf_counter() - t0
            s21_ref = abs(complex(s_ref[1, 0]))
            entry = {"nodes": mesh.num_points, "superlu_host_ms": t_host * 1e3}
            for dtype, name in ((torch.complex64, "c64"), (torch.complex128, "c128")):
                t0 = time.perf_counter()
                fn, plan = make_driven_fn(mesh, cfg, solver="bcr", dtype=dtype)
                t_plan = time.perf_counter() - t0
                args = mesh_tensors(mesh, dtype, dev)
                cold, warm, (u, s) = _timed(lambda: fn(*args, cfg.k0))
                s21 = abs(complex(s[1, 0]))
                ferr = float((u.cpu().to(torch.complex128) - u_ref).abs().max()
                             / u_ref.abs().max())
                bs = plan.bcr_structure
                print(f"[{tag}] h={h}, {mesh.num_points} nodes, bcr {name} on the card (blocks "
                      f"{bs.num_blocks} x {bs.block_size}): cold {cold * 1e3:.2f} ms, warm "
                      f"{warm * 1e3:.2f} ms, {1 / warm:.2f} solves/s warm; plan {t_plan:.2f} s "
                      f"on the host; |S21| {s21:.7f} against host SuperLU c128 {s21_ref:.7f} "
                      f"({t_host * 1e3:.1f} ms); field {ferr:.3e} of its scale")
                if name == "c64":
                    check(abs(s21 - s21_ref) <= FEM_S21_BOUND,
                          f"{tag} h={h} c64: |S21| {s21} against {s21_ref}")
                else:
                    check(ferr <= FEM_FIELD_BOUND, f"{tag} h={h} c128: field {ferr}")
                entry[name] = {"cold_ms": cold * 1e3, "warm_ms": warm * 1e3, "s21": s21,
                               "field_err": ferr}
            out[h] = entry
    return out


def phase_fem_sweep(dev):
    """bench_fem.py:165-250's sweep: F = 16 frequencies from 70 to 80 GHz on
    the guide at h = 0.4, complex128.  `make_driven_fn(solver="bcr")`'s
    function takes the 16 k0 as one batch (one batched BCR on the card);
    each S21 within 1e-6 of its single-frequency solve.  `fields.solve_sweep`
    runs as the JAX package runs it (above 1200 nodes its plan takes the
    host SuperLU, one frequency after another), its S21 within 1e-6 too."""
    from eggshell_tpu_torch.fem import fields
    from eggshell_tpu_torch.fem.helmholtz import C0, make_driven_fn, mesh_tensors

    tag = "fem_sweep"
    cfg = fem_cfg()
    mesh = fem_guide(0.4)
    freqs = np.linspace(70e9, 80e9, 16)
    with torch.no_grad():
        fn, _ = make_driven_fn(mesh, cfg, solver="bcr")
        args = mesh_tensors(mesh, torch.complex128, dev)
        k0s = torch.tensor(2 * np.pi * freqs / C0 * cfg.unit, dtype=torch.float64, device=dev)
        cold, warm, (u, s) = _timed(lambda: fn(*args, k0s))
        single = torch.stack([fn(*args, k)[1][1, 0] for k in k0s])
        err = float((s[:, 1, 0] - single).abs().max())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, sp = fields.solve_sweep(mesh, cfg, freqs, device=dev)
        t_sweep = time.perf_counter() - t0
    err_sweep = float(np.abs(sp[2] - s[:, 1, 0].cpu().numpy()).max())
    print(f"[{tag}] {mesh.num_points} nodes, F=16, c128: batched bcr on the card cold "
          f"{cold * 1e3:.2f} ms, warm {warm * 1e3:.2f} ms ({16 / warm:.1f} frequency solves/s); "
          f"S21 against each single-frequency solve {err:.3e} (bound {FEM_SWEEP_BOUND:.0e}); "
          f"fields.solve_sweep (host SuperLU, one frequency after another) {t_sweep * 1e3:.1f} "
          f"ms ({16 / t_sweep:.1f}/s), its S21 within {err_sweep:.3e}; |S21| from "
          f"{float(s[:, 1, 0].abs().min()):.6f} to {float(s[:, 1, 0].abs().max()):.6f}")
    check(err <= FEM_SWEEP_BOUND, f"{tag}: batched S21 differs by {err}")
    check(err_sweep <= FEM_SWEEP_BOUND, f"{tag}: solve_sweep's S21 differs by {err_sweep}")
    return {"warm_ms": warm * 1e3, "cold_ms": cold * 1e3, "sweep_host_ms": t_sweep * 1e3}


def phase_fem_modes(dev):
    """bench_fem.py's eigenmodes: Rectangle(0, 0, 2, 1) through `mesh_shape`
    at 0.012, 6 modes: "shift_invert" (the BCR as its factorization) on the
    card against the JAX package's host solve, SciPy's ARPACK: the largest
    relative eigenvalue error below 1e-2; "lobpcg" printed, not gated (the
    reference measured its failure on modes 5 and 6, bench_fem.py:255-262).
    Prints cold and warm ms."""
    from eggshell_tpu_torch.fem.helmholtz import solve_modes
    from eggshell_tpu_torch.fem.mesher import mesh_shape
    from eggshell_tpu_torch.fem.shape import Rectangle

    tag = "fem_modes"
    t0 = time.perf_counter()
    mesh = mesh_shape(Rectangle(0.0, 0.0, 2.0, 1.0), 0.012)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref, _ = solve_modes(mesh, num_modes=6, device=dev)
    t_arpack = time.perf_counter() - t0
    out = {"nodes": mesh.num_points, "arpack_ms": t_arpack * 1e3}
    for method in ("shift_invert", "lobpcg"):
        cold, warm, (vals, _) = _timed(lambda: solve_modes(mesh, num_modes=6, method=method,
                                                           device=dev), reps=1)
        rel = float(np.max(np.abs((vals - ref) / ref)))
        print(f"[{tag}] {mesh.num_points} nodes (mesh {t_mesh:.1f} s), 6 modes: {method} on the "
              f"card cold {cold * 1e3:.1f} ms, warm {warm * 1e3:.1f} ms; max relative error "
              f"against host ARPACK ({t_arpack * 1e3:.1f} ms) {rel:.3e}"
              + (f" (bound {FEM_MODES_BOUND:.0e})" if method == "shift_invert" else
                 " (not gated)") + f"; eigenvalues {np.round(vals, 4).tolist()}")
        if method == "shift_invert":
            check(rel < FEM_MODES_BOUND, f"{tag}: shift_invert error {rel}")
        out[method] = {"cold_ms": cold * 1e3, "warm_ms": warm * 1e3, "max_rel_err": rel}
    return out


# bench_fem.py:351-373's 3D cell (n = 128, 50 steps, CPML depth 8 on every
# wall, dx = 1, float32) and a scale row at n = 256
FDTD3D_ROWS = ((128, 50), (256, 20))
# the bound's bytes: 6 field and 12 psi arrays, each read and written once
# a step, float32
FDTD3D_BYTES_PER_CELL = 36 * 4
FDTD3D_CPML_BOUND = 1e-4       # tests/test_fdtd.py:156-188's gate
FDTD3D_AGREE_BOUND = 1e-4      # card f32 against CPU f64, of the field's scale


def _fdtd3d_field(n, dev, dtype=torch.float32, seed=SEED):
    from eggshell_tpu_torch.fem.fdtd import Field3D

    g = torch.Generator("cpu").manual_seed(seed)
    return Field3D(*(torch.randn((n, n, n), generator=g, dtype=torch.float64).to(dev, dtype)
                     for _ in range(6)))


def _gauss_source(dt):
    t0, tau = 20 * dt, 6 * dt
    return lambda t: torch.exp(-((t - t0) ** 2) / (2 * tau ** 2))


def _fdtd3d_agreement(dev):
    """n = 32, CPML depth 6 on every wall, PEC voxels (a slab with an
    aperture and 2 % random voxels), an eps grid in [1, 4], a soft source
    on Ez and a probe on Hy, 100 steps: card f32 against the CPU f64 plain
    path.  Returns (max |d| over fields, psi and trace, the f64 field's max
    |value|)."""
    from eggshell_tpu_torch.fem.fdtd import courant_dt, init_3d, make_cpml_3d, simulate_3d

    n, steps = 32, 100
    dx = 1.0 / (n - 1)
    dt = courant_dt(dx, 3, 0.9)
    rng = np.random.default_rng(SEED)
    eps = rng.uniform(1.0, 4.0, (n, n, n))
    pec = rng.uniform(size=(n, n, n)) < 0.02
    pec[2 * n // 3, :, :] = True
    pec[2 * n // 3, 12:20, 12:20] = False
    runs = []
    for where, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float64)):
        cpml, psi = make_cpml_3d((n,) * 3, dt, dx, depth=6, dtype=dtype, device=where)
        runs.append(simulate_3d(
            init_3d(n, dtype, device=where), steps, dt, dx,
            torch.tensor(eps, dtype=dtype, device=where), torch.tensor(pec, device=where), cpml,
            psi, source_ijk=(n // 3, n // 2, n // 2), source_fn=_gauss_source(dt),
            probe_ijk=(n // 2, n // 2 + 3, n // 2), probe_component="hy"))
    card, cpu = runs
    err = max(float((a.double().cpu() - b).abs().max())
              for a, b in zip((*card[0], *card[1], card[2]), (*cpu[0], *cpu[1], cpu[2])))
    return err, max(float(a.abs().max()) for a in cpu[0])


def phase_fdtd3d(dev):
    """The 3D FDTD (`fem.fdtd.step_3d`, plain torch: the JAX package's step
    is plain XLA, no Pallas kernel) on FDTD3D_ROWS: `simulate_3d` timed on
    the synchronised host clock after a warm-up (cell-steps/s, ms a step),
    every launch counter 0 just before and after (the step launches no
    hand-written kernel); one step's device ms, device operations and busy
    share from a torch.profiler window of 10 steps (L2 not flushed); the
    bound, 144 bytes a cell a step over 3.35 TB/s, and the times over it.
    Gates: tests/test_fdtd.py:156-188's CPML case (n = 48, 400 steps,
    depth 10): the magnetic energy with CPML over that with PEC walls below
    1e-4; and `_fdtd3d_agreement` within 1e-4 of the field's scale."""
    from eggshell_tpu_torch.fem.fdtd import (PML_ALL, courant_dt, init_3d, make_cpml_3d,
                                             simulate_3d, step_3d)
    from eggshell_tpu_torch.utils.profiling import device_window

    tag = "fdtd3d"
    counters = launch_counters()
    out = {}
    for n, steps in FDTD3D_ROWS:
        dt = courant_dt(1.0, 3)
        f = _fdtd3d_field(n, dev)
        cpml, psi = make_cpml_3d((n,) * 3, dt, 1.0, pml=PML_ALL, depth=8, device=dev)
        simulate_3d(f, 2, dt, 1.0, cpml=cpml, psi=psi)
        _zero_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, psi_out, _ = simulate_3d(f, steps, dt, 1.0, cpml=cpml, psi=psi)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        check(not launches, f"{tag} n={n}: kernel launches {launches}")
        check(all(bool(torch.isfinite(a).all()) for a in (*fin, *psi_out)),
              f"{tag} n={n}: not finite")
        w = device_window(lambda: step_3d(f, dt, 1.0, cpml=cpml, psi=psi), 10)
        step_ms = wall / steps * 1e3
        b = bound(n ** 3 * FDTD3D_BYTES_PER_CELL, 0.0)
        out[n] = {"cell_steps_per_s": n ** 3 * steps / wall, "ms_a_step": step_ms,
                  "device_ms": w["device_ms"], "device_ops": w["launches"], "busy": w["busy"],
                  "bound_ms": b["bound_ms"]}
        print(f"[{tag}] n={n}, CPML depth 8 on every wall, f32, {steps} steps: {wall:.4f} s, "
              f"{n ** 3 * steps / wall:.1f} cell-steps/s, {step_ms:.4f} ms a step (host clock); "
              f"a step {w['device_ms']:.4f} ms of device time in {w['launches']:.1f} device "
              f"operations, busy {100 * w['busy']:.1f} % (profiler window); device time over "
              f"the unprofiled step {100 * w['device_ms'] / step_ms:.1f} %; bound "
              f"{b['bound_ms']:.4f} ms ({b['bytes']} bytes at 3.35 TB/s): device "
              f"{w['device_ms'] / b['bound_ms']:.2f}x, host clock {step_ms / b['bound_ms']:.2f}x "
              f"the bound; no kernel launched")
        del f, cpml, psi, fin, psi_out
        torch.cuda.empty_cache()

    n, steps = 48, 400
    dx = 1.0 / (n - 1)
    dt = courant_dt(dx, 3, 0.9)
    mid = (n // 2,) * 3
    pec_walls, _ = simulate_3d(init_3d(n, device=dev), steps, dt, dx, source_ijk=mid,
                               source_fn=_gauss_source(dt))
    cpml, psi = make_cpml_3d((n,) * 3, dt, dx, pml=PML_ALL, depth=10, device=dev)
    absorbed, _, _ = simulate_3d(init_3d(n, device=dev), steps, dt, dx, cpml=cpml, psi=psi,
                                 source_ijk=mid, source_fn=_gauss_source(dt))

    def h_energy(f):
        return sum(float(torch.sum(a.double() ** 2)) for a in (f.hx, f.hy, f.hz))

    ratio = h_energy(absorbed) / h_energy(pec_walls)
    err, scale = _fdtd3d_agreement(dev)
    print(f"[{tag}] tests/test_fdtd.py's CPML case (n=48, 400 steps, depth 10) on the card: "
          f"magnetic energy CPML / PEC walls {ratio:.3e} (bound {FDTD3D_CPML_BOUND:.0e}); n=32 "
          f"with CPML, PEC voxels, an eps grid, a soft source and a probe, 100 steps, card f32 "
          f"against CPU f64 plain path: max |d| {err:.3e} of the field's scale {scale:.3e} "
          f"({err / scale:.3e}, bound {FDTD3D_AGREE_BOUND:.0e})")
    check(ratio < FDTD3D_CPML_BOUND, f"{tag}: CPML energy ratio {ratio}")
    check(err <= FDTD3D_AGREE_BOUND * scale, f"{tag}: card against CPU f64 {err} of {scale}")
    out["cpml_ratio"], out["agreement"] = ratio, err / scale
    return out


def phase_sharded(dev):
    """`parallel.mesh` on a world of one rank (NCCL on a `HashStore`, made
    here and destroyed at the end): `sharded_rollout` of the bench
    configuration (box_stack4, B = 4096, H = 50) against `rollout_batched`,
    and `sharded_mppi_update` on the `[mpc_living_room]` problem against
    `mppi_update_batched` from the same generator state, each in turns
    local, sharded, sharded, local; each call with every launch counter 0
    just before, the counts read just after: every fused kernel H times, and
    the sharded call's counts the local call's.  Each must give the local
    bits (at world 1 the sharded entries compute the local sums in their
    order).  Then `sharded_mean_cost` of the update's costs, and
    `dryrun_multichip(1)`.  One card shows no traffic between cards."""
    import torch.distributed as dist

    from eggshell_tpu_torch.mpc.sampling import mppi_update_batched
    from eggshell_tpu_torch.parallel import mesh as pmesh
    from eggshell_tpu_torch.parallel.rollout import rollout_batched
    from eggshell_tpu_torch.physics import scenes

    tag = "sharded"
    counters = launch_counters()

    def nonzero(launches):
        return {k: v for k, v in launches.items() if v}

    mesh = pmesh.make_mesh(device="cuda")
    check(mesh.size() == 1 and dist.get_backend() == "nccl", f"{tag}: mesh {mesh}")
    try:
        spec, states, cfg = scenes.baseline_batch("box_stack4", B_SLICE, device=dev)
        shard = pmesh.shard_batch(mesh, states)

        def local_rollout():
            return rollout_batched(spec, states, cfg, H_SLICE)

        def sharded_rollout():
            return pmesh.gather(mesh, pmesh.sharded_rollout(spec, shard, cfg, H_SLICE, mesh))

        spec_m, st, cfg_m, cost = mpc_problem(dev)
        mean = torch.zeros((MPC_H, 6), device=dev)

        def update(fn, *extra):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            return fn(spec_m, st, cfg_m, mean, gen, cost, *extra, controlled_body=MPC_BODY,
                      num_samples=MPC_S, noise_sigma=MPC_SIGMA, temperature=MPC_T,
                      noise_mode="constant")

        def local_update():
            return update(mppi_update_batched)

        def sharded_update():
            return update(pmesh.sharded_mppi_update, mesh)

        res = {}
        for what, calls, per_step in (("rollout", (local_rollout, sharded_rollout), H_SLICE),
                                      ("mppi", (local_update, sharded_update), MPC_H)):
            want = {name: per_step if name in FUSED_PATH else 0 for name in counters}
            for call in calls:
                call()
            times, outs, launches = {c: [] for c in calls}, {}, {}
            for call in (calls[0], calls[1], calls[1], calls[0]):
                _zero_counters(counters)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = call()
                torch.cuda.synchronize()
                times[call].append(time.perf_counter() - t0)
                launches[call] = {name: fn.launches for name, fn in counters.items()}
                outs[call] = o
            same = all(torch.equal(a, b) for a, b in zip(outs[calls[0]], outs[calls[1]]))
            rate = {c: len(times[c]) / sum(times[c]) for c in calls}
            res[what] = (rate, same, launches[calls[1]], outs[calls[1]])
            unit = "rollouts/s" if what == "rollout" else "MPC solves/s"
            scale = B_SLICE if what == "rollout" else 1
            print(f"[{tag}] {what}: local {', '.join(f'{scale / t:.2f}' for t in times[calls[0]])}"
                  f", sharded {', '.join(f'{scale / t:.2f}' for t in times[calls[1]])} {unit} "
                  f"(mean {scale * rate[calls[0]]:.2f} and {scale * rate[calls[1]]:.2f}; sharded "
                  f"/ local {rate[calls[1]] / rate[calls[0]]:.3f}); the local bits: {same}; "
                  f"launches, local {nonzero(launches[calls[0]])}, sharded "
                  f"{nonzero(launches[calls[1]])}")
            check(same, f"{tag} {what}: sharded differs from local")
            for call in calls:
                check(launches[call] == want, f"{tag} {what} launches {launches[call]}, "
                                              f"expected {want}")
        costs = res["mppi"][3][1]
        mc = float(pmesh.sharded_mean_cost(costs, mesh))
        rel = abs(mc - float(costs.double().mean())) / abs(float(costs.double().mean()))
        dry = pmesh.dryrun_multichip(1)
        print(f"[{tag}] sharded_mean_cost of the update's {MPC_S} costs {mc:.6f}, relative to "
              f"the f64 mean {rel:.3e} (bound 1e-6); dryrun_multichip(1) {dry}")
        check(rel <= 1e-6, f"{tag}: sharded_mean_cost {rel}")
    finally:
        dist.destroy_process_group()
    return {"rollout_launches": res["rollout"][2], "mppi_launches": res["mppi"][2]}


OPT_S21_BOUND = 1e-3           # bench_fem.py's parity gate, complex64
OPT_HEIGHTS = (2.8, 3.4)       # the guide's height (mm) as the model's parameter


def phase_optimize(dev):
    """`opt` on tests/test_toolkit.py:26-87's problems with float64 tensors
    on the card, held to that file's tolerances: Levenberg-Marquardt
    (Rosenbrock residuals, the curve fit; its iterations and host reads,
    the first call timed apart),
    Nelder-Mead, `random_search` (4,096 samples, one vmap on the card) and
    `OptimizerFactory`.  Then a `models.Model` whose builder meshes
    bench_fem.py:34-48's WR-12 guide (h = 0.4) at the height its one
    `Parameter` gives (2.8 to 3.4 mm) and whose solver is the BCR driven
    solve on the card in complex64, its output |S21|: `sweep` of 8 heights,
    `optimize("random_search", num_samples=16)`, every output within 1e-3 of
    the host SuperLU solve of the same mesh, a repeated `run` answered from
    the cache, evaluations/s.  No hand-written kernel may launch.  Then
    `native.solve_box_lcp_batch` (host, its g++ build timed apart) on
    tests/test_native_lcp.py's certification and batch problems, every
    solution certified."""
    from eggshell_tpu_torch import native, opt
    from eggshell_tpu_torch.fem.helmholtz import make_driven_fn, mesh_tensors
    from eggshell_tpu_torch.fem.mesher import mesh_structured
    from eggshell_tpu_torch.fem.shape import Rectangle
    from eggshell_tpu_torch.models import Model, Parameter
    from eggshell_tpu_torch.oracle.lcp_oracle import check_lcp_solution

    tag = "optimize"
    counters = launch_counters()
    _zero_counters(counters)

    def t(x):
        return torch.tensor(x, dtype=torch.float64, device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    tt = torch.linspace(0, 1, 20, dtype=torch.float64, device=dev)
    problems = {
        "rosenbrock": (lambda x: torch.stack([1.0 - x[0], 10.0 * (x[1] - x[0] ** 2)]),
                       [-1.2, 1.0], 100, [1.0, 1.0]),
        "curve_fit": (lambda p: p[0] * torch.exp(p[1] * tt) - 2.0 * torch.exp(-1.5 * tt),
                      [1.0, 0.0], 50, [2.0, -1.5]),
    }
    for name, (fn, x0, iters, want) in problems.items():
        _, first_ms = timed(lambda: opt.levenberg_marquardt(fn, t(x0), opt.LMOptions(iters)))
        res, ms = timed(lambda: opt.levenberg_marquardt(fn, t(x0), opt.LMOptions(iters)))
        err = float((res.x - t(want)).abs().max())
        reads = res.iterations + (res.iterations < iters)
        print(f"[{tag}] levenberg_marquardt {name} on {res.x.device}: {res.iterations} "
              f"iterations, {reads} host reads, {ms:.2f} ms (the first call {first_ms:.2f} ms: "
              f"the process's first float64 solve sets up the solver library); |x - x*| "
              f"{err:.3e} (bound 1e-6)")
        check(err <= 1e-6, f"{tag} LM {name}: {err}")

    def quad(x):
        return (x[0] - 3.0) ** 2 + 2.0 * (x[1] + 1.0) ** 2

    res, ms = timed(lambda: opt.nelder_mead(quad, t([0.0, 0.0]), max_iterations=400))
    err = float((res.x - t([3.0, -1.0])).abs().max())
    print(f"[{tag}] nelder_mead: {int(res.iterations)} of 400 iterations, no host read, "
          f"{ms:.2f} ms; |x - x*| {err:.3e} (bound 1e-3)")
    check(err <= 1e-3, f"{tag} nelder_mead: {err}")

    def bowl(x):
        return torch.sum((x - 0.5) ** 2)

    gen = torch.Generator(dev).manual_seed(SEED)
    res, ms = timed(lambda: opt.random_search(bowl, t([-1.0, -1.0]), t([1.0, 1.0]), gen,
                                              num_samples=4096))
    print(f"[{tag}] random_search, 4096 samples in one vmap on the card: f {float(res.fun):.3e} "
          f"(bound 1e-2), {ms:.2f} ms")
    check(float(res.fun) < 1e-2, f"{tag} random_search: {float(res.fun)}")

    def target(x):
        return torch.sum((x - 2.0) ** 2)

    o = opt.OptimizerFactory.create("nelder_mead", target, max_iterations=300, device=dev)
    o.initialize(np.zeros(2))
    err = float(np.abs(o.best()[0] - 2.0).max())
    o = opt.OptimizerFactory.create("random_search", target, device=dev,
                                    bounds=(np.zeros(2), np.full(2, 4.0)))
    o.initialize(np.zeros(2))
    print(f"[{tag}] OptimizerFactory nelder_mead |x - x*| {err:.3e} (bound 1e-3), "
          f"random_search f {o.best()[1]:.3e} (bound 0.1)")
    check(err <= 1e-3 and o.best()[1] < 0.1, f"{tag} OptimizerFactory: {err}, {o.best()}")

    cfg = fem_cfg()
    builds, solved = [], []

    def builder(params):
        W, H = FEM_W, params["height"]
        builds.append(H)
        cd = Rectangle(-W / 2, -H / 2, W / 2, H / 2)
        cd.Port((-W / 2, -H / 2), (-W / 2, H / 2), 1)
        cd.Port((W / 2, -H / 2), (W / 2, H / 2), 2)
        return mesh_structured(cd, (-W / 2, -H / 2), (W, 0), (0, H), 0.4)

    def solver(mesh):
        with torch.no_grad():
            fn, _ = make_driven_fn(mesh, cfg, solver="bcr", dtype=torch.complex64)
            _, s = fn(*mesh_tensors(mesh, torch.complex64, dev), cfg.k0)
        solved.append({"mesh": mesh, "s21": abs(complex(s[1, 0]))})
        return solved[-1]

    model = Model(builder, [Parameter("height", *OPT_HEIGHTS, default=FEM_H)], solver=solver,
                  output=lambda sol: sol["s21"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swept = model.sweep("height", np.linspace(*OPT_HEIGHTS, 8).tolist())
    best, fval = model.optimize("random_search", num_samples=16)
    seconds = time.perf_counter() - t0
    evaluations = len(builds)
    model.run(best)
    model.run({"height": FEM_H})
    model.run({"height": FEM_H})
    cached = len(builds) == evaluations + 1
    worst = 0.0
    for sol in solved:
        fs, _ = make_driven_fn(sol["mesh"], cfg, solver="sparse")
        with torch.no_grad():
            _, s_ref = fs(*mesh_tensors(sol["mesh"], torch.complex128, "cpu"), cfg.k0)
        worst = max(worst, abs(sol["s21"] - abs(complex(s_ref[1, 0]))))
    nodes = sorted({sol["mesh"].num_points for sol in solved})
    print(f"[{tag}] Model over the WR-12 guide's height {OPT_HEIGHTS} mm (h=0.4, {nodes[0]} to "
          f"{nodes[-1]} nodes), BCR c64 on the card: sweep of 8 |S21| "
          f"{np.round(swept, 6).tolist()}; random_search of 16: best height "
          f"{best['height']:.4f} mm, |S21| {fval:.6f}; {evaluations} evaluations (mesh, plan and "
          f"solve each) in {seconds:.2f} s, {evaluations / seconds:.2f} evaluations/s; a repeated "
          f"run from the cache: {cached}; every |S21| against host SuperLU c128 of its mesh: max "
          f"|d| {worst:.3e} (bound {OPT_S21_BOUND:.0e})")
    check(cached, f"{tag}: a repeated run was rebuilt")
    check(worst <= OPT_S21_BOUND, f"{tag}: |S21| {worst} from the host SuperLU")
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    check(not launches, f"{tag}: kernel launches {launches}")

    t0 = time.perf_counter()
    native.build()
    print(f"[{tag}] native library ({native.library_path().name}) built or found in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    cert = []
    for _ in range(100):
        m = rng.uniform(-1, 1, (50, 50))
        cert.append((m.T @ m + 5.0 * np.eye(50), rng.uniform(-1, 1, 50),
                     np.full(50, -rng.uniform(0.1, 1.0)), np.full(50, rng.uniform(0.1, 1.0))))
    rng = np.random.default_rng(2)
    mats = [rng.uniform(-1, 1, (20, 20)) for _ in range(32)]
    batch = (np.stack([m.T @ m + 2.0 * np.eye(20) for m in mats]), rng.uniform(-1, 1, (32, 20)),
             np.full((32, 20), -1.0), np.full((32, 20), 1.0))
    for name, (A, b, lo, hi) in (("certification", tuple(np.stack(c) for c in zip(*cert))),
                                 ("batch", batch)):
        t0 = time.perf_counter()
        x, w, ok = native.solve_box_lcp_batch(A, b, lo, hi)
        ms = (time.perf_counter() - t0) * 1e3
        good = sum(bool(ok[k]) and check_lcp_solution(A[k], b[k], x[k], w[k],
                                                      np.zeros(A.shape[1], bool), lo[k], hi[k],
                                                      1e-7) for k in range(A.shape[0]))
        print(f"[{tag}] native.solve_box_lcp_batch, {name}: {A.shape[0]} problems of n = "
              f"{A.shape[1]} in {ms:.2f} ms on the host, {good} certified (KKT within 1e-7)")
        check(good == A.shape[0], f"{tag} native {name}: {good} of {A.shape[0]} certified")
    return {"evaluations_per_s": evaluations / seconds, "s21_err": worst}


# ---------------------------------------------------------------------------
# The last slice: the float64 box-pair routing (C3), the utils tail, the
# ported examples and the viewer.

C3_BOUND = 1e-10            # card f64 against the CPU f64 plain path


def _sunk_stack(dev, dtype, sink):
    """box_stack(3), every box moved `sink` m down (the bottom one into the
    floor)."""
    from eggshell_tpu_torch.physics import scenes

    spec, st = scenes.box_stack(3, device=dev, dtype=dtype)
    return spec, st._replace(p=st.p - torch.tensor([0.0, 0.0, sink], dtype=dtype, device=dev))


def phase_c3_float64(dev):
    """ROADMAP C3: `init_stabilize` of box_stack(3) (its two box pairs and
    the ground) in float64 on the card, as built and sunk 1 mm into the
    floor: the box pairs take the plain narrowphase, B2's counter stays
    unmoved, the CPU float64 plain path's iteration count, the state within
    1e-10; contact_kernel=True in float64 raises ValueError.  Then float32
    as built (sunk, float32 J J^T is singular: `[stabilize]`): B2 once a
    contact detection, a launch count only (as built the stack needs no
    iteration, so the state is the input's)."""
    from eggshell_tpu_torch.physics import stepper
    from eggshell_tpu_torch.utils.config import SimConfig

    tag = "c3_float64"
    cfg = SimConfig(contact_capacity=24)
    counters = launch_counters()
    for sink in (0.0, 1e-3):
        _zero_counters(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, iters = stepper.init_stabilize(*_sunk_stack(dev, torch.float64, sink), cfg,
                                            return_iterations=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        want, citers = stepper.init_stabilize(*_sunk_stack("cpu", torch.float64, sink), cfg,
                                              return_iterations=True)
        diff = _max_state_diff(got, want)
        print(f"[{tag}] init_stabilize, box_stack(3) sunk {sink * 1e3:g} mm, f64 on the card: "
              f"{iters} iterations ({citers} on the CPU plain path), {dt:.3f} s; states within "
              f"{diff:.3e} (bound {C3_BOUND:.0e}); kernel launches {launches} (none allowed)")
        check(not launches, f"{tag} sunk {sink}: launches {launches}")
        check(iters == citers, f"{tag} sunk {sink}: {iters} iterations against {citers}")
        check(diff <= C3_BOUND, f"{tag} sunk {sink}: states differ by {diff}")
    try:
        stepper.init_stabilize(*_sunk_stack(dev, torch.float64, 0.0),
                               cfg.replace(contact_kernel=True))
        check(False, f"{tag}: contact_kernel=True in float64 did not raise")
    except ValueError as e:
        print(f"[{tag}] contact_kernel=True in float64 raises ValueError: {str(e)[:80]}...")
    _zero_counters(counters)
    spec, st = _sunk_stack(dev, torch.float32, 0.0)
    _, iters = stepper.init_stabilize(spec, st, cfg, return_iterations=True)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    print(f"[{tag}] init_stabilize, box_stack(3) as built, f32: {iters} iterations; launches "
          f"{launches} (B2 once a contact detection: {iters + 1}); a launch count only (B2 is "
          f"held to its plain version in [viewer] and [examples_physics])")
    check(launches == {"narrowphase": iters + 1}, f"{tag} f32: launches {launches}")
    return launches.get("narrowphase", 0)


def phase_utils_tail(dev):
    """`utils.trace.scope` around one fused bench step (B = 4096) inside a
    torch.profiler window: the label is one of the profile's events, and
    the host Trace counts it.  Then a
    checkpoint round trip (`utils.checkpoint`) of a card State of the bench
    batch: restored with the card state as target, every field on the card
    with the same bits."""
    from eggshell_tpu_torch.physics.scene import State
    from eggshell_tpu_torch.physics.scenes import baseline_batch
    from eggshell_tpu_torch.physics.stepper import step_ode_batched
    from eggshell_tpu_torch.utils import checkpoint, trace

    tag = "utils_tail"
    spec, states, cfg = baseline_batch("box_stack4", B_SLICE, device=dev)
    step_ode_batched(spec, states, cfg)                     # warm
    torch.cuda.synchronize()
    counters = launch_counters()
    _zero_counters(counters)
    trace.trace_start()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.scope("eggshell.fused_step"):
            nxt = step_ode_batched(spec, states, cfg)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    ev = {e.key: e for e in prof.key_averages()}
    check("eggshell.fused_step" in ev, f"{tag}: label not in the profile ({sorted(ev)[:6]})")
    label = ev["eggshell.fused_step"]
    host = trace.timings()["eggshell.fused_step"]
    print(f"[{tag}] scope('eggshell.fused_step') around one fused step, B={B_SLICE}: in the "
          f"profile, {label.count} event; Trace count {host[2]}, host total "
          f"{host[1] / 1e3:.4f} ms; launches {launches}")
    check(host[2] == 1 and label.count == 1, f"{tag}: counts {host[2]}, {label.count}")
    check(set(launches) == set(FUSED_PATH) and set(launches.values()) == {1},
          f"{tag}: launches {launches}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(path, {"state": nxt, "step": 1})
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.restore_checkpoint(path, {"state": nxt, "step": 0})
        t_load = time.perf_counter() - t0
        size = os.path.getsize(path)
    same = all(torch.equal(a, b) for a, b in zip(back["state"], nxt))
    on_card = all(x.device == dev for x in back["state"])
    print(f"[{tag}] checkpoint of the card State ({size} bytes): save {t_save * 1e3:.1f} ms, "
          f"restore to the card {t_load * 1e3:.1f} ms; a State again {type(back['state']) is State}"
          f", on the card {on_card}, the same bits {same}, step {back['step']}")
    check(same and on_card and type(back["state"]) is State and back["step"] == 1,
          f"{tag}: checkpoint round trip")


# The examples' own widths; the depth each runs here where its default
# does not fit the phase's two minutes of the card, and the default.
EX_CHAIN_STEPS = (4, 1500)
EX_BOX_STEPS = (10, 1200)
EX_PUSH = dict(num_samples=128, horizon=40)   # one MPPI update of the default 60 x 2
EX_LIVING_STEPS = (12, 30)                    # tests/test_examples_physics.py:30
EX_LIVING_SAMPLES = 256


def _run_counted(counters, fn):
    """(result, seconds, launches) of fn() with the counters from 0."""
    _zero_counters(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k: f.launches for k, f in counters.items()
                                           if f.launches}


def phase_examples_physics(dev):
    """The five physics and FDTD examples of `eggshell_tpu_torch.examples`
    through their entries with render=False, at their scripts' widths,
    float32: fdtd_aperture at n = 160 (260 steps of B8, default depth),
    chain_swing's chain(10) under PGS (60 sweeps), box_drop (PGS, K = 16),
    push_mpc (its SamplingMPC, 128 samples, horizon 40, PGS 40 sweeps, 10
    substeps: one MPPI update, a control step being 2) and living_room_mpc
    (`settle`, then `control` at 256 samples, H = 25, 10 substeps, JACOBI).
    Each prints its widths, its depth against its default, the seconds a
    step and its launches; the outcome asserts of
    tests/test_examples_physics.py:25-80 that the depth allows are checked.
    B2 is held to its plain version on living_room_mpc's settled room, one
    scene and S = 256.  Returns (launches by example, B2's max abs error)."""
    from eggshell_tpu_torch.examples import (box_drop, chain_swing, fdtd_aperture,
                                             living_room_mpc, push_mpc)
    from eggshell_tpu_torch.parallel.mesh import make_mesh

    tag = "examples_physics"
    counters = launch_counters()

    (leak, ez), sec, launches = _run_counted(
        counters, lambda: fdtd_aperture.main(render=False, n=160, device=dev))
    steps = int(160 * 260 / 160)
    n = ez.shape[0]
    beam = np.abs(ez[n // 2 - 8: n // 2 + 8, n // 2 + 4:]).max()
    shadow = max(np.abs(ez[: n // 6, n // 2 + 4:]).max(), np.abs(ez[-n // 6:, n // 2 + 4:]).max())
    print(f"[{tag}] fdtd_aperture n=160, {steps} steps (the default): {sec:.3f} s, "
          f"{sec / steps * 1e3:.4f} ms a step; launches {launches}; leak {leak:.4f} (> 1e-3), "
          f"shadow/beam {shadow / beam:.4f} (< 0.5)")
    check(launches == {"fdtd2d": steps}, f"{tag} fdtd_aperture: launches {launches}")
    check(np.isfinite(ez).all() and leak > 1e-3 and shadow < 0.5 * beam,
          f"{tag} fdtd_aperture: leak {leak}, shadow {shadow}, beam {beam}")
    out = {"fdtd_aperture": launches}

    cut, full = EX_CHAIN_STEPS
    (final, traj), sec, launches = _run_counted(
        counters, lambda: chain_swing.main(steps=cut, render=False, device=dev))
    p = traj.p.double().cpu().numpy()
    gap = float(np.linalg.norm(p[:, 1:] - p[:, :-1], axis=-1).max())
    print(f"[{tag}] chain_swing chain(10), joints only (no ground, no box pairs: no B2), PGS 60 "
          f"sweeps, 222 rows: {cut} of {full} steps, {sec:.2f} s, {sec / cut:.4f} s a step "
          f"(the default depth would take {sec / cut * full:.0f} s); launches {launches}; "
          f"max link gap {gap:.4f} (< 0.75); the swing check (moved > 0.05 m) needs ~100 "
          f"steps and is not made at this depth")
    check(np.isfinite(p).all() and gap < 0.75, f"{tag} chain_swing: gap {gap}")
    check(not launches, f"{tag} chain_swing: launches {launches}")

    cut, full = EX_BOX_STEPS
    (spec, cfg, final, traj), sec, launches = _run_counted(
        counters, lambda: box_drop.simulate(cut, device=dev))
    z = traj.p[:, 0, 2].double().cpu().numpy()
    print(f"[{tag}] box_drop (PGS 60 sweeps, K=16, no box pairs): {cut} of {full} steps, "
          f"{sec:.2f} s, {sec / cut:.4f} s a step (the default depth would take "
          f"{sec / cut * full:.0f} s); launches {launches}; z {z[0]:.4f} -> {z[-1]:.4f} "
          f"(falling; it lands at ~0.32 s, after the cut)")
    check(np.isfinite(z).all() and z[-1] < z[0] < 0.5 and not launches,
          f"{tag} box_drop: z {z[0]} -> {z[-1]}, launches {launches}")

    mpc, st = push_mpc.controller(device=dev, **EX_PUSH)
    start_cost = float(mpc.cost_fn(st))
    mean = torch.zeros((mpc.horizon, 6), dtype=torch.float32, device=dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    (mc, best), sec, launches = _run_counted(
        counters, lambda: mpc._replace(iterations=1).plan(st, mean, generator))
    batched = mpc.horizon * mpc.substeps
    per_batched = sec / batched
    full_batched = 60 * mpc.iterations * batched
    best = float(best)
    print(f"[{tag}] push_mpc {mpc.num_samples} samples, horizon {mpc.horizon}, "
          f"{mpc.substeps} substeps, PGS 40 sweeps: 1 of the default run's 60 x "
          f"{mpc.iterations} MPPI updates, {batched} batched steps in {sec:.2f} s, "
          f"{per_batched:.4f} s a batched step (a control step {per_batched * 2 * batched:.0f} "
          f"s; the default run {per_batched * full_batched / 3600:.1f} h); launches {launches}; "
          f"lowest sample cost {best:.5f} against the box left at rest {start_cost:.5f}; the "
          f"x > 0.15 check needs ~30 control steps and is not made")
    check(bool(torch.isfinite(mc).all()) and tuple(mc.shape) == (mpc.horizon, 6)
          and best < start_cost and not launches,
          f"{tag} push_mpc: best {best} against {start_cost}, launches {launches}")

    cut, full = EX_LIVING_STEPS
    settle = living_room_mpc.SETTLE_STEPS
    mesh = make_mesh(device="cuda")

    def living_room():
        spec, cfg, settled = living_room_mpc.settle(dev)
        return spec, settled, living_room_mpc.control(spec, cfg, settled, mesh,
                                                      EX_LIVING_SAMPLES, cut)

    (spec, settled, (c0, c1)), sec, launches = _run_counted(counters, living_room)
    print(f"[{tag}] living_room_mpc {EX_LIVING_SAMPLES} samples, H=25, 10 substeps, JACOBI: "
          f"the {settle}-step settle and {cut} of {full} control steps in {sec:.2f} s "
          f"({sec / (settle + cut * 260):.5f} s a step of either kind averaged; the default "
          f"depth ~{sec / cut * full:.0f} s); launches {launches}; cost {c0:.4f} -> {c1:.4f} "
          f"(bound 0.7 of the start, tests/test_examples_physics.py:33)")
    check(np.isfinite([c0, c1]).all() and c1 < 0.7 * c0, f"{tag} living_room_mpc: {c0} -> {c1}")
    check(set(launches) == {"narrowphase"}, f"{tag} living_room_mpc: launches {launches}")
    # B2 on the settled room (one scene, as the settle and the executed
    # steps give it) and on the MPPI rollouts' shape: the settled room
    # repeated S times, the lamp moved up to 2 cm in x and y in each
    g = torch.Generator(device="cpu").manual_seed(SEED)
    S = EX_LIVING_SAMPLES
    p = settled.p.expand(S, -1, -1).clone()
    p[:, living_room_mpc.LAMP, :2] += (torch.rand(S, 2, generator=g, dtype=p.dtype) * 0.04
                                      - 0.02).to(dev)
    err = max(b2_on_states(tag, "living_room_mpc's settled room", spec, settled.p[None],
                           settled.q[None]),
              b2_on_states(tag, f"the settled room x {S}, the lamp moved", spec, p,
                           settled.q.expand(S, -1, -1)))
    out["living_room_mpc"] = launches
    return out, err


def phase_examples_rama(dev):
    """The 11 FEM example models at their scripts' own mesh sizes on the
    card (complex128): the outcome asserts of
    tests/test_examples_rama.py:25-89 (bend, polarizer, mode cutoffs,
    width transitions) and, for the seven that file leaves out, the
    checks of tests/test_torch_examples_rama.py; each model's seconds."""
    from eggshell_tpu_torch.examples import (alma_coupler, capacitor_es, cavity_modes,
                                             horn_antenna, photonic_nanojet, schrodinger_barrier,
                                             waveguide_bend, waveguide_modes, waveguide_s11,
                                             waveguide_transition, wire_polarizer)

    tag = "examples_rama"
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return res

    def bend():
        (_, (rs, ts)), (_, (rg, tg)) = (waveguide_bend.solve(R, device=dev) for R in (70.0, 220.0))
        ok = (abs(rs) > 3 * abs(rg) and abs(rg) < 0.01
              and all(abs(abs(r) ** 2 + abs(t) ** 2 - 1) < 0.03 for r, t in ((rs, ts), (rg, tg))))
        return ok, f"|S11| {abs(rs):.4f} at R=70, {abs(rg):.4f} at R=220"

    def polarizer():
        mesh = wire_polarizer.build()
        (_, (r_ez, t_ez)), (_, (r_xy, t_xy)) = (wire_polarizer.solve(p, mesh=mesh, device=dev)
                                                for p in ("EZ", "EXY"))
        ok = abs(t_ez) < 0.25 and abs(r_ez) > 0.95 and abs(t_xy) > 0.95 and abs(r_xy) < 0.25
        return ok, (f"{mesh.num_points} nodes; EZ |S11| {abs(r_ez):.4f} |S21| {abs(t_ez):.4f}; "
                    f"EXY |S11| {abs(r_xy):.4f} |S21| {abs(t_xy):.4f}")

    def modes():
        a, K = 122.0, 0.5
        (_, te), (_, tm) = waveguide_modes.rectangular(a, K, device=dev)
        (_, cte), (_, ctm) = waveguide_modes.circular(61.0, device=dev)
        want = [(te[0], np.pi / a), (tm[0], np.pi * np.hypot(1 / a, 1 / (K * a))),
                (te[1], 2 * np.pi / a), (te[2], 2 * np.pi / a), (cte[0], 1.84118 / 61.0),
                (ctm[0], 2.40483 / 61.0)]
        err = max(abs(g / w - 1) for g, w in want)
        return err < 0.01, f"six cutoffs within {err:.2e} of analytic (bound 1e-2)"

    def transition():
        s = {k: waveguide_transition.solve(*k, device=dev)[1]
             for k in ((122.0, 122.0, 50.0), (122.0, 70.0, 50.0), (122.0, 200.0, 5.0),
                       (122.0, 200.0, 300.0))}
        (r0, t0), (rc, tc), (ra, ta), (rt, tt) = s.values()
        ok = (abs(r0) < 0.02 and abs(t0) > 0.99 and abs(rc) > 0.98 and abs(tc) < 0.05
              and abs(ra) > 3 * abs(rt)
              and all(abs(abs(r) ** 2 + abs(t) ** 2 - 1) < 0.01 for r, t in ((ra, ta), (rt, tt))))
        return ok, (f"|S11| straight {abs(r0):.4f}, cutoff {abs(rc):.4f}, abrupt {abs(ra):.4f}, "
                    f"taper {abs(rt):.4f}")

    def s11():
        _, ks, fem, ana, _ = waveguide_s11.sweep(device=dev)
        err = float(np.abs(np.asarray(fem) - np.asarray(ana)).max())
        return err < 0.05, f"11 frequencies, max |S11| error {err:.4f} against analytic"

    def cavity():
        _, vals, _ = cavity_modes.modes(device=dev)
        return (bool(np.all(np.diff(vals) > 0)) and abs(vals[0] / 9.6397 - 1) < 0.02,
                f"eigenvalues {np.round(vals, 3).tolist()} (lambda_1 9.6397)")

    def schrodinger():
        _, res = schrodinger_barrier.levels(device=dev)
        gaps = [float(v[1] - v[0]) for _, v, _ in res]
        return (gaps[0] > gaps[1] > gaps[2] > 0 and gaps[2] < 0.05 * gaps[0],
                f"E1 - E0 {[round(g, 3) for g in gaps]}")

    def capacitor():
        _, phi, E = capacitor_es.solve(device=dev)
        return (bool(np.isfinite(phi).all()) and E[1] < 0 and abs(E[1]) > abs(E[0]),
                f"mid-gap E {np.round(E, 4).tolist()} (ideal |Ey| {capacitor_es.IDEAL_EY:.3f})")

    def nanojet():
        _, _, xs, amps = photonic_nanojet.solve(device=dev)
        i = int(np.nanargmax(amps))
        return (photonic_nanojet.BACK_FACE < xs[i] < 6.5,
                f"peak |Ez| {amps[i]:.4f} at x = {xs[i]:.2f} um")

    def horn():
        mesh, cfg, sol = horn_antenna.solve(device=dev)
        _, _, peak, d, bw, pc = horn_antenna.pattern(mesh, cfg, sol)
        s = abs(sol.s_params[1])
        return (s < 0.15 and abs(peak) <= 5 and d > 3 and 20 < bw < 50,
                f"{mesh.num_points} nodes; |S11| {s:.3f}, peak {peak:+.1f} deg, directivity "
                f"{d:.2f}, beamwidth {bw:.1f} deg, phase center {pc}")

    def alma():
        mesh, sol = alma_coupler.solve(device=dev)
        db = {p: float(10 * np.log10(abs(sol.s_params[p]) ** 2)) for p in (1, 2, 3, 4)}
        power = sum(abs(sol.s_params[p]) ** 2 for p in (1, 2, 3, 4))
        return (-4.5 < db[3] < -2 and -4.5 < db[4] < -2 and db[1] < -20 and db[2] < -20
                and abs(power - 1) < 0.02,
                f"{mesh.num_points} nodes; dB {[round(v, 2) for v in db.values()]}, power "
                f"{power:.4f}")

    models = (("waveguide_bend", bend), ("wire_polarizer", polarizer),
              ("waveguide_modes", modes), ("waveguide_transition", transition),
              ("waveguide_s11", s11), ("cavity_modes", cavity),
              ("schrodinger_barrier", schrodinger), ("capacitor_es", capacitor),
              ("photonic_nanojet", nanojet), ("horn_antenna", horn), ("alma_coupler", alma))
    with torch.no_grad():
        for name, fn in models:
            ok, text = timed(name, fn)
            print(f"[{tag}] {name}: {text}; {out[name]:.2f} s")
            check(ok, f"{tag} {name}: {text}")
    print(f"[{tag}] the 11 models in {sum(out.values()):.1f} s")
    return out


VIEWER_FRAMES, VIEWER_STEPS_PER_FRAME = 4, 5
# The viewer's f32 state on the card against the CPU f64 viewer's after its
# 20 steps of 1 ms; the bodies move about 2e-3 m in that window.
VIEWER_BOUND = 1e-5


def phase_viewer(dev):
    """`viz.InteractiveViewer.step_once` for VIEWER_FRAMES frames of
    VIEWER_STEPS_PER_FRAME steps on box_stack(3) (ground and two box pairs)
    in float32 on the card, PGS 30 sweeps at K = 16
    (tests/test_viz_models.py:98-100): B2 once a step, nothing else; the
    state against the CPU float64 viewer's within VIEWER_BOUND; B2 held
    to its plain version on each frame's state; ms a frame.  No drawing
    (run_headless renders a GIF through matplotlib).  Returns (B2's
    launches, its max abs error)."""
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.utils.config import SimConfig, SolverKind
    from eggshell_tpu_torch.viz import InteractiveViewer

    tag = "viewer"
    cfg = SimConfig(solver=SolverKind.PGS, solver_iters=30, conditional_cfm=False,
                    cfm_always=0.01, contact_capacity=16)
    v = InteractiveViewer(*scenes.box_stack(3, jitter=0.01, device=dev, dtype=torch.float32), cfg,
                          steps_per_frame=VIEWER_STEPS_PER_FRAME)
    ref = InteractiveViewer(*scenes.box_stack(3, jitter=0.01, device="cpu", dtype=torch.float64),
                            cfg, steps_per_frame=VIEWER_STEPS_PER_FRAME)
    counters = launch_counters()
    seen = []

    def frames():
        for _ in range(VIEWER_FRAMES):
            v.step_once()
            seen.append(v.state)

    _, sec, launches = _run_counted(counters, frames)
    for _ in range(VIEWER_FRAMES):
        ref.step_once()
    steps = VIEWER_FRAMES * VIEWER_STEPS_PER_FRAME
    diff = max(float((getattr(v.state, k).double().cpu() - getattr(ref.state, k)).abs().max())
               for k in "pq")
    moved = float((ref.state.p - ref.initial_state.p).abs().max())
    print(f"[{tag}] InteractiveViewer on box_stack(3), f32, {VIEWER_FRAMES} frames of "
          f"{VIEWER_STEPS_PER_FRAME} steps: {sec / VIEWER_FRAMES * 1e3:.1f} ms a frame, "
          f"{sec / steps * 1e3:.1f} ms a step; launches {launches} (B2 once a step: {steps}); "
          f"p, q against the CPU f64 viewer {diff:.3e} (bound {VIEWER_BOUND:.0e}; the bodies "
          f"moved up to {moved:.3e} m)")
    check(launches == {"narrowphase": steps}, f"{tag}: launches {launches}")
    check(v.sim_steps == steps and diff <= VIEWER_BOUND, f"{tag}: {v.sim_steps} steps, {diff}")
    err = max(b2_on_states(tag, f"frame {i + 1}'s state", v.spec, st.p[None], st.q[None])
              for i, st in enumerate(seen))
    return launches.get("narrowphase", 0), err


FUSED_PATH = ("narrowphase_packed", "compact", "prep", "jassembly", "amat", "jacobi_packed",
              "integrate")
UNFUSED_PATH = ("narrowphase", "jacobi")
PYRAMID_PATH = FUSED_PATH[:5] + ("jacobi_packed_pyramid", "integrate")
BLOCK_PATH = FUSED_PATH[:5] + ("jacobi_packed_block", "integrate")
SCENES = {
    # scene: (kernels of its path, physical check); every scene's solve
    # (mp 32 to 96) is below the resident/cluster crossing: B6
    "box_drop": (("compact", "prep", "jassembly", "amat", "jacobi_packed", "integrate"), rests),
    "pendulum_chain6": (("compact", "prep", "jassembly", "amat", "jacobi_packed", "integrate"),
                        joints_hold),
    "box_stack8": (FUSED_PATH, stands),
    "living_room": (FUSED_PATH, above_floor),
}
# box_stack8 at contact_capacity 64 (mp = 192): past the crossing, B6b
WIDE_CAPACITY = 64
WIDE_PATH = FUSED_PATH[:5] + ("jacobi_packed_stream", "integrate")


def wide_cfg():
    """The bench configuration at contact_capacity 64."""
    return bench_cfg().replace(contact_capacity=WIDE_CAPACITY)


# Kernels `[ptxas]` reports: 43 templates, those of the Jacobi kernels (B6's
# four forms and B6b at 5 row lengths each, the resident and cluster forms
# of B6c and B6c' at 4) and the narrowphase's two entries (on the lanes a
# pair, built at one), and beside them B4, B5, the global-rows and
# streamed forms of B6c, B6c' and B6b, B7, B3 and B3g.
PTXAS_TEMPLATES = 43
PTXAS_PLAIN = ("jassembly_kernel", "amat_kernel", "jacobi_global_kernel",
               "block_jacobi_global_kernel", "jacobi_packed_rows_kernel",
               "jacobi_streamed_kernel", "block_jacobi_streamed_kernel",
               "jacobi_packed_streamed_kernel", "integrate_kernel", "compact_kernel",
               "compact_ground_kernel")


def phase_ptxas():
    """Registers, stack and spills of the Jacobi kernels (B6's four forms,
    B6b, B6c's and B6c''s resident and cluster forms, at each row length),
    of B2 and B2p, of B4 and B5, of the global-rows and streamed forms, and
    of B7, B3 and B3g, as ptxas reported them at the build; none may spill."""
    from eggshell_tpu_torch import kernels

    found = 0
    for entry, use in sorted(kernels.ptxas_usage().items()):
        m = re.search(r"(?<=\d)((?:block_)?jacobi(?:_packed\w*?|_cluster)?_kernel"
                      r"|narrowphase(?:_packed)?_kernel)ILi(\d+)E", entry)
        plain = re.search(r"\d(" + "|".join(PTXAS_PLAIN) + r")E", entry)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        elif plain:
            name = plain.group(1)
        else:
            continue
        found += 1
        print(f"[ptxas] {name}: {use.get('registers')} registers, "
              f"{use.get('stack')} bytes stack, {use.get('spill_stores')} bytes spill stores, "
              f"{use.get('spill_loads')} bytes spill loads")
        check(use.get("spill_stores") == 0 and use.get("spill_loads") == 0,
              f"{entry} spills: {use}")
    want = PTXAS_TEMPLATES + len(PTXAS_PLAIN)
    check(found == want, f"{found} kernel entries in the ptxas report, expected {want}")


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
    phase_ptxas()

    nargs, lcp = main_path_inputs(dev)
    joints_lcp = unfused_first_lcp(dev, "pendulum_chain6", joints_unfused_cfg())
    res = {"narrowphase": phase_narrowphase(dev, nargs),
           "jacobi": phase_jacobi(dev, lcp, joints_lcp),
           "jacobi_block": phase_jacobi_block(dev, lcp, joints_lcp)}
    first = {name: fused_inputs(dev, name) for name in ("box_stack4", *SCENES)}
    first_wide = fused_inputs(dev, "box_stack8", wide_cfg())
    forms = {"slice_pyramid": pyramid_cfg(), "slice_block": block_cfg()}
    first_forms = {tag: fused_inputs(dev, "box_stack4", cfg)["jacobi_packed"]
                   for tag, cfg in forms.items()}
    rand = random_fused_inputs(dev)
    # B5's routes past the whole-matrix item: slabs of whole lanes' rows
    # (K = 64) and one lane's rows with Jc in two chunks (K = 400)
    amat_routes = [(f"seeded random inputs, K={K} ({route})",
                    random_fused_inputs(dev, B=B, K=K, n=8)["amat"])
                   for K, B, route in ((64, 64, "slabs"), (400, 8, "Jc chunks"))]
    for name in FUSED_KERNELS:
        # B4, B5 and B7 also at K = 32, on box_stack8's first step; B1 on
        # the first steps of box_stack8, living_room and box_drop, and at the
        # bench shape with control wrenches (the MPC input)
        extras = ([("first-step inputs of [scene_box_stack8], K=32", first["box_stack8"][name])]
                  if name in ("jassembly", "amat", "integrate") else [])
        if name == "prep":
            extras = [(f"first-step inputs of [scene_{scene}], n={first[scene][name][0].shape[1]}",
                       first[scene][name]) for scene in ("box_stack8", "living_room", "box_drop")]
            extras.append(("first-step inputs of [slice_fused] with ext_forces (B, n, 6)",
                           first["box_stack4"][name][:8] + (rand["prep"][8],)))
            extras.append(("first-step inputs of [mpc_living_room] with its controls, "
                           f"ext_forces ({MPC_S}, 7, 6)", mpc_first_prep(dev)))
        # B6 also on the solves of box_stack8's and living_room's paths (mp = 96)
        scene_solves = [
            (f"first-step inputs of [scene_{scene}], mp={first[scene][name][1].shape[1]}",
             first[scene][name])
            for scene in ("box_stack8", "living_room")] if name == "jacobi_packed" else []
        cases = (amat_routes if name == "amat" else []) + scene_solves + [
            ("seeded random inputs", rand[name]),
            ("first-step inputs of [slice_fused]", first["box_stack4"][name])]
        res[name] = phase_fused_kernel(name, cases, extras)
    res["narrowphase_packed"] = phase_narrowphase_packed(dev, [
        (f"[{tag}]", first[name]["narrowphase"])
        for tag, name in (("slice_fused", "box_stack4"), ("scene_box_stack8", "box_stack8"),
                          ("scene_living_room", "living_room"))])
    res.update(phase_compact(dev, [
        (f"[{tag}]", first[name]["compact"])
        for tag, name in (("slice_fused", "box_stack4"), ("scene_box_stack8", "box_stack8"),
                          ("scene_living_room", "living_room"), ("scene_box_drop", "box_drop"))]))
    bp = phase_gated_kernels(dev)
    pile_b2 = phase_pile_b2(dev)
    res["jacobi_packed_stream"] = phase_jacobi_packed_stream(dev, [
        ("[scene_box_stack8_k64]", first_wide["jacobi_packed_stream"])])

    res["jacobi_packed_block"] = phase_jacobi_packed_form(
        dev, "jacobi_packed_block", "jacobi_packed_block_kernel", True, 0.0,
        ("slice_block", first_forms["slice_block"]))
    res["jacobi_packed_pyramid"] = phase_jacobi_packed_form(
        dev, "jacobi_packed_pyramid", "jacobi_packed_pyramid_kernel", False,
        pyramid_cfg().friction_mu, ("slice_pyramid", first_forms["slice_pyramid"]))
    res.update(phase_jacobi_cluster(dev))
    wide_rows = phase_jacobi_packed_rows(dev)
    res["jacobi_packed_stream"].update({f"{k}_888": wide_rows["jacobi_packed_stream"][k] for k in (
        "ms", "plain_ms", "bound_ms", "floor_ms", "launches", "max_abs_err")})
    res["jacobi_packed_streamed"] = wide_rows["jacobi_packed_streamed"]
    res["jacobi_packed_rows"] = wide_rows["jacobi_packed_rows"]
    # box_stack8 at contact_capacity 296 (mp = 888): B6b on a cluster of
    # 9 to 16 blocks, B_WIDE scenarios; its first step here, its rollout below
    k296 = bench_cfg().replace(contact_capacity=WIDE_ROWS_CAPACITY)
    first_k296 = fused_inputs(dev, "box_stack8", k296, batch=B_WIDE)["jacobi_packed_stream"]
    res["jacobi_packed_stream"]["max_abs_err_k296"] = phase_wide_rows_first_step(dev, first_k296)
    del first_k296
    res["fdtd2d"] = phase_fdtd2d(dev)
    phase_narrowphase_vjp(dev)

    phase_oracle(dev, bench_cfg(), "oracle_fused")
    fused_launches, _ = phase_rollout(dev, "slice_fused", "box_stack4", FUSED_PATH, stands)
    phase_oracle(dev, slice_cfg(), "oracle")
    unfused_launches, _ = phase_rollout(dev, "slice", "box_stack4", UNFUSED_PATH, stands,
                                        cfg=slice_cfg())
    scene_launches, living_room = {}, {}
    for scene, (path, physical) in SCENES.items():
        scene_launches[scene], _ = phase_rollout(
            dev, f"scene_{scene}", scene, path, physical,
            info=living_room if scene == "living_room" else None)
        phase_agreement(dev, f"scene_{scene}", scene)
    bp_launches, bp_capacity = phase_living_room_bp(dev, living_room["final"])
    wide_launches, _ = phase_rollout(dev, "scene_box_stack8_k64", "box_stack8", WIDE_PATH, stands,
                                     cfg=wide_cfg())
    from eggshell_tpu_torch.physics import scenes

    k296_launches, _ = phase_rollout(dev, "scene_box_stack8_k296", "box_stack8", WIDE_PATH,
                                     stands, cfg=k296,
                                     batch=scenes.baseline_batch("box_stack8", B_WIDE, device=dev))
    res["jacobi_packed_stream"]["launches_k296"] = k296_launches["jacobi_packed_stream"]
    form_launches = {}
    for tag, path in (("slice_pyramid", PYRAMID_PATH), ("slice_block", BLOCK_PATH)):
        form_launches[tag], _ = phase_rollout(dev, tag, "box_stack4", path, stands,
                                              cfg=forms[tag])
        phase_agreement(dev, tag, "box_stack4", cfg=forms[tag])
    phase_rollout(dev, "slice_joints_unfused", "pendulum_chain6", ("jacobi",), joints_hold,
                  cfg=joints_unfused_cfg())
    mpc_launches = phase_mpc(dev)
    grad, grad_launches = phase_gradient_mpc(dev)
    phase_gradient_paths(dev)
    phase_direct(dev)
    phase_oracle(dev, direct_cfg(), "oracle_direct")
    phase_gradient_mpc_update(dev)
    phase_stabilize(dev)
    phase_implicit_midpoint(dev)
    phase_explicit_euler(dev)
    phase_step_diagnostics(dev)
    phase_fem_driven(dev)
    phase_fem_sweep(dev)
    phase_fem_modes(dev)
    phase_fdtd3d(dev)
    phase_sharded(dev)
    phase_optimize(dev)
    c3 = phase_c3_float64(dev)
    phase_utils_tail(dev)
    examples, examples_b2_err = phase_examples_physics(dev)
    phase_examples_rama(dev)
    viewer, viewer_b2_err = phase_viewer(dev)
    piles = {name: phase_pile(dev, name) for name in ("pile216", "pile512")}
    fdtd_launches, _ = phase_fdtd2d_rollout(dev)
    res["narrowphase"].update({"launches_pile": piles["pile512"]["launches"]["narrowphase"],
                               **{f"{k}_pile": pile_b2["pile512"][k]
                                  for k in ("ms", "plain_ms", "bound_ms")}})
    res["narrowphase"]["max_abs_err"] = max(res["narrowphase"]["max_abs_err"],
                                            *(r["max_abs_err"] for r in pile_b2.values()),
                                            examples_b2_err, viewer_b2_err)
    res["narrowphase"]["launches_examples"] = {
        "living_room_mpc": examples["living_room_mpc"]["narrowphase"],
        "viewer": viewer, "c3_float64_f32_case": c3}
    res["fdtd2d"]["launches_examples"] = {
        "fdtd_aperture": examples["fdtd_aperture"]["fdtd2d"]}
    for name in ("narrowphase_packed", "compact"):
        res[name].update({"launches_bp": bp_launches[name],
                          **{k: bp[name][k] for k in ("ms_bp", "plain_ms_bp", "bound_ms_bp")}})
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], bp[name]["max_abs_err"])
    print(f"[summary] pile216 {piles['pile216']['steps_per_s']['graph_s']:.1f} and pile512 "
          f"{piles['pile512']['steps_per_s']['graph_s']:.1f} steps/s captured; "
          f"living_room_bp pair capacity {bp_capacity}; pile512 matvec forms (ms a solve) "
          f"{piles['pile512']['matvec_ms']}; gradient_mpc grad steps/s kernel_ift and "
          f"xla_unrolled " + ", ".join(
              f"{shape} {r['kernel_ift']['grad_steps_per_s']:.1f} and "
              f"{r['xla_unrolled']['grad_steps_per_s']:.1f}" for shape, r in grad.items()))

    rows = [("narrowphase", "eggshell_tpu_torch/csrc/narrowphase.cu",
             "eggshell_tpu/ops/collision_kernel.py:58", "unfused", unfused_launches["narrowphase"]),
            ("narrowphase_packed", "eggshell_tpu_torch/csrc/narrowphase.cu",
             "eggshell_tpu/ops/collision_kernel.py:444", "fused",
             fused_launches["narrowphase_packed"]),
            ("compact", "eggshell_tpu_torch/csrc/compact.cu",
             "eggshell_tpu/ops/compact_kernel.py:259", "fused", fused_launches["compact"]),
            ("compact_ground", "eggshell_tpu_torch/csrc/compact.cu",
             "eggshell_tpu/ops/compact_kernel.py:306", "scene_box_drop",
             scene_launches["box_drop"]["compact"]),
            ("jacobi", "eggshell_tpu_torch/csrc/jacobi.cu", "eggshell_tpu/ops/pgs_kernel.py:47",
             "unfused", unfused_launches["jacobi"]),
            ("jacobi_packed_stream", "eggshell_tpu_torch/csrc/jacobi_packed_stream.cu",
             "eggshell_tpu/ops/pgs_kernel.py:355", "scene_box_stack8_k64",
             wide_launches["jacobi_packed_stream"])]
    rows += [(name, FUSED_KERNELS[name][3], FUSED_KERNELS[name][4], "fused",
              fused_launches[name]) for name in FUSED_KERNELS]
    rows += [("jacobi_packed_block", "eggshell_tpu_torch/csrc/jacobi_packed.cu",
              "eggshell_tpu/ops/pgs_kernel.py:265", "slice_block",
              form_launches["slice_block"]["jacobi_packed_block"]),
             ("jacobi_packed_pyramid", "eggshell_tpu_torch/csrc/jacobi_packed.cu",
              "eggshell_tpu/ops/pgs_kernel.py:217", "slice_pyramid",
              form_launches["slice_pyramid"]["jacobi_packed_pyramid"]),
             ("jacobi_block", "eggshell_tpu_torch/csrc/jacobi.cu",
              "eggshell_tpu/ops/pgs_kernel.py:86", "solve_lcp_jacobi(block=True), one call",
              res["jacobi_block"]["launches"]),
             ("fdtd2d", "eggshell_tpu_torch/csrc/fdtd2d.cu", "eggshell_tpu/fem/fdtd.py:113",
              "fdtd2d_rollout", fdtd_launches),
             ("jacobi_cluster", "eggshell_tpu_torch/csrc/jacobi.cu",
              "eggshell_tpu/ops/pgs_kernel.py:47", "solve_lcp_jacobi at m=240, one call",
              res["jacobi_cluster"]["launches"]),
             ("jacobi_block_cluster", "eggshell_tpu_torch/csrc/jacobi.cu",
              "eggshell_tpu/ops/pgs_kernel.py:86",
              "solve_lcp_jacobi(block=True) at m=240, one call",
              res["jacobi_block_cluster"]["launches"]),
             ("jacobi_streamed", "eggshell_tpu_torch/csrc/jacobi.cu",
              "eggshell_tpu/ops/pgs_kernel.py:47", "solve_lcp_jacobi at m=1200, one call",
              res["jacobi_streamed"]["launches"]),
             ("jacobi_block_streamed", "eggshell_tpu_torch/csrc/jacobi.cu",
              "eggshell_tpu/ops/pgs_kernel.py:86",
              "solve_lcp_jacobi(block=True) at m=1200, one call",
              res["jacobi_block_streamed"]["launches"]),
             ("jacobi_global", "eggshell_tpu_torch/csrc/jacobi.cu",
              "eggshell_tpu/ops/pgs_kernel.py:47",
              f"solve_lcp_jacobi at m={PAST_STREAMED}, one call (timed forced at m=672, B=64)",
              res["jacobi_global"]["launches"]),
             ("jacobi_block_global", "eggshell_tpu_torch/csrc/jacobi.cu",
              "eggshell_tpu/ops/pgs_kernel.py:86",
              f"solve_lcp_jacobi(block=True) at m={PAST_STREAMED}, one call (timed forced at "
              "m=672, B=64)", res["jacobi_block_global"]["launches"]),
             ("jacobi_packed_streamed", "eggshell_tpu_torch/csrc/jacobi_packed_stream.cu",
              "eggshell_tpu/ops/pgs_kernel.py:355",
              "solve_lcp_jacobi_packed_stream at mp=1200, one call",
              res["jacobi_packed_streamed"]["launches"]),
             ("jacobi_packed_rows", "eggshell_tpu_torch/csrc/jacobi_packed_stream.cu",
              "eggshell_tpu/ops/pgs_kernel.py:355",
              f"solve_lcp_jacobi_packed_stream at mp={PACKED_PAST_STREAMED}, one call (timed "
              "forced at mp=888, B=256)",
              res["jacobi_packed_rows"]["launches"])]
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces, "path": path,
         "launches": launches, "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"], "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "library_ms": None,
         **({"launches_mpc": mpc_launches[name]} if mpc_launches.get(name) else {}),
         **({"launches_grad": grad_launches[name]} if grad_launches.get(name) else {}),
         **{k: res[name][k] for k in ("resident_ms", "ms_extra", "plain_ms_extra",
                                      "bound_ms_extra", "shapes", "launches_pile", "ms_pile",
                                      "plain_ms_pile", "bound_ms_pile", "launches_bp", "ms_bp",
                                      "plain_ms_bp", "bound_ms_bp", "launches_examples",
                                      "floor_ms", "launches_k296", "max_abs_err_k296")
            if k in res[name]},
         **{k: v for k, v in res[name].items() if re.search(r"_(672|888)$", k)}}
        for name, source, replaces, path, launches in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
