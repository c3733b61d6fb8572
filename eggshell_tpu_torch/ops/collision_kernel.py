"""Batched SAT narrowphase: the hand-written CUDA kernel's two entries and
their wrappers.

- `collide_boxes_lanes`: counterpart of
  `eggshell_tpu.ops.collision_kernel.collide_boxes_lanes`, gathered pairs
  in, every output of `PairContacts` out (the unfused branch).
- `collide_boxes_lanes_diff`: `collide_boxes_lanes` as a
  `torch.autograd.Function`, the kernel forward and autograd of the plain
  `collide_boxes` backward (the JAX package's custom VJP).  The unfused
  branch's and the matrix-free step's contacts take it, so a gradient
  crosses their narrowphase on the card as on the CPU.
- `collide_boxes_lanes_packed` (B2p): counterpart of
  `eggshell_tpu.ops.collision_kernel.collide_boxes_lanes_packed`, the fused
  chain's entry: the (B, n) state and the pair lists in, and only what the
  compaction kernel (`ops.compact_kernel`) reads out.  The pair lists are
  the scene's (P,), shared by every scenario, or the broadphase's (B, Pc),
  one a scenario, with its gate: a gated-off pair writes no active lane.

On a CUDA tensor a wrapper launches `csrc/narrowphase.cu` as
`narrowphase_launch_plan` says; on a CPU tensor it runs its plain version,
built on `ops.collision.collide_boxes`.  There is no fallback from one to
the other: a CUDA input that the kernel does not take raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eggshell_tpu_torch.ops.collision import MAX_POLY, PairContacts, collide_boxes
from eggshell_tpu_torch.ops.quaternion import quat_to_mat

# `csrc/narrowphase.cu`: the lanes of one warp a pair (its kLanes, the
# fastest of 2, 4, 8 and 16 on the card at every shape the paths launch,
# PERF.md), threads a block (its kThreads), the shared bytes a pair's group
# uses (two clip buffers of MAX_POLY (x, y) points and one point of
# padding, its kGroupPoints) and the pairs a launch takes (it indexes them
# in 32 bits).
LANES_PER_PAIR = 4
NARROWPHASE_THREADS = 128
GROUP_BYTES = (2 * MAX_POLY + 1) * 8
MAX_PAIRS = 2 ** 31 - 1


class NarrowphasePlan(NamedTuple):
    """How `csrc/narrowphase.cu` runs on N pairs: a group of `lanes` lanes
    of one warp a pair, `threads` a block, `blocks` blocks and
    `shared_bytes` of dynamic shared memory a block."""
    lanes: int
    threads: int
    blocks: int
    shared_bytes: int


def narrowphase_launch_plan(N: int) -> NarrowphasePlan:
    """The launch of either entry on N pairs (N = B * P on the packed
    entry); raises ValueError for N < 1 or N past MAX_PAIRS."""
    if not 1 <= N <= MAX_PAIRS:
        raise ValueError(f"N = {N}: the narrowphase kernels take 1 to {MAX_PAIRS} pairs")
    pairs = NARROWPHASE_THREADS // LANES_PER_PAIR
    return NarrowphasePlan(LANES_PER_PAIR, NARROWPHASE_THREADS, -(-N // pairs),
                           pairs * GROUP_BYTES)


def collide_boxes_lanes(p1, R1, hs1, p2, R2, hs2) -> PairContacts:
    """SAT narrowphase of N box pairs: p (N, 3), R (N, 3, 3), hs (N, 3)
    -> `PairContacts` with a leading pair dimension."""
    if p1.device.type == "cpu":
        return collide_boxes(p1, R1, hs1, p2, R2, hs2)
    if p1.device.type != "cuda":
        raise ValueError(f"unsupported device {p1.device}")
    from eggshell_tpu_torch import kernels

    N = p1.shape[0]
    dev = p1.device
    for name, x, shape in (("p1", p1, (N, 3)), ("R1", R1, (N, 3, 3)),
                           ("hs1", hs1, (N, 3)), ("p2", p2, (N, 3)),
                           ("R2", R2, (N, 3, 3)), ("hs2", hs2, (N, 3))):
        kernels.check_arg(name, x, shape, torch.float32, dev)
    plan = narrowphase_launch_plan(N)
    pos = torch.empty((N, MAX_POLY, 3), dtype=torch.float32, device=dev)
    nrm = torch.empty((N, 3), dtype=torch.float32, device=dev)
    dep = torch.empty((N, MAX_POLY), dtype=torch.float32, device=dev)
    act = torch.empty((N, MAX_POLY), dtype=torch.bool, device=dev)
    code = torch.empty((N,), dtype=torch.int32, device=dev)
    idep = torch.empty((N,), dtype=torch.float32, device=dev)
    iax = torch.empty((N, 3), dtype=torch.float32, device=dev)
    kernels.launch("eggshell_narrowphase_f32", dev, p1, R1, hs1, p2, R2, hs2, pos, nrm, dep, act,
                   code, idep, iax, N, *plan)
    collide_boxes_lanes.launches += 1
    return PairContacts(
        position=pos,
        normal=nrm[:, None, :].expand(N, MAX_POLY, 3),
        depth=dep,
        active=act,
        code=code,
        info_depth=idep,
        separating_axis=iax,
    )


collide_boxes_lanes.launches = 0


class _CollideBoxesLanesDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p1, R1, hs1, p2, R2, hs2):
        out = collide_boxes_lanes(p1, R1, hs1, p2, R2, hs2)
        ctx.save_for_backward(p1, R1, hs1, p2, R2, hs2)
        ctx.mark_non_differentiable(out.active, out.code)
        return (out.position, out.normal[:, 0], out.depth, out.active, out.code,
                out.info_depth, out.separating_axis)

    @staticmethod
    def backward(ctx, g_pos, g_nrm, g_dep, g_act, g_code, g_idep, g_iax):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [x for x in inputs if x.requires_grad]
        if not wanted:
            return (None,) * 6
        with torch.enable_grad():
            out = collide_boxes(*inputs)
            pairs = [(o, g) for o, g in ((out.position, g_pos), (out.normal[:, 0], g_nrm),
                                         (out.depth, g_dep), (out.info_depth, g_idep),
                                         (out.separating_axis, g_iax))
                     if g is not None and o.requires_grad]
        outs, grads = [o for o, _ in pairs], [g for _, g in pairs]
        got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True)
                   if outs else [None] * len(wanted))
        return tuple(next(got) if x.requires_grad else None for x in inputs)


def collide_boxes_lanes_diff(p1, R1, hs1, p2, R2, hs2) -> PairContacts:
    """`collide_boxes_lanes` with a backward: the kernel (on a CUDA tensor)
    or the plain version forward, and autograd of the plain
    `ops.collision.collide_boxes` over the saved inputs backward.  The
    flags and codes carry no gradient."""
    pos, nrm, dep, act, code, idep, iax = _CollideBoxesLanesDiff.apply(p1, R1, hs1, p2, R2, hs2)
    N = pos.shape[0]
    return PairContacts(position=pos, normal=nrm[:, None, :].expand(N, MAX_POLY, 3), depth=dep,
                        active=act, code=code, info_depth=idep, separating_axis=iax)


def gather_pairs(p, R, half_extents, pair_i, pair_j):
    """The lanes entry's inputs for every candidate pair of every scenario,
    scenario-major: (p1, R1, hs1, p2, R2, hs2) with B * P rows, from p
    (B, n, 3), R (B, n, 3, 3), half_extents (n, 3), pair_i / pair_j (P,)
    shared by every scenario or (B, P), a list a scenario."""
    B, P = p.shape[0], pair_i.shape[-1]

    def flat(x):
        return x.reshape((B * P,) + x.shape[2:]).contiguous()

    if pair_i.dim() == 2:
        bidx = torch.arange(B, device=p.device)[:, None]
        return (flat(p[bidx, pair_i]), flat(R[bidx, pair_i]), flat(half_extents[pair_i]),
                flat(p[bidx, pair_j]), flat(R[bidx, pair_j]), flat(half_extents[pair_j]))
    return (flat(p[:, pair_i]), flat(R[:, pair_i]), flat(half_extents[pair_i].expand(B, P, 3)),
            flat(p[:, pair_j]), flat(R[:, pair_j]), flat(half_extents[pair_j].expand(B, P, 3)))


def collide_boxes_lanes_packed_plain(p, q, half_extents, pair_i, pair_j, gate=None):
    """Plain torch version of the packed entry: R = quat_to_mat(q), the
    gather of every pair's bodies (`gather_pairs`), then `collide_boxes`,
    and a pair's flags cleared where `gate` is False.  p (B, n, 3),
    q (B, n, 4), half_extents (n, 3), pair_i / pair_j (P,) int64 shared by
    every scenario or (B, P) a list a scenario, gate None or (B, P) bool.
    Returns pos (B, P, 12, 3), nrm (B, P, 3), dep (B, P, 12), act
    (B, P, 12) bool."""
    B, P = p.shape[0], pair_i.shape[-1]
    out = collide_boxes(*gather_pairs(p, quat_to_mat(q), half_extents, pair_i, pair_j))
    act = out.active.reshape(B, P, MAX_POLY)
    if gate is not None:
        act = act & gate[..., None]
    return (out.position.reshape(B, P, MAX_POLY, 3), out.normal[:, 0].reshape(B, P, 3),
            out.depth.reshape(B, P, MAX_POLY), act)


def collide_boxes_lanes_packed(p, q, half_extents, pair_i, pair_j, gate=None):
    """(pos, nrm, dep, act) of every candidate pair of every scenario; see
    `collide_boxes_lanes_packed_plain` for the arguments.  The kernel
    gathers the pairs' bodies and forms R from q itself; it reads a
    scenario's pair k at pair_i[k] from a (P,) list and at pair_i[s, k]
    from a (B, P) one, and writes the gate into the flags."""
    if p.device.type == "cpu":
        return collide_boxes_lanes_packed_plain(p, q, half_extents, pair_i, pair_j, gate)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    from eggshell_tpu_torch import kernels

    B, n = p.shape[:2]
    P = pair_i.shape[-1]
    per_scenario = pair_i.dim() == 2
    ids = (B, P) if per_scenario else (P,)
    dev = p.device
    f32 = torch.float32
    args = [("p", p, (B, n, 3), f32), ("q", q, (B, n, 4), f32),
            ("half_extents", half_extents, (n, 3), f32), ("pair_i", pair_i, ids, torch.int64),
            ("pair_j", pair_j, ids, torch.int64)]
    if gate is not None:
        args.append(("gate", gate, (B, P), torch.bool))
    for name, x, shape, dtype in args:
        kernels.check_arg(name, x, shape, dtype, dev)
    plan = narrowphase_launch_plan(B * P)
    pos = torch.empty((B, P, MAX_POLY, 3), dtype=f32, device=dev)
    nrm = torch.empty((B, P, 3), dtype=f32, device=dev)
    dep = torch.empty((B, P, MAX_POLY), dtype=f32, device=dev)
    act = torch.empty((B, P, MAX_POLY), dtype=torch.bool, device=dev)
    kernels.launch("eggshell_narrowphase_packed_f32", dev, p, q, half_extents, pair_i, pair_j,
                   gate, pos, nrm, dep, act, B, n, P, P if per_scenario else 0, *plan)
    collide_boxes_lanes_packed.launches += 1
    return pos, nrm, dep, act


collide_boxes_lanes_packed.launches = 0
