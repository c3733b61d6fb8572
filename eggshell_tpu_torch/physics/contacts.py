"""Scene-level contact assembly for a batch of scenarios: broadphase and
narrowphase fan-out, stable compaction into K lanes, same-pair
deduplication, and the joint-contact dedupe.

Counterpart of `eggshell_tpu.physics.contacts`.  Candidates come in the
reference order — ground corners body-major (8 per body), then the
candidate pairs in order (MAX_CONTACTS_PER_PAIR lanes each) — and active
candidates are compacted in that order, so lane k here is lane k in the
JAX package.  With 0 < cfg.pair_capacity < P the candidate pairs are each
scenario's broadphase selection (`ops.broadphase.select_scene_pairs`), its
gate folded into the pairs' flags before compaction.  The compaction is a
cumsum and a scatter at every size: it gives the lanes of both of the JAX
package's forms (a one-hot matmul, and `top_k` where K * C > 2**23).
`make_contacts_batched` is the unfused branch's contact
step (`make_contacts` that of one scene); the fused chain runs the
compaction kernel (`ops.compact_kernel`), whose plain version is built
from `ground_candidates`, `pair_candidates`, `_compact` and `_dedupe`
here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from eggshell_tpu_torch.ops import broadphase, collision
from eggshell_tpu_torch.ops import quaternion as quat
from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes_diff, gather_pairs
from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.utils.config import SimConfig
from eggshell_tpu_torch.utils.constants import constant

# `_dedupe` compares every pair of lanes; from this capacity on the contacts
# take the JAX package's windowed form (`_dedupe_windowed`).
WINDOWED_DEDUPE_MIN_K = 32 * collision.MAX_CONTACTS_PER_PAIR


class ContactSet(NamedTuple):
    """K contact lanes per scenario.  b0 = -1 is the ground (the body of a
    ground contact is slot 1); idle lanes have b0 = b1 = -1."""

    b0: torch.Tensor        # (B, K) int64
    b1: torch.Tensor        # (B, K) int64
    position: torch.Tensor  # (B, K, 3)
    normal: torch.Tensor    # (B, K, 3)
    depth: torch.Tensor     # (B, K)
    active: torch.Tensor    # (B, K) bool

    @property
    def capacity(self) -> int:
        return self.b0.shape[-1]


def broadphase_on(spec: SceneSpec, cfg: SimConfig) -> bool:
    """Whether the narrowphase takes each scenario's broadphase selection:
    0 < cfg.pair_capacity < the scene's pairs, as in the JAX package."""
    return 0 < cfg.pair_capacity < spec.num_pairs


def scene_pairs(spec: SceneSpec, states: State, cfg: SimConfig):
    """(pair_i, pair_j, gate) the narrowphase takes: each scenario's
    broadphase selection, (B, pair_capacity) each, where `broadphase_on`,
    else the scene's (P,) lists and no gate."""
    if broadphase_on(spec, cfg):
        return broadphase.select_scene_pairs(spec, states, cfg)
    return spec.pair_i, spec.pair_j, None


def box_pair_narrowphase(dtype, device, contact_kernel):
    """The narrowphase the unfused contacts run on their box pairs: the
    kernel wrapper `collide_boxes_lanes_diff` or the plain
    `ops.collision.collide_boxes`, as the JAX package's `contact_kernel`
    and XLA path choose.  On the card: float32 with `contact_kernel` None
    or True takes B2; float64, or `contact_kernel=False`, the plain
    version; float64 with `contact_kernel=True` raises ValueError, since
    B2 takes float32 only.  Off the card the wrapper runs its plain
    version itself.  (The fused chain takes B2p in float32 always.)"""
    if torch.device(device).type != "cuda":
        return collide_boxes_lanes_diff
    if contact_kernel is False:
        return collision.collide_boxes
    if dtype != torch.float32:
        if contact_kernel:
            raise ValueError(f"contact_kernel=True asks for the narrowphase kernel B2, which takes "
                             f"float32 only, on {dtype} tensors: pass float32 tensors, or "
                             f"contact_kernel=None or False for the plain narrowphase")
        return collision.collide_boxes
    return collide_boxes_lanes_diff


def _candidates(spec: SceneSpec, states: State, cfg: SimConfig):
    """All candidate contacts of every scenario in reference order:
    (b0, b1, pos, nrm, dep, act) with a candidate axis of n*8 + P*12 (P the
    pairs the narrowphase takes, `scene_pairs`)."""
    B, n = states.p.shape[:2]
    device = states.p.device
    R = states.R()                                                  # (B, n, 3, 3)

    gpos, gnrm, gdep, gact = collision.collide_box_and_ground(
        states.p, R, spec.half_extents.expand(B, n, 3)
    )
    gact = gact & spec.ground_enabled[None, :, None]
    G = collision.GROUND_CONTACTS
    g_b0 = torch.full((B, n * G), -1, dtype=torch.int64, device=device)
    g_b1 = torch.arange(n, device=device).repeat_interleave(G).expand(B, n * G)

    parts = [(g_b0, g_b1, gpos.reshape(B, n * G, 3), gnrm.reshape(B, n * G, 3),
              gdep.reshape(B, n * G), gact.reshape(B, n * G))]
    if spec.num_pairs > 0:
        pi, pj, gate = scene_pairs(spec, states, cfg)
        P = pi.shape[-1]
        narrowphase = box_pair_narrowphase(states.p.dtype, device, cfg.contact_kernel)
        out = narrowphase(*gather_pairs(states.p, R, spec.half_extents, pi, pj))
        C = collision.MAX_CONTACTS_PER_PAIR
        act = out.active.reshape(B, P, C)
        if gate is not None:
            act = act & gate[..., None]
        parts.append((
            pi.repeat_interleave(C, dim=-1).expand(B, P * C),
            pj.repeat_interleave(C, dim=-1).expand(B, P * C),
            out.position.reshape(B, P * C, 3), out.normal.reshape(B, P * C, 3),
            out.depth.reshape(B, P * C), act.reshape(B, P * C),
        ))
    return tuple(torch.cat([part[i] for part in parts], dim=1) for i in range(6))


def _compact(b0, b1, pos, nrm, dep, act, K: int) -> ContactSet:
    """Stable compaction: active candidate number o lands in lane o; the
    active candidates past K are dropped.  Idle lanes: b0 = b1 = -1, zero
    geometry.  Every field is contiguous, as the fused chain's kernels
    take them."""
    B, C = act.shape
    offs = broadphase.running_count(act) - act.to(torch.int64)
    slot = torch.where(act & (offs < K), offs, torch.full_like(offs, K))  # K = discard

    def scatter(vals, fill):
        shape = (B, K + 1) + vals.shape[2:]
        buf = torch.full(shape, fill, dtype=vals.dtype, device=vals.device)
        idx = slot.reshape(B, C, *([1] * (vals.dim() - 2))).expand(vals.shape)
        return buf.scatter(1, idx, vals)[:, :K].contiguous()

    return ContactSet(
        b0=scatter(b0.expand(B, C), -1),
        b1=scatter(b1.expand(B, C), -1),
        position=scatter(pos, 0.0),
        normal=scatter(nrm, 0.0),
        depth=scatter(dep, 0.0),
        active=scatter(act, False),
    )


def _dedupe(cs: ContactSet, eps2: float) -> ContactSet:
    """Drop contact k when an earlier lane of the same body pair (ground
    lanes excluded) lies closer than sqrt(eps2).  Non-cascaded: every lane
    is judged against the active flags it came in with."""
    lo_b = torch.minimum(cs.b0, cs.b1)
    hi_b = torch.maximum(cs.b0, cs.b1)
    ok = lo_b >= 0
    K = cs.capacity
    d = cs.position[:, :, None, :] - cs.position[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    same_pair = (lo_b[:, :, None] == lo_b[:, None, :]) & (hi_b[:, :, None] == hi_b[:, None, :])
    both_ok = ok[:, :, None] & ok[:, None, :]
    both_act = cs.active[:, :, None] & cs.active[:, None, :]
    lane = torch.arange(K, device=cs.b0.device)
    earlier = lane[None, :] < lane[:, None]
    drop = torch.any(same_pair & both_ok & both_act & earlier & (d2 < eps2), dim=2)
    return cs._replace(active=cs.active & ~drop)


def _dedupe_windowed(cs: ContactSet, eps2: float) -> ContactSet:
    """`_dedupe` judging each lane against the MAX_CONTACTS_PER_PAIR - 1
    lanes before it only, the JAX package's form for large capacities: a
    pair's candidates are contiguous and the compaction keeps their order,
    so an earlier lane of the same pair is never further back."""
    lo_b = torch.minimum(cs.b0, cs.b1)
    hi_b = torch.maximum(cs.b0, cs.b1)
    ok = (lo_b >= 0) & cs.active
    K = cs.capacity
    dev = cs.b0.device
    back = torch.arange(K, device=dev)[:, None] - torch.arange(
        1, collision.MAX_CONTACTS_PER_PAIR, device=dev)                # (K, W-1)
    inside = back >= 0
    prev = back.clamp(min=0)
    d = cs.position[:, :, None, :] - cs.position[:, prev]              # (B, K, W-1, 3)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    hit = ((lo_b[:, :, None] == lo_b[:, prev]) & (hi_b[:, :, None] == hi_b[:, prev])
           & ok[:, :, None] & ok[:, prev] & inside & (d2 < eps2))
    return cs._replace(active=cs.active & ~torch.any(hit, dim=2))


def ground_candidates(p, q, half_extents, ground_enabled):
    """The ground corners of every body, 8 per body, body-major, in the
    compaction kernel's expressions (csrc/compact.cu): R = quat_to_mat(q),
    c = p + R0 (sx hx) + R1 (sy hy) + R2 (sz hz) summed left to right, active
    when cz < 0 and the body's ground_enabled.  p (B, n, 3), q (B, n, 4),
    half_extents (n, 3), ground_enabled (n,) bool.  Returns (b0, b1, pos,
    nrm, dep, act) with a candidate axis of 8n."""
    B, n = p.shape[:2]
    G = collision.GROUND_CONTACTS
    R = quat.quat_to_mat(q)                                           # (B, n, 3, 3)
    signs = constant(collision._CORNER_SIGNS, p.dtype, p.device)
    o = signs * half_extents[:, None, :]                              # (n, 8, 3)
    c = [p[..., r, None] + R[..., r, 0, None] * o[..., 0] + R[..., r, 1, None] * o[..., 1]
         + R[..., r, 2, None] * o[..., 2] for r in range(3)]           # (B, n, 8) each
    pos = torch.stack(c, -1).reshape(B, n * G, 3)
    act = ((c[2] < 0) & ground_enabled[:, None]).reshape(B, n * G)
    nrm = torch.zeros_like(pos)
    nrm[..., 2] = 1.0
    b0 = torch.full((B, n * G), -1, dtype=torch.int64, device=p.device)
    b1 = torch.arange(n, device=p.device).repeat_interleave(G).expand(B, n * G)
    return b0, b1, pos, nrm, -pos[..., 2], act


def pair_candidates(pair, pair_i, pair_j):
    """The narrowphase lanes of every candidate pair as candidates: pair
    = (pos (B, P, 12, 3), nrm (B, P, 3), dep (B, P, 12), act (B, P, 12)), the
    packed narrowphase's outputs; pair_i / pair_j (P,) or (B, P).  Returns
    (b0, b1, pos, nrm, dep, act) with a candidate axis of 12P, pair-major."""
    pos, nrm, dep, act = pair
    B, P, C = dep.shape
    return (pair_i.repeat_interleave(C, dim=-1).expand(B, P * C),
            pair_j.repeat_interleave(C, dim=-1).expand(B, P * C),
            pos.reshape(B, P * C, 3), nrm[:, :, None, :].expand(B, P, C, 3).reshape(B, P * C, 3),
            dep.reshape(B, P * C), act.reshape(B, P * C))


def joint_points(a0, a1, joint_b1):
    """Where a joint sits for the joint-contact dedupe: a0 for a joint
    anchored to the world (joint_b1 = -1), the midpoint 1/2 (a0 + a1)
    otherwise.  a0 / a1 (B, J, 3)."""
    return torch.where((joint_b1 < 0)[:, None], a0, 0.5 * (a0 + a1))


def drop_joint_contacts(cs: ContactSet, jpos, joint_b0, joint_b1, eps2: float) -> ContactSet:
    """Joint-contact dedupe (the JAX package's `stepper.py:557-582`,
    `contacts.py:241-266`): contact k is dropped (active cleared, ids kept)
    when a joint joins the same unordered body pair, neither side the
    world or the ground, and the contact lies closer than sqrt(eps2) to the
    joint point `jpos` (B, J, 3) (see `joint_points`)."""
    lo = torch.minimum(cs.b0, cs.b1)
    hi = torch.maximum(cs.b0, cs.b1)
    jlo = torch.minimum(joint_b0, joint_b1)
    jhi = torch.maximum(joint_b0, joint_b1)
    d = cs.position[:, :, None, :] - jpos[:, None, :, :]              # (B, K, J, 3)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    same = ((lo[:, :, None] == jlo) & (hi[:, :, None] == jhi) & (jlo >= 0)
            & (lo >= 0)[:, :, None])
    drop = torch.any(same & (d2 < eps2), dim=2)
    return cs._replace(active=cs.active & ~drop)


def joint_anchors(spec: SceneSpec, states: State):
    """World anchor points of the ball joints, (B, J, 3) each: a0 on body
    b0, a1 on body b1 (the fixed world anchor joint_c1 when b1 = -1).
    Counterpart of the JAX package's `stepper._joint_anchors`."""
    R = quat.quat_to_mat(states.q)
    jb0 = spec.joint_b0
    anchored = spec.joint_b1 < 0
    jb1 = torch.where(anchored, torch.zeros_like(spec.joint_b1), spec.joint_b1)
    a0 = states.p[:, jb0] + torch.einsum("bjik,jk->bji", R[:, jb0], spec.joint_c0)
    a1 = torch.where(anchored[:, None], spec.joint_c1,
                     states.p[:, jb1] + torch.einsum("bjik,jk->bji", R[:, jb1], spec.joint_c1))
    return a0, a1


def make_contacts_batched(spec: SceneSpec, states: State, cfg: SimConfig) -> ContactSet:
    """Detect, compact and dedupe the contacts of B scenarios into
    `cfg.contact_capacity` lanes each: the same-pair dedupe (windowed from
    WINDOWED_DEDUPE_MIN_K lanes on, as in the JAX package), then, in a
    scene with joints, the joint-contact dedupe.  Both judge the lanes'
    incoming flags, as the JAX package's one `_dedupe` does.  The box pairs
    of all scenarios go through one narrowphase call (B * P pairs, P the
    scene's pairs or the broadphase's capacity)."""
    eps2 = cfg.min_constraint_distance ** 2
    K = cfg.contact_capacity
    dedupe = _dedupe_windowed if K >= WINDOWED_DEDUPE_MIN_K else _dedupe
    cs = dedupe(_compact(*_candidates(spec, states, cfg), K), eps2)
    if spec.num_joints > 0:
        a0, a1 = joint_anchors(spec, states)
        cs = drop_joint_contacts(cs, joint_points(a0, a1, spec.joint_b1), spec.joint_b0,
                                 spec.joint_b1, eps2)
    return cs


def make_contacts(spec: SceneSpec, state: State, cfg: SimConfig) -> ContactSet:
    """One scene's contacts, `state` without a batch axis: the batched
    contacts of a batch of one (the JAX package's batched contacts are the
    vmap of its per-scene ones), fields (K, ...)."""
    cs = make_contacts_batched(spec, State(*(x[None] for x in state)), cfg)
    return ContactSet(*(x[0] for x in cs))


def count_dropped_contacts(spec: SceneSpec, states: State, cfg: SimConfig) -> torch.Tensor:
    """(B,) int64: the active contact candidates of each scenario that do
    not fit into cfg.contact_capacity lanes, plus MAX_CONTACTS_PER_PAIR for
    each overlapping pair the broadphase left out at cfg.pair_capacity;
    0 where both capacities suffice.  Counterpart of the JAX package's
    `count_dropped_contacts` (one scene there)."""
    act = _candidates(spec, states, cfg)[5]
    dropped = torch.clamp(act.sum(dim=1) - cfg.contact_capacity, min=0)
    if broadphase_on(spec, cfg):
        mask = broadphase.pair_overlap_mask(states.p, states.q, spec.half_extents, spec.pair_i,
                                            spec.pair_j, cfg.broadphase_margin)
        pair_drop = torch.clamp(mask.sum(dim=1) - cfg.pair_capacity, min=0)
        dropped = dropped + pair_drop * collision.MAX_CONTACTS_PER_PAIR
    return dropped


def depth_cap(cfg: SimConfig):
    """max_correcting_vel * dt / erp, the deepest penetration the ERP
    correction sees; None when the cap is inf."""
    if math.isinf(cfg.max_correcting_vel):
        return None
    return cfg.max_correcting_vel * cfg.dt / max(cfg.erp, 1e-12)


def effective_depth(depth: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Depth seen by the ERP correction, saturated at `depth_cap`; the
    identity when the cap is inf."""
    cap = depth_cap(cfg)
    return depth if cap is None else torch.clamp(depth, max=cap)


def contact_frames(cs: ContactSet) -> torch.Tensor:
    """Rotations taking global vectors into the contact frame (z = the
    contact normal): AlignVectors(normal, z), (..., K, 3, 3)."""
    z = constant((0.0, 0.0, 1.0), cs.normal.dtype, cs.normal.device)
    return quat.align_vectors_mat(cs.normal, z.expand(cs.normal.shape))
