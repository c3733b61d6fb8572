"""Contact compaction and dedupe of the fused chain (B3): the hand-written
CUDA kernel and its wrapper.

Counterpart of `eggshell_tpu.ops.compact_kernel.compact_contacts_packed`
and its ground-only variant.  From the bodies' state (ground corners) and
the packed narrowphase's lanes (`ops.collision_kernel.
collide_boxes_lanes_packed`), it writes the K contact lanes of every
scenario as a `ContactSet`, as the Jacobian-block kernel takes them:

- candidates: the ground corners, 8 per body, body-major, then pair k's 12
  lanes, with b0 = pair_i[k], b1 = pair_j[k] (pair_i[s, k] and
  pair_j[s, k] where the lists are the broadphase's, one a scenario);
- depth capped at `depth_cap` (None: no cap);
- stable compaction: active candidate number o goes to lane o, those past
  K are dropped; lanes never filled have b0 = b1 = -1 and zero geometry;
- non-cascaded same-pair dedupe: lane k is dropped (active cleared, ids
  kept) when an earlier lane has the same unordered body pair, neither a
  ground lane, both active before dedupe, closer than sqrt(eps2).

On a CUDA tensor the wrapper launches `csrc/compact.cu`; on a CPU tensor it
runs the plain version.  A CUDA input that the kernel does not take raises.
"""

from __future__ import annotations

import torch

from eggshell_tpu_torch.ops.collision import MAX_CONTACTS_PER_PAIR
from eggshell_tpu_torch.physics import contacts
from eggshell_tpu_torch.physics.contacts import ContactSet


def compact_contacts_plain(p, q, half_extents, ground_enabled, pair, pair_i, pair_j, K: int,
                           eps2: float, depth_cap=None) -> ContactSet:
    """Plain torch version of the kernel: `contacts.ground_candidates` and
    `contacts.pair_candidates`, the cap, `contacts._compact`, then
    `contacts._dedupe`.  p (B, n, 3), q (B, n, 4), half_extents (n, 3),
    ground_enabled (n,) bool; pair None (no pairs) or the packed
    narrowphase's (pos (B, P, 12, 3), nrm (B, P, 3), dep (B, P, 12),
    act (B, P, 12) bool); pair_i / pair_j (P,) int64, shared by every
    scenario, or (B, P), a list a scenario."""
    parts = [contacts.ground_candidates(p, q, half_extents, ground_enabled)]
    if pair is not None:
        parts.append(contacts.pair_candidates(pair, pair_i, pair_j))
    b0, b1, pos, nrm, dep, act = (torch.cat([part[i] for part in parts], dim=1)
                                  for i in range(6))
    if depth_cap is not None:
        dep = torch.clamp(dep, max=depth_cap)
    return contacts._dedupe(contacts._compact(b0, b1, pos, nrm, dep, act, K), eps2)


def compact_contacts(p, q, half_extents, ground_enabled, pair, pair_i, pair_j, K: int,
                     eps2: float, depth_cap=None) -> ContactSet:
    """The K contact lanes of every scenario; see `compact_contacts_plain`
    for the arguments.  One kernel takes both variants: with pairs, and
    ground only (`pair` None)."""
    if p.device.type == "cpu":
        return compact_contacts_plain(p, q, half_extents, ground_enabled, pair, pair_i, pair_j,
                                      K, eps2, depth_cap)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    from eggshell_tpu_torch import kernels

    B, n = p.shape[:2]
    dev = p.device
    f32 = torch.float32
    C = MAX_CONTACTS_PER_PAIR
    args = [("p", p, (B, n, 3), f32), ("q", q, (B, n, 4), f32),
            ("half_extents", half_extents, (n, 3), f32),
            ("ground_enabled", ground_enabled, (n,), torch.bool)]
    P = 0
    pp = (None,) * 4
    stride = 0
    if pair is not None:
        P = pair_i.shape[-1]
        stride = P if pair_i.dim() == 2 else 0
        ids = (B, P) if stride else (P,)
        pp = pair
        args += [("pair_pos", pair[0], (B, P, C, 3), f32), ("pair_nrm", pair[1], (B, P, 3), f32),
                 ("pair_dep", pair[2], (B, P, C), f32),
                 ("pair_act", pair[3], (B, P, C), torch.bool),
                 ("pair_i", pair_i, ids, torch.int64), ("pair_j", pair_j, ids, torch.int64)]
    for name, x, shape, dtype in args:
        kernels.check_arg(name, x, shape, dtype, dev)
    if P and pair[3].data_ptr() % 4:
        raise ValueError("pair_act must be 4-byte aligned: the kernel reads its flags as "
                         "32-bit words")
    b0 = torch.empty((B, K), dtype=torch.int64, device=dev)
    b1 = torch.empty((B, K), dtype=torch.int64, device=dev)
    pos = torch.empty((B, K, 3), dtype=f32, device=dev)
    nrm = torch.empty((B, K, 3), dtype=f32, device=dev)
    dep = torch.empty((B, K), dtype=f32, device=dev)
    act = torch.empty((B, K), dtype=torch.bool, device=dev)
    cap = float("inf") if depth_cap is None else float(depth_cap)
    kernels.launch("eggshell_compact_f32", dev, p, q, half_extents, ground_enabled, *pp,
                   pair_i if P else None, pair_j if P else None, b0, b1, pos, nrm, dep, act,
                   B, n, P, stride, K, float(eps2), cap)
    compact_contacts.launches += 1
    return ContactSet(b0=b0, b1=b1, position=pos, normal=nrm, depth=dep, active=act)


compact_contacts.launches = 0
