"""Batched SAT narrowphase: the hand-written CUDA kernel and its wrapper.

Counterpart of `eggshell_tpu.ops.collision_kernel.collide_boxes_lanes`.
On a CUDA tensor the wrapper launches `csrc/narrowphase.cu`; on a CPU
tensor it runs the plain version `ops.collision.collide_boxes`.  There is
no fallback from one to the other: a CUDA input that the kernel does not
take raises.
"""

from __future__ import annotations

import torch

from eggshell_tpu_torch.ops.collision import MAX_POLY, PairContacts, collide_boxes


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
    pos = torch.empty((N, MAX_POLY, 3), dtype=torch.float32, device=dev)
    nrm = torch.empty((N, 3), dtype=torch.float32, device=dev)
    dep = torch.empty((N, MAX_POLY), dtype=torch.float32, device=dev)
    act = torch.empty((N, MAX_POLY), dtype=torch.bool, device=dev)
    code = torch.empty((N,), dtype=torch.int32, device=dev)
    idep = torch.empty((N,), dtype=torch.float32, device=dev)
    iax = torch.empty((N, 3), dtype=torch.float32, device=dev)
    kernels.launch("eggshell_narrowphase_f32", dev, p1, R1, hs1, p2, R2, hs2, pos, nrm, dep, act,
                   code, idep, iax, N)
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
