"""Seeded box poses on which the narrowphase kernels are held against their
plain version (`chip_smoke.py`, `tests/test_torch_kernels.py`,
`tests/test_torch_narrowphase_plan.py`).

All of it is numpy from a seeded generator: random bodies, the pair list of
n bodies, and two-box scenarios in seven degenerate poses, with the
agreement the kernels were measured to reach on them.
"""

from __future__ import annotations

import numpy as np
import torch

# The poses of `degenerate_bodies`, by scenario mod 7.
POSE_CLASSES = ("aligned stack", "exactly touching", "coincident centres", "separated",
                "deep penetration", "turned stack", "generic")
# Active-lane agreement of B2 with the plain version, where their contact
# codes agree, over all lanes of each pose class of `degenerate_args()`:
# what the kernel reached on the card (PERF.md).  Their codes agree on
# every pair, and their flags on every lane off the reference face
# (`ON_FACE`); the lanes that differ are clip points on the reference
# face, whose |depth| > TOL test is decided by rounding.
DEGENERATE_FLAG_AGREEMENT = {
    "aligned stack": 1.0, "exactly touching": 1.0, "coincident centres": 1.0, "separated": 1.0,
    "deep penetration": 0.998717, "turned stack": 1.0, "generic": 0.993874,
}
# A lane whose depth is this close to 0 in either version lies on the
# reference face.
ON_FACE = 1e-5


def pair_list(n: int):
    """Every pair (i, j), i < j, of n bodies, as two int64 arrays."""
    i, j = np.triu_indices(n, 1)
    return i.astype(np.int64), j.astype(np.int64)


def random_bodies(rng, B, n, xy=(-0.4, 0.4), z=(-0.4, 0.4)):
    """Seeded random poses of n boxes in B scenarios, float64 numpy: p with
    x and y in `xy`, z in `z`, unit q, half extents (n, 3) in [0.1, 0.3]."""
    p = rng.uniform(*xy, (B, n, 3))
    p[..., 2] = rng.uniform(*z, (B, n))
    q = rng.normal(size=(B, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return p, q, rng.uniform(0.1, 0.3, (n, 3))


def degenerate_bodies(B: int, rng):
    """B two-box scenarios in the packed entry's form (p (B, 2, 3), q (B, 2,
    4), half extents (2, 3), the pair (0, 1)) in the seven POSE_CLASSES, by
    scenario mod 7: 0 an aligned stack overlapping by 10 % (every edge axis
    invalid or a face normal again), 1 exactly touching, 2 coincident
    centres, 3 separated, 4 deep penetration (random orientations, centres
    within 5 cm: face, edge-edge and code 16 contacts), 5 an aligned stack
    with the top box turned about z, 6 generic.  Returns float64 numpy
    arrays and the class of each scenario."""
    hs = np.array([[0.3, 0.2, 0.1], [0.25, 0.4, 0.15]])   # no two axes' extents tie
    kind = np.arange(B) % 7
    p = np.zeros((B, 2, 3))
    p[:, 0] = rng.uniform(-1, 1, (B, 3))
    q = np.zeros((B, 2, 4))
    q[..., 0] = 1.0
    turned = rng.normal(size=(B, 2, 4))
    turned /= np.linalg.norm(turned, axis=-1, keepdims=True)
    q[kind >= 4] = turned[kind >= 4]
    angle = rng.uniform(0, np.pi, B)
    q[kind == 5, 1] = np.stack([np.cos(angle / 2), 0 * angle, 0 * angle, np.sin(angle / 2)],
                               -1)[kind == 5]
    q[kind == 5, 0] = [1.0, 0.0, 0.0, 0.0]
    gap = hs[0, 2] + hs[1, 2]
    lift = np.select([kind == 0, kind == 1, kind == 2, kind == 3, kind == 5],
                     [0.9 * gap, gap, 0.0, 2.0 * gap, 0.95 * gap], 0.0)
    p[:, 1] = p[:, 0]
    p[:, 1, 2] += lift
    p[kind == 4, 1] += rng.uniform(-0.05, 0.05, (B, 3))[kind == 4]
    p[kind == 6, 1] += rng.uniform(-0.6, 0.6, (B, 3))[kind == 6]
    return p, q, hs, kind


def degenerate_args(dev, B: int = 4099, seed: int = 3):
    """`degenerate_bodies` from `np.random.default_rng(seed)` as the packed
    entry's arguments on `dev` (p, q, half extents, pair_i, pair_j), and
    the class of each scenario as a tensor on `dev`.  B = 4099 is no
    multiple of the pairs a block or a warp takes."""
    p, q, hs, kind = degenerate_bodies(B, np.random.default_rng(seed))
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    i = lambda x: torch.tensor(x, dtype=torch.int64, device=dev)
    return (f(p), f(q), f(hs), i([0]), i([1])), torch.as_tensor(kind, device=dev)


def class_agreement(got, want, kind):
    """Per pose class of `degenerate_bodies`, for two versions' contacts
    (`PairContacts`, one pair a scenario): (code agreement, active-lane
    agreement where the codes agree, the same on lanes off the reference
    face), counted exactly."""
    off_face = (got.depth.abs() > ON_FACE) & (want.depth.abs() > ON_FACE)
    flags = got.active == want.active
    out = {}
    for c, name in enumerate(POSE_CLASSES):
        sel = kind == c
        same = got.code[sel] == want.code[sel]
        lanes = flags[sel][same]
        off = lanes[off_face[sel][same]]
        out[name] = tuple(int(x.sum()) / x.numel() if x.numel() else 1.0
                          for x in (same, lanes, off))
    return out
