"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the card's published peaks, the least time of a piece of
work, and the work a contact step needs, counted from the cell's shapes and
from the contacts the plain reference finds in the cell's own states.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit: HBM3
at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s (the
program's step is float32 and uses no tensor cores).
"""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

FLOAT_BYTES = 4              # the configurations state float32
STATE_FLOATS = 13            # p (3), v (3), q (4), w (3) a body
BODY_CONST_FLOATS = 22       # inv_mass 1, inertia 9, inverse inertia 9, half extents 3
PAIR_CONST_BYTES = 16        # two int64 body ids a candidate pair
ROWS_PER_CONTACT = 3         # the normal and two friction directions
# W = J M^-1, a row's 6 columns on one free body: the linear 3 scaled by the
# body's inverse mass (3), the angular 3 through its 3x3 inverse inertia
# (9 multiply-adds).
W_FLOPS_PER_ROW_BODY = 3 + 2 * 9
# A_ij = W_i . J_j over the 6 columns of one body both rows act on.
A_FLOPS_PER_ENTRY_BODY = 2 * 6
SWEEP_FLOPS_PER_NONZERO = 2  # a multiply-add of A x


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the float32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def step_bytes(config: dict, batch: int) -> float:
    """The bytes one step of `batch` scenarios must move through HBM: each
    scenario's state read once and written once, and the scene's
    constants (bodies and candidate pairs) read once."""
    sc = config["scene"]
    n = len(sc["positions"])
    free = [not st for st in sc["static"]]
    pairs = sum(1 for i in range(n) for j in range(i + 1, n) if free[i] or free[j])
    return float(2 * batch * n * STATE_FLOATS * FLOAT_BYTES
                 + n * BODY_CONST_FLOATS * FLOAT_BYTES + pairs * PAIR_CONST_BYTES)


def contact_flops(free: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor,
                  active: torch.Tensor, sweeps: int) -> float:
    """The float32 operations the solve of these contacts needs, summed
    over the scenarios: `free` (n,) marks the bodies with mass; `b0`, `b1`
    (B, K) are the two bodies of each contact lane (-1 the ground) and
    `active` (B, K) the lanes that hold a contact after compaction and
    dedupe.  Only what the contacts need is counted:

    - W = J M^-1: each active row on each free body it acts on;
    - A = W J^T, symmetric: each entry on or above the diagonal whose two
      rows act on a free body in common, once for each such body;
    - `sweeps` products A x over A's nonzeros, the entries of two rows
      that share a free body (both triangles).

    Lanes without a contact, and entries between contacts that share no
    free body, need no work.  The narrowphase, the compaction, the
    right-hand side, the projection and the integration are not counted:
    leaving them out only lowers the bound."""
    bodies = torch.arange(free.shape[0], device=b0.device)
    on = (((b0[..., None] == bodies) | (b1[..., None] == bodies)) & free.to(b0.device)
          & active[..., None]).to(torch.float64)              # (B, K, n)
    shared = on @ on.transpose(-1, -2)                         # (B, K, K) free bodies in common
    r = ROWS_PER_CONTACT
    w = W_FLOPS_PER_ROW_BODY * r * on.sum()
    # r*r row pairs of two different contacts, r*(r+1)/2 within one, upper triangle
    diag = torch.diagonal(shared, dim1=-2, dim2=-1).sum()
    a = A_FLOPS_PER_ENTRY_BODY * (r * r * (shared.sum() - diag) / 2 + r * (r + 1) / 2 * diag)
    nonzeros = r * r * (shared > 0).sum()
    return float(w + a + sweeps * SWEEP_FLOPS_PER_NONZERO * nonzeros)


class Tally:
    """The contact work of the reference's steps: `add` takes a step's
    contacts (its `tally` hook); `per_scenario_step` is the mean flops a
    scenario-step, or None before any step."""

    def __init__(self, free: torch.Tensor, sweeps: int):
        self.free, self.sweeps = free, sweeps
        self.flops, self.scenario_steps = 0.0, 0

    def add(self, b0, b1, active) -> None:
        self.flops += contact_flops(self.free, b0, b1, active, self.sweeps)
        self.scenario_steps += b0.shape[0]

    def per_scenario_step(self):
        return self.flops / self.scenario_steps if self.scenario_steps else None
