"""Matrix-free projected Jacobi for large scenes, with a leading scenario
axis: counterpart of `eggshell_tpu.ops.lcp_matrix_free`.

J M^-1 J^T is never formed.  The constraints come as compact blocks
(`physics.constraints.CompactConstraintSystem`): lane l's 3 rows touch body
b0[l] (columns 0:6 of its (3, 12) block) and body b1[l] (columns 6:12),
-1 being the ground or the world.  A matvec is J^T x summed per body, the
6x6 inverse masses, then J gathered back per lane.

The per-body sum ("scatter" side) has three forms, `matvec_mode`:

- "segment": `index_add_` into one bucket per body, the JAX package's
  `segment_sum`.  On CUDA its atomics add in no fixed order, so two runs
  can differ in the last bits.
- "onehot": the (n, 2L) body-incidence matrix, made once a solve, and two
  matmuls a matvec (the JAX package's TPU form).
- "sorted": the 2L lane slots sorted by body once a solve; a matvec gathers
  the slots in that order and sums each body's run of slots in turn
  (`torch.segment_reduce`, one thread a body and column on CUDA).  Fixed
  order, so the same bits every run.  (A running sum over the sorted
  slots, read at each run's ends, is not: CUB's one-pass scan groups its
  float sums by timing, and the captured and eager rollouts parted in the
  last bits.)

"auto" is "segment" on the CPU and, on CUDA, the form measured fastest of
the deterministic ones on the H100 at the pile shapes (AUTO_CUDA, PERF.md).
"""

from __future__ import annotations

from typing import Optional

import torch

MODES = ("segment", "onehot", "sorted")
# "auto" on a CUDA tensor: the deterministic form that was fastest at
# pile512 on the H100 (chip_smoke.py's [pile512] times all three)
AUTO_CUDA = "sorted"


def _mode(mode: str, like: torch.Tensor) -> str:
    if mode == "auto":
        return AUTO_CUDA if like.device.type == "cuda" else "segment"
    if mode not in MODES:
        raise ValueError(f"matvec_mode {mode!r}: expected 'auto' or one of {MODES}")
    return mode


class BodyIncidence:
    """Which bodies the lane slots touch, for the per-body sums and the
    per-lane gathers of one solve: b0 / b1 (B, L) int64, -1 for none; slot
    2l + s is lane l's body b_s.  `rows` bodies a sum: n for "onehot"
    (its incidence matrix held in `dtype`, the values' type), n + 1 for the
    others, row n the sum of the slots that touch no body, which a gather
    reads as a body of zero velocity (`pad`)."""

    def __init__(self, b0, b1, num_bodies: int, mode: str = "auto", dtype=torch.float32):
        self.mode = _mode(mode, b0)
        self.n = n = num_bodies
        B, L = b0.shape
        dev = b0.device
        seg = torch.stack([b0, b1], dim=-1).reshape(B, 2 * L)
        self.seg = torch.where(seg >= 0, seg, torch.full_like(seg, n))   # n = no body
        self.shape = (B, L)
        self.rows = n if self.mode == "onehot" else n + 1
        if self.mode == "onehot":
            body = torch.arange(n, device=dev)
            self.onehot = (self.seg[:, None, :] == body[:, None]).to(dtype)  # (B, n, 2L)
        elif self.mode == "sorted":
            order = torch.argsort(self.seg, dim=-1, stable=True)
            self.order = order[..., None].expand(B, 2 * L, 6)
            # the slots of body i are the i-th run of the sorted order; the
            # slots of no body come last and are left out (a run of length 0
            # for row n): one thread would add them all up in turn
            ends = torch.searchsorted(torch.gather(self.seg, 1, order),
                                      torch.arange(n, device=dev).expand(B, n).contiguous(),
                                      right=True)
            self.offsets = torch.cat([torch.zeros_like(ends[:, :1]), ends, ends[:, -1:]], dim=1)
        self.gather_idx = self.seg[..., None].expand(B, 2 * L, 6)

    def sum(self, c):
        """(B, rows, 6) per-body sums of c (B, L, 12): columns 0:6 go to b0,
        6:12 to b1."""
        B, L = self.shape
        c = c.reshape(B, 2 * L, 6)
        if self.mode == "onehot":
            return torch.matmul(self.onehot, c)
        if self.mode == "sorted":
            return torch.segment_reduce(torch.gather(c, 1, self.order), "sum",
                                        offsets=self.offsets, axis=1, unsafe=True)
        flat = (self.seg + (self.n + 1) * torch.arange(B, device=c.device)[:, None]).reshape(-1)
        y = torch.zeros((B * (self.n + 1), 6), dtype=c.dtype, device=c.device)
        return y.index_add_(0, flat, c.reshape(B * 2 * L, 6)).reshape(B, self.n + 1, 6)

    def pad(self, Minv):
        """Minv (B, n, 6, 6) with a zero block for row n where `rows` is n + 1."""
        if self.rows == self.n:
            return Minv
        return torch.cat([Minv, torch.zeros_like(Minv[:, :1])], dim=1)

    def gather(self, v):
        """(B, L, 12) per-lane [v_b0 | v_b1] of v (B, rows, 6); a slot that
        touches no body reads row n, which must be zero."""
        B, L = self.shape
        if self.mode == "onehot":
            return torch.matmul(self.onehot.transpose(1, 2), v).reshape(B, L, 12)
        return torch.gather(v, 1, self.gather_idx).reshape(B, L, 12)


def _rows_times(blocks, x):
    """(B, L, 12) sum_r blocks[l, r, :] x[l, r]: J^T x lane by lane."""
    B, L = blocks.shape[:2]
    return (blocks * x.reshape(B, L, 3, 1)).sum(dim=2)


def _apply_blocks(blocks, vl):
    """(B, 3L) sum_c blocks[l, r, c] vl[l, c]: J v lane by lane."""
    B, L = blocks.shape[:2]
    return (blocks * vl[:, :, None, :]).sum(dim=-1).reshape(B, 3 * L)


def compact_blocks(sys, cs, spec):
    """The compact (B, L, 3, 12) blocks and lane bodies (b0, b1) of a
    dense `physics.constraints.ConstraintSystem` (rows: joints, then
    contacts), L = joints + contact lanes."""
    B = sys.J.shape[0]
    n = spec.num_bodies
    Jn = spec.num_joints
    K = cs.capacity
    lanes_b0 = torch.cat([spec.joint_b0.expand(B, Jn), cs.b0], dim=1)
    lanes_b1 = torch.cat([spec.joint_b1.expand(B, Jn), cs.b1], dim=1)
    L = Jn + K
    rows = sys.J[:, :3 * L].reshape(B, L, 3, n, 6)

    def take(b):
        idx = b.clamp(0, n - 1)[:, :, None, None, None].expand(B, L, 3, 1, 6)
        blk = torch.gather(rows, 3, idx)[:, :, :, 0]
        return torch.where((b >= 0)[:, :, None, None], blk, torch.zeros_like(blk))

    return torch.cat([take(lanes_b0), take(lanes_b1)], dim=-1), lanes_b0, lanes_b1


def jt_x(blocks, b0, b1, x, num_bodies: int, mode: str = "auto"):
    """(B, n, 6) J^T x from the compact blocks, x (B, 3L)."""
    inc = BodyIncidence(b0, b1, num_bodies, mode, blocks.dtype)
    return inc.sum(_rows_times(blocks, x))[:, :num_bodies]


def j_v(blocks, b0, b1, v):
    """(B, 3L) J v for per-body velocities v (B, n, 6)."""
    inc = BodyIncidence(b0, b1, v.shape[1], "segment")
    return _apply_blocks(blocks, inc.gather(torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)))


def _jmjt(blocks, inc: BodyIncidence, Minv_rows, x):
    """J M^-1 J^T x, Minv_rows = inc.pad(Minv)."""
    y = (Minv_rows * inc.sum(_rows_times(blocks, x))[:, :, None, :]).sum(dim=-1)
    return _apply_blocks(blocks, inc.gather(y))


def jmjt_matvec(blocks, b0, b1, Minv, x, cfm: float = 0.0, mode: str = "auto"):
    """(J M^-1 J^T + cfm I) x without forming the matrix; Minv (B, n, 6, 6)."""
    inc = BodyIncidence(b0, b1, Minv.shape[1], mode, blocks.dtype)
    return _jmjt(blocks, inc, inc.pad(Minv), x) + cfm * x


def jmjt_diagonal(blocks, b0, b1, Minv, cfm: float = 0.0):
    """(B, 3L) diag(J M^-1 J^T) + cfm from the compact blocks alone."""
    B, L = blocks.shape[:2]
    n = Minv.shape[1]
    acc = torch.zeros((B, L, 3), dtype=blocks.dtype, device=blocks.device)
    for s, b in ((0, b0), (1, b1)):
        blk = blocks[..., 6 * s:6 * s + 6]                                  # (B, L, 3, 6)
        idx = b.clamp(0, n - 1)[:, :, None, None].expand(B, L, 6, 6)
        Mb = torch.gather(Minv, 1, idx)                                     # (B, L, 6, 6)
        Mb = torch.where((b >= 0)[:, :, None, None], Mb, torch.zeros_like(Mb))
        MbT = (Mb[:, :, None] * blk[:, :, :, None, :]).sum(dim=-1)          # (B, L, 3, 6)
        acc = acc + (blk * MbT).sum(dim=-1)
    return acc.reshape(B, 3 * L) + cfm


def solve_lcp_matrix_free(blocks, b0, b1, Minv, rhs, is_eq, lo, hi, iters: int = 60,
                          omega: float = 0.3, beta: float = 0.0, cfm: float = 0.0,
                          x0: Optional[torch.Tensor] = None, matvec_mode: str = "auto"):
    """Heavy-ball projected Jacobi on the matrix-free operator, the update
    rule of `ops.lcp.solve_lcp(method="jacobi")`:
    x <- P((1 - omega) x + omega (rhs - A x + d x) / d + beta (x - x_prev)),
    d = diag(A) (1 where not positive), P the clamp to [lo, hi] on
    inequality rows, from x = P(rhs) (or P(x0)), `iters` sweeps.  blocks
    (B, L, 3, 12), b0 / b1 (B, L), Minv (B, n, 6, 6), rhs / is_eq / lo / hi
    (B, 3L).  Returns x (B, 3L).

    A sweep is computed as x + (omega / d) (rhs - A x) + beta (x - x_prev),
    the same update in fewer operations (each one a launch on the card)."""
    diag = jmjt_diagonal(blocks, b0, b1, Minv, cfm)
    step = omega / torch.where(diag > 0, diag, torch.ones_like(diag))
    inc = BodyIncidence(b0, b1, Minv.shape[1], matvec_mode, blocks.dtype)
    Minv_rows = inc.pad(Minv)

    def project(x):
        return torch.where(is_eq, x, torch.clamp(x, min=lo, max=hi))

    x = project(rhs if x0 is None else x0)
    xp = x
    for _ in range(iters):
        res = torch.sub(rhs - _jmjt(blocks, inc, Minv_rows, x), x, alpha=cfm)
        nxt = torch.add(torch.addcmul(x, step, res), x - xp, alpha=beta)
        x, xp = project(nxt), x
    return x
