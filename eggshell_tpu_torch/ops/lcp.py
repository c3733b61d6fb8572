"""Pieces of the projected-Jacobi LCP iteration, batched.

Counterpart of the parts of `eggshell_tpu.ops.lcp` that the plain version
of the Jacobi kernel needs.  Problem: A x = b + w with, per row, either
an equality (w = 0, x free) or box bounds lo <= x <= hi with
complementarity.  Every function takes a leading scenario dimension.
"""

from __future__ import annotations

import torch


def project(x, is_eq, lo, hi):
    """Clamp inequality rows to [lo, hi]; equality rows pass through."""
    return torch.where(is_eq, x, torch.minimum(torch.maximum(x, lo), hi))


def jacobi_momentum_sweep(A, b, diag, inv_diag, x, x_prev, is_eq, lo, hi,
                          omega: float, beta: float):
    """One under-relaxed heavy-ball projected Jacobi sweep,
    x <- proj((1 - omega) x + omega r D^-1 + beta (x - x_prev)) with
    r = b - A x + D x.  A (B, m, m), vectors (B, m).  Returns (x_new, x)."""
    ax = torch.einsum("bij,bj->bi", A, x)
    r = b - ax + diag * x
    xn = project((1.0 - omega) * x + omega * r * inv_diag + beta * (x - x_prev),
                 is_eq, lo, hi)
    return xn, x
