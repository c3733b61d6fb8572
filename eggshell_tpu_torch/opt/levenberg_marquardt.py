"""Levenberg-Marquardt least squares, counterpart of
`eggshell_tpu.opt.levenberg_marquardt`.

Minimises ||r(x)||^2 for a residual function r: R^n -> R^m written in
torch.  The Jacobian comes from `torch.func.jacfwd` (forward mode), and the
damped normal equations (JtJ + lambda diag(JtJ)) dx = -Jt r are solved
densely with `torch.linalg.solve`; lambda adapts by the accept/reject rule.
Everything stays on x0's device; the loop reads its condition (error,
stall) on the host once an iteration, where the JAX package's while loop
decides on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class LMOptions:
    max_iterations: int = 50
    max_error: float = 0.0           # stop when ||r||^2 <= max_error
    initial_lambda: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    min_lambda: float = 1e-12
    max_lambda: float = 1e12


class LMResult(NamedTuple):
    x: torch.Tensor
    error: torch.Tensor          # final ||r||^2
    iterations: int
    converged: torch.Tensor


def levenberg_marquardt(residual_fn: Callable[[torch.Tensor], torch.Tensor], x0,
                        options: LMOptions = LMOptions()) -> LMResult:
    """Iterate from x0 until the error is at most max_error, max_iterations
    are spent, or a step is rejected at max_lambda.  The condition is read
    on the host before each iteration: iterations + 1 reads in all, fewer
    when the budget ends the loop."""
    opts = options
    x = torch.as_tensor(x0)

    def err2(x):
        r = residual_fn(x)
        return torch.sum(r * r)

    e = err2(x)
    lam = torch.tensor(opts.initial_lambda, dtype=x.dtype, device=x.device)
    stalled = torch.zeros((), dtype=torch.bool, device=x.device)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    it = 0
    while it < opts.max_iterations and bool((e > opts.max_error) & ~stalled):
        r = residual_fn(x)
        J = torch.func.jacfwd(residual_fn)(x)
        JtJ = J.T @ J
        g = J.T @ r
        damped = JtJ + lam * torch.diag(torch.diagonal(JtJ))
        damped = damped + 1e-30 * eye           # guard fully-zero diagonals
        dx = -torch.linalg.solve(damped, g)
        e_new = err2(x + dx)
        accept = e_new < e
        x = torch.where(accept, x + dx, x)
        lam = torch.where(accept, torch.clamp(lam * opts.lambda_down, min=opts.min_lambda),
                          torch.clamp(lam * opts.lambda_up, max=opts.max_lambda))
        e = torch.where(accept, e_new, e)
        stalled = ~accept & (lam >= opts.max_lambda)
        it += 1
    return LMResult(x=x, error=e, iterations=it, converged=e <= opts.max_error)
