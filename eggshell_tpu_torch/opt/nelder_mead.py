"""Nelder-Mead simplex minimisation, counterpart of
`eggshell_tpu.opt.nelder_mead`, with a fixed iteration budget and the
standard coefficients: reflection 1, expansion 2, contraction 0.5, shrink
0.5.

The loop runs max_iterations times with no host read: once the simplex
has shrunk to xtol the remaining iterations leave it as it is, so the
result and the iteration count are those of the JAX package's while loop.
The objective takes a (n,) tensor to a scalar and is `torch.func.vmap`-ped
over the simplex.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class NMResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    iterations: torch.Tensor


def nelder_mead(fn: Callable[[torch.Tensor], torch.Tensor], x0, initial_step: float = 0.1,
                max_iterations: int = 200, xtol: float = 1e-10) -> NMResult:
    x0 = torch.as_tensor(x0)
    n = x0.shape[0]
    simplex = torch.cat([x0[None, :],
                         x0[None, :] + initial_step * torch.eye(n, dtype=x0.dtype,
                                                                device=x0.device)])
    fvals = torch.func.vmap(fn)(simplex)
    it = torch.zeros((), dtype=torch.int64, device=x0.device)
    for _ in range(max_iterations):
        active = torch.max(torch.linalg.norm(simplex - simplex[0][None, :], dim=-1)) > xtol
        order = torch.argsort(fvals, stable=True)
        s = simplex[order]
        fs = fvals[order]
        best, worst = fs[0], fs[-1]
        centroid = torch.mean(s[:-1], dim=0)

        xr = centroid + (centroid - s[-1])
        fr = fn(xr)
        xe = centroid + 2.0 * (centroid - s[-1])
        fe = fn(xe)
        xc = centroid + 0.5 * (s[-1] - centroid)
        fc = fn(xc)

        # the replacement for the worst vertex
        use_expand = (fr < best) & (fe < fr)
        use_reflect = (fr < fs[-2]) & ~use_expand
        use_contract = ~use_expand & ~use_reflect & (fc < worst)
        new_vertex = torch.where(use_expand, xe, torch.where(use_reflect, xr, xc))
        new_f = torch.where(use_expand, fe, torch.where(use_reflect, fr, fc))
        replaced = use_expand | use_reflect | use_contract

        s_rep = torch.cat([s[:-1], new_vertex[None]])
        f_rep = torch.cat([fs[:-1], new_f[None]])
        # shrink toward the best vertex when nothing helped
        shrunk = s[0][None, :] + 0.5 * (s - s[0][None, :])
        f_shrunk = torch.func.vmap(fn)(shrunk)
        s = torch.where(replaced, s_rep, shrunk)
        fs = torch.where(replaced, f_rep, f_shrunk)

        simplex = torch.where(active, s, simplex)
        fvals = torch.where(active, fs, fvals)
        it = it + active.to(it.dtype)
    i = torch.argmin(fvals)
    return NMResult(x=simplex[i], fun=fvals[i], iterations=it)
