"""Random-search optimisation, counterpart of
`eggshell_tpu.opt.random_search`: uniform samples within bounds, all
evaluated in one `torch.func.vmap` of the objective, the best kept.  The
samples come from a `torch.Generator` where the JAX package takes a key.
An objective that `vmap` cannot map raises; there is no loop to fall back
to."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class RSResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor


def _search_from_samples(fn: Callable, lower, upper, u) -> RSResult:
    """The search over the unit samples `u` (S, n) in [0, 1): the points
    lower + u (upper - lower), each evaluated, the lowest kept."""
    xs = lower[None, :] + u * (upper - lower)[None, :]
    fs = torch.func.vmap(fn)(xs)
    i = torch.argmin(fs)
    return RSResult(x=xs[i], fun=fs[i])


def random_search(fn: Callable[[torch.Tensor], torch.Tensor], lower, upper,
                  generator: torch.Generator, num_samples: int = 1024) -> RSResult:
    """Minimise `fn` over the box [lower, upper] by `num_samples` uniform
    samples drawn on `generator` (one `torch.rand` on its device, in
    lower's dtype), evaluated where lower lies."""
    lower, upper = torch.as_tensor(lower), torch.as_tensor(upper)
    u = torch.rand((num_samples, lower.shape[0]), generator=generator, dtype=lower.dtype,
                   device=generator.device)
    return _search_from_samples(fn, lower, upper.to(lower), u.to(lower.device))
