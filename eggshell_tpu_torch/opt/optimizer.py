"""Iterative optimizer framework, counterpart of `eggshell_tpu.opt.optimizer`.

The stepwise protocol (`AbstractOptimizer`: initialize, step, best) lets a
caller interleave optimisation with logging, checkpointing or an early
abort; `RepeatedOptimizer` restarts from jittered starts to escape local
minima; `OptimizerFactory` maps the algorithm names to the torch
optimizers of this package.  The protocol speaks NumPy: parameter vectors
in, (x, f) out.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


class AbstractOptimizer:
    """Stepwise protocol: initialize() yields the first parameter vector;
    step(error) consumes the objective at the last parameters and yields
    the next ones, or None when done."""

    def initialize(self, x0: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def step(self, error: float) -> Optional[np.ndarray]:
        raise NotImplementedError

    def best(self) -> Tuple[np.ndarray, float]:
        raise NotImplementedError


class _FnDrivenOptimizer(AbstractOptimizer):
    """Adapts a batch optimizer into the stepwise protocol by running it
    whole on initialize."""

    def __init__(self, run: Callable[[np.ndarray], Tuple[np.ndarray, float]]):
        self._run = run
        self._best = None

    def initialize(self, x0):
        x, f = self._run(np.asarray(x0, float))
        self._best = (np.asarray(x), float(f))
        return None

    def step(self, error):
        return None

    def best(self):
        return self._best


class RepeatedOptimizer(AbstractOptimizer):
    """Run an optimizer `repeats` times from jittered starts (a NumPy
    `default_rng(seed)`), keep the best."""

    def __init__(self, make: Callable[[], AbstractOptimizer], repeats: int = 3,
                 jitter: float = 0.1, seed: int = 0):
        self.make = make
        self.repeats = repeats
        self.jitter = jitter
        self.seed = seed
        self._best = None

    def initialize(self, x0):
        rng = np.random.default_rng(self.seed)
        for i in range(self.repeats):
            start = np.asarray(x0, float)
            if i > 0:
                start = start + rng.normal(scale=self.jitter, size=start.shape)
            opt = self.make()
            opt.initialize(start)
            cand = opt.best()
            if cand is not None and (self._best is None or cand[1] < self._best[1]):
                self._best = cand
        return None

    def step(self, error):
        return None

    def best(self):
        return self._best


class OptimizerFactory:
    """Map algorithm names to optimizers over a scalar objective
    f: R^n -> R written in torch.  Names: 'nelder_mead', 'random_search'
    (within `bounds` = (lower, upper)), 'levenberg_marquardt' (f as a
    single residual)."""

    @staticmethod
    def create(name: str, fn: Callable, *, bounds=None, generator=None, device="cuda",
               **kw) -> AbstractOptimizer:
        """The optimizer `name` over `fn`, its tensors float64 on `device`.
        random_search draws from `generator` (default: seeded 0 on
        `device`); every run starts from the generator's state at creation,
        as every run of the JAX package reuses its key."""
        from eggshell_tpu_torch.opt.levenberg_marquardt import LMOptions, levenberg_marquardt
        from eggshell_tpu_torch.opt.nelder_mead import nelder_mead
        from eggshell_tpu_torch.opt.random_search import random_search

        def tensor(a):
            return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=device)

        if name == "nelder_mead":
            def run(x0):
                res = nelder_mead(fn, tensor(x0), **kw)
                return res.x.cpu().numpy(), float(res.fun)

        elif name == "random_search":
            lo, hi = bounds
            if generator is None:
                generator = torch.Generator(device).manual_seed(0)
            state = generator.get_state()

            def run(x0):
                generator.set_state(state)
                res = random_search(fn, tensor(lo), tensor(hi), generator, **kw)
                return res.x.cpu().numpy(), float(res.fun)

        elif name == "levenberg_marquardt":
            def residual(x):
                return torch.atleast_1d(fn(x))

            def run(x0):
                res = levenberg_marquardt(residual, tensor(x0), kw.get("options", LMOptions()))
                return res.x.cpu().numpy(), float(res.error)

        else:
            raise ValueError(f"unknown optimizer {name!r}")
        return _FnDrivenOptimizer(run)
