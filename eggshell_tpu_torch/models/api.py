"""Parametric model API, counterpart of `eggshell_tpu.models.api`.

A model is a function `build(params) -> problem` (for example a mesh and
its FEM configuration) or any params -> outputs callable.  `Parameter`
declares a named, bounded, optimizable knob.  `Model` provides:

  run(params)        build + solve, with an md5-keyed cache of repeated
                     solves (the key hashes the clipped parameters)
  sweep(name, vals)  a 1-D parameter sweep
  optimize(...)      SciPy's Nelder-Mead or a NumPy random search over the
                     parameters, on the host, for any objective

The solver may run on the card; the parameters and the objective's value
are host floats.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Parameter:
    label: str
    min: float
    max: float
    default: Optional[float] = None
    integer: bool = False

    def __post_init__(self):
        if self.default is None:
            self.default = 0.5 * (self.min + self.max)


class Model:
    """Holds a builder and parameters; runs, sweeps, optimizes."""

    def __init__(
        self,
        builder: Callable[[Dict[str, float]], object],
        parameters: Sequence[Parameter],
        solver: Optional[Callable[[object], object]] = None,
        output: Optional[Callable[[object], float]] = None,
    ):
        """builder(params_dict) -> problem; solver(problem) -> solution
        (defaults to identity, for models whose builder already solves);
        output(solution) -> scalar objective for sweep/optimize."""
        self.builder = builder
        self.parameters = list(parameters)
        self.solver = solver or (lambda x: x)
        self.output = output
        self._cache: Dict[str, object] = {}

    def _defaults(self) -> Dict[str, float]:
        return {p.label: p.default for p in self.parameters}

    def _clip(self, params: Dict[str, float]) -> Dict[str, float]:
        out = {}
        for p in self.parameters:
            v = float(params.get(p.label, p.default))
            v = min(max(v, p.min), p.max)
            if p.integer:
                v = round(v)
            out[p.label] = v
        return out

    def run(self, params: Optional[Dict[str, float]] = None):
        from eggshell_tpu_torch.utils.hashing import hash_config

        params = self._clip(params or self._defaults())
        key = hash_config(params)
        if key not in self._cache:
            self._cache[key] = self.solver(self.builder(params))
        return self._cache[key]

    def sweep(self, name: str, values: Sequence[float]) -> List[float]:
        assert self.output is not None, "sweep needs an output function"
        out = []
        for v in values:
            params = self._defaults()
            params[name] = v
            out.append(float(self.output(self.run(params))))
        return out

    def optimize(self, algorithm: str = "nelder_mead", **kw):
        """Minimise output over the parameters.  Returns (best_params,
        best_value)."""
        assert self.output is not None, "optimize needs an output function"

        names = [p.label for p in self.parameters]
        lo = np.asarray([p.min for p in self.parameters])
        hi = np.asarray([p.max for p in self.parameters])
        x0 = np.asarray([self._defaults()[n] for n in names])

        def fn(x):
            params = {n: float(v) for n, v in zip(names, np.asarray(x))}
            return float(self.output(self.run(params)))

        if algorithm == "nelder_mead":
            # a host-side simplex over any objective
            from scipy.optimize import minimize

            res = minimize(
                fn, x0, method="Nelder-Mead",
                bounds=list(zip(lo, hi)),
                options=kw or {"maxiter": 200, "xatol": 1e-6},
            )
            best_x, best_f = res.x, float(res.fun)
        elif algorithm == "random_search":
            rng = np.random.default_rng(kw.get("seed", 0))
            n = kw.get("num_samples", 256)
            xs = rng.uniform(lo, hi, size=(n, len(names)))
            fs = [fn(x) for x in xs]
            i = int(np.argmin(fs))
            best_x, best_f = xs[i], float(fs[i])
        else:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        return {n: float(v) for n, v in zip(names, best_x)}, best_f
