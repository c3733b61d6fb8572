"""Simulation configuration of the port.

The same frozen dataclass and enums as `eggshell_tpu.utils.config`, field
for field and default for default (a test holds the two equal), so one
`SimConfig` JSON configures either package.  The port keeps its own copy
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Optional, Tuple


class FrictionModel(enum.IntEnum):
    NO_FRICTION = 0
    INFINITE = 1
    BOX = 2
    COULOMB_PYRAMID = 3


class SolverKind(enum.IntEnum):
    PGS = 0
    JACOBI = 1
    SOR = 2
    DIRECT = 3
    JACOBI_KERNEL = 4
    MATRIX_FREE = 5


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters; see `eggshell_tpu.utils.config` for
    the meaning and the reference source of each field."""

    dt: float = 1e-3
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.8)
    erp: float = 0.2
    cfm: float = 0.01
    conditional_cfm: bool = True
    cfm_always: float = 0.0
    friction_model: FrictionModel = FrictionModel.BOX
    friction_bound: float = 1.0
    friction_mu: float = 0.5
    solver: SolverKind = SolverKind.PGS
    solver_iters: int = 100
    solver_tol: float = 0.0
    sor_omega: float = 1.5
    jacobi_omega: float = 0.3
    jacobi_beta: float = 0.0
    jacobi_block: bool = False
    good_condition_number: float = 1e7
    # "exact": full eigvalsh; "power": power + inverse iteration through
    # one Cholesky factor.
    cond_estimator: str = "exact"
    min_constraint_distance: float = 1e-6
    max_correcting_vel: float = float("inf")
    ref_app_bounds: bool = False
    contact_capacity: int = 64
    pair_capacity: int = 0
    broadphase_margin: float = 0.0
    broadphase_kind: str = "mask"
    sap_window: int = 64
    # The JAX package's narrowphase switch.  Its two sides compute the same
    # contacts.  The port's unfused contacts read it on the card
    # (`physics.contacts.box_pair_narrowphase`: False takes the plain
    # narrowphase, True refuses float64); the fused chain ignores it.
    contact_kernel: Optional[bool] = None

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["friction_model"] = int(self.friction_model)
        d["solver"] = int(self.solver)
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "SimConfig":
        d = json.loads(s)
        d["friction_model"] = FrictionModel(d["friction_model"])
        d["solver"] = SolverKind(d["solver"])
        d["gravity"] = tuple(d["gravity"])
        return SimConfig(**d)


# The bench configuration (bench.py:80-94), which takes the fused contact
# chain: 16 heavy-ball Jacobi sweeps, always-on CFM, 20 contact lanes.
BENCH = SimConfig(solver=SolverKind.JACOBI_KERNEL, solver_iters=16, solver_tol=0.0,
                  jacobi_omega=0.3, jacobi_beta=0.45, conditional_cfm=False, cfm_always=0.01,
                  contact_capacity=20)
