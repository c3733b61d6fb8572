"""Good-conductor (finite-conductivity) loss models — the analogs of the
reference's util.PaintMetal / util.PortMetal
(rama/user_script_util.lua:595-652, "Cavity Metallic Loss" model).

Two loss mechanisms for a 2D cavity of out-of-plane depth d:

* floor/ceiling loss -> an equivalent IMAGINARY part of the dielectric
  constant painted over the region (`metal_epsilon`), because the
  out-of-plane mode samples the lossy end walls;
* side-wall loss -> a complex Robin (surface-impedance) boundary
  coefficient (`metal_wall_alpha`), painted with Shape.Robin; the solver
  multiplies it by the local k (ref rama/solver.cc:155-158).

All formulas are in SI; `config.depth` is in geometry units and
`config.unit` converts to meters (the reference keeps depth in unit
coordinates too and multiplies by config.unit,
user_script_util.lua:601-604).
"""

from __future__ import annotations

import numpy as np

MU0 = 4e-7 * np.pi
EPS0 = 8.8541878128e-12
C0 = 299792458.0


def _k0_in_m(config) -> float:
    return 2 * np.pi * config.frequency / C0


def _k2_in_m(config) -> float:
    """Type-aware k^2 in 1/m^2 (util.KSquaredInM): EXY with finite depth
    subtracts (pi / (depth*unit))^2 (ref rama/solver.cc:1561-1566)."""
    k2 = _k0_in_m(config) ** 2
    if config.type == "EXY" and np.isfinite(config.depth):
        k2 -= (np.pi / (config.depth * config.unit)) ** 2
    return k2


def metal_epsilon(config, conductivity: float,
                  material_epsilon: float = 1.0) -> complex:
    """Equivalent complex epsilon modeling floor/ceiling conductor loss
    (ref util.PaintMetal, user_script_util.lua:598-620):

      Ez : eps_i = -sqrt(2 eps_m) / (d sqrt(mu0 sigma 2 pi f))
      EXY: the Ez value scaled by 2 pi^2 / (d^2 k^2_in_m)

    Paint the result over the cavity region (Shape.Paint epsilon=...).
    """
    d = config.depth * config.unit
    if not np.isfinite(d):
        raise ValueError("metal_epsilon needs a finite config.depth")
    f = config.frequency
    ei = -np.sqrt(2.0 * material_epsilon) / (
        d * np.sqrt(MU0 * conductivity * 2 * np.pi * f)
    )
    if config.type == "EZ":
        pass
    elif config.type == "EXY":
        ei = ei * 2 * np.pi**2 / (d**2 * _k2_in_m(config))
    else:
        raise ValueError("metal_epsilon only works for EZ and EXY")
    return complex(material_epsilon, ei)


def metal_wall_alpha(config, conductivity: float,
                     metal_epsilon: float = 1.0,
                     medium_epsilon: float = 1.0) -> complex:
    """Dimensionless Robin coefficient for a lossy side wall
    (ref util.PortMetal, user_script_util.lua:622-652); use with
    Shape.Robin — the solver multiplies by the local k.

      Ez : alpha = (i / eps_medium) sqrt(eps_metal
                    - i mu0 sigma 2 pi f / k^2_in_m)
      EXY: alpha = i (eff_k1^2 + pi^2/d^2)
                    / sqrt(2 mu0 sigma 2 pi f) / eff_k1,
           eff_k1 = sqrt(k0^2 eps_medium - pi^2/d^2)   [side-wall form]
    """
    f = config.frequency
    w = 2 * np.pi * f
    if config.type == "EZ":
        return complex(
            1j / medium_epsilon
            * np.sqrt(complex(metal_epsilon, -MU0 * conductivity * w
                              / _k2_in_m(config)))
        )
    elif config.type == "EXY":
        d = config.depth * config.unit
        if not np.isfinite(d):
            raise ValueError("EXY metal_wall_alpha needs a finite depth")
        k1_squared = _k0_in_m(config) ** 2 * medium_epsilon
        eff_k1 = np.sqrt(complex(k1_squared - np.pi**2 / d**2))
        alpha = 1j * (eff_k1**2 + np.pi**2 / d**2) / np.sqrt(
            2 * MU0 * conductivity * w
        )
        return complex(alpha / eff_k1)
    raise ValueError("metal_wall_alpha only works for EZ and EXY")
