"""Parallel-plate capacitor electrostatics — the rama
capacitor_electrostatics.lua example, Python.

Two conductor segments held at +/-0.5 V inside a grounded box; solves
the Laplace problem (config.type ES, ref rama/solver.h ELECTROSTATICS)
and checks the mid-gap field against the ideal-capacitor value E = V/d.

Usage: python -m eggshell_tpu_torch.examples.capacitor_es [out_dir]

Counterpart of `examples/capacitor_es.py`; `solve` is the computation
`main` prints and plots.
"""

import sys

from eggshell_tpu_torch.fem import Rectangle, mesh_shape
from eggshell_tpu_torch.fem.fields import get_field_gradient
from eggshell_tpu_torch.fem.helmholtz import FemConfig, solve_driven

IDEAL_EY = 1.0 / 0.39     # V / d, d = 0.39 between the plates' inner faces


def solve(*, device="cuda"):
    """(mesh, the nodal potential (numpy), the mid-gap field E (2,))."""
    # grounded 2x2 box; plates at y = 0.8 and y = 1.2 spanning x in [0.5, 1.5]
    box = Rectangle(0, 0, 2, 2)
    box.Potential((0.5, 0.8), (1.5, 0.8), -0.5)
    box.Potential((0.5, 1.2), (1.5, 1.2), +0.5)
    # slit the domain so the plates are actual boundaries
    box = box - Rectangle(0.5, 0.795, 1.5, 0.805)
    box = box - Rectangle(0.5, 1.195, 1.5, 1.205)
    mesh = mesh_shape(box, 0.06)

    sol = solve_driven(mesh, FemConfig(type="ES"), device=device)
    phi = sol.field.real.cpu().numpy()

    # mid-gap field: plates d = 0.39 apart (inner faces), V = 1
    E = -get_field_gradient(mesh, phi, [[1.0, 1.0]])[0]
    return mesh, phi, E


def main(out_dir=".", *, render: bool = True, device="cuda"):
    mesh, phi, E = solve(device=device)
    print(f"mid-gap E = {E}, ideal |Ey| = {IDEAL_EY:.3f}")
    if render:
        from eggshell_tpu_torch.viz import draw_field

        draw_field(mesh, phi, f"{out_dir}/capacitor_potential.png")
        print(f"wrote {out_dir}/capacitor_potential.png")


if __name__ == "__main__":
    main(*sys.argv[1:])
