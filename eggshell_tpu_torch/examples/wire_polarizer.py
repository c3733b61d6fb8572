"""Wire-grid polarizer: a column of closely spaced thin PEC wires across
a guide passes the polarization perpendicular to the wires and reflects
the parallel one (the rama wire_polarizer example,
rama/examples/wire_polarizer.lua).

The wires extrude out of plane (along z).  Driving the same geometry as
an Ez problem (E parallel to the wires) the grid acts as a mirror;
as an Exy problem (E in-plane, perpendicular to the wires) the wave
passes nearly untouched.

Usage: python -m eggshell_tpu_torch.examples.wire_polarizer [out_dir]

Counterpart of `examples/wire_polarizer.py`.
"""

import sys

import numpy as np

from eggshell_tpu_torch.fem import Circle, Rectangle, mesh_shape
from eggshell_tpu_torch.fem.helmholtz import FemConfig, solve_driven

MM = 1e-3
W, H = 10.0, 5.0          # guide region (mm)
SPACING = 0.86            # wire spacing (mm)
RADIUS = 0.1              # wire radius (mm)
FREQ = 70e9


def build(h: float = 0.12):
    cd = Rectangle(0, 0, W, H)
    for i in range(1, int(np.ceil(H / SPACING)) + 1):
        cd = cd - Circle(W / 2, i * SPACING, RADIUS)
    cd.Port((0, 0), (0, H), 1)
    cd.Port((W, 0), (W, H), 2)
    return mesh_shape(cd, h)


def solve(polarization: str, h: float = 0.12, mesh=None, *, device="cuda"):
    """polarization: 'EZ' (parallel to the wires -> mirror) or 'EXY'
    (perpendicular -> transparent)."""
    if mesh is None:
        mesh = build(h)
    sol = solve_driven(
        mesh,
        FemConfig(type=polarization, frequency=FREQ, unit=MM,
                  excited_port=1, depth=np.inf),
        device=device,
    )
    return mesh, (complex(sol.s_params[1]), complex(sol.s_params[2]))


def main(out_dir=".", *, render: bool = True, device="cuda"):
    mesh = build()
    print(f"mesh: {mesh.num_points} nodes, {mesh.num_triangles} triangles")
    for pol in ("EZ", "EXY"):
        _, (r, t) = solve(pol, mesh=mesh, device=device)
        print(f"{pol:4s}  |S11|={abs(r):.4f}  |S21|={abs(t):.4f}  "
              f"power={abs(r)**2 + abs(t)**2:.4f}")
        if render:
            from eggshell_tpu_torch.viz import draw_field

            sol = solve_driven(mesh, FemConfig(type=pol, frequency=FREQ, unit=MM,
                                               excited_port=1), device=device)
            draw_field(mesh, sol.field.real, f"{out_dir}/wire_polarizer_{pol.lower()}.png")
    if render:
        print(f"wrote {out_dir}/wire_polarizer_ez.png, "
              f"{out_dir}/wire_polarizer_exy.png")


if __name__ == "__main__":
    main(*sys.argv[1:])
