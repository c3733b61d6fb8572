"""Schrodinger particle-in-a-box with a potential barrier — the rama
schrodinger_potential_barrier.lua example, Python.

Solves -grad^2 psi + V psi = E psi on a rectangle with a barrier strip
in the middle (config.type SCHRODINGER, ref rama/solver.h:42-126) and
shows level splitting: the lowest two levels form a near-degenerate
even/odd pair as the barrier grows.

Usage: python -m eggshell_tpu_torch.examples.schrodinger_barrier [out_dir]

Counterpart of `examples/schrodinger_barrier.py`; `levels` is the
computation `main` prints and plots.
"""

import sys

import numpy as np

from eggshell_tpu_torch.fem import Rectangle, mesh_shape
from eggshell_tpu_torch.fem.helmholtz import solve_modes

BARRIERS = (0.0, 50.0, 400.0)


def levels(*, device="cuda"):
    """(mesh, [(V0, the 4 lowest levels, their states)] for each barrier)."""
    box = Rectangle(0, 0, 2.0, 1.0)
    mesh = mesh_shape(box, 0.05)

    cent = mesh.points[mesh.triangles].mean(axis=1)
    out = []
    for V0 in BARRIERS:
        V = np.where(np.abs(cent[:, 0] - 1.0) < 0.1, V0, 0.0)
        vals, vecs = solve_modes(mesh, num_modes=4, potential=V, device=device)
        out.append((V0, vals, vecs))
    return mesh, out


def main(out_dir=".", *, render: bool = True, device="cuda"):
    mesh, out = levels(device=device)
    for V0, vals, vecs in out:
        gap = vals[1] - vals[0]
        print(f"V0={V0:7.1f}: E = {np.round(vals, 2)}  (E1-E0 = {gap:.3f})")
        if V0 == 400.0 and render:
            from eggshell_tpu_torch.viz import draw_field

            for i in range(2):
                draw_field(mesh, vecs[:, i],
                           f"{out_dir}/schrodinger_psi{i}.png")
    if render:
        print(f"wrote {out_dir}/schrodinger_psi*.png "
              "(splitting shrinks as the barrier grows: tunneling doublet)")


if __name__ == "__main__":
    main(*sys.argv[1:])
