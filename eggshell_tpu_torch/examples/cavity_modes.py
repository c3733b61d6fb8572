"""Cavity eigenmodes of an L-shaped domain (CSG difference) with field
plots — the rama waveguide-modes example, Python.

Usage: python -m eggshell_tpu_torch.examples.cavity_modes [out_dir]

Counterpart of `examples/cavity_modes.py`; `modes` is the computation
`main` prints and plots.
"""

import sys

import numpy as np

from eggshell_tpu_torch.fem import Rectangle, mesh_shape
from eggshell_tpu_torch.fem.helmholtz import solve_modes


def build():
    shape = Rectangle(0, 0, 2.0, 2.0) - Rectangle(1.0, 1.0, 2.0, 2.0)
    return mesh_shape(shape, 0.07)


def modes(mesh=None, *, device="cuda"):
    """(mesh, the 4 lowest Dirichlet eigenvalues, their eigenvectors)."""
    mesh = build() if mesh is None else mesh
    vals, vecs = solve_modes(mesh, num_modes=4, dirichlet=True, device=device)
    return mesh, vals, vecs


def main(out_dir=".", *, render: bool = True, device="cuda"):
    mesh = build()
    if render:
        from eggshell_tpu_torch.viz import draw_mesh

        draw_mesh(mesh, f"{out_dir}/lshape_mesh.png")
    _, vals, vecs = modes(mesh, device=device)
    print("L-shape Dirichlet eigenvalues:", np.round(vals, 3))
    print("(literature lambda_1 ~ 9.64 for the unit L-shape scaled by 1/4:"
          " here domain is 2x scaled => lambda/4)")
    if render:
        from eggshell_tpu_torch.viz import draw_field

        for i in range(3):
            draw_field(mesh, vecs[:, i], f"{out_dir}/lshape_mode{i}.png")
        print(f"wrote {out_dir}/lshape_mesh.png and mode plots")


if __name__ == "__main__":
    main(*sys.argv[1:])
