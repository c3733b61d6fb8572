"""Frequency sweep of a dielectric-slab-loaded waveguide: |S11| vs the
transmission-line analytic model (the rama test_s11 example, Python).

Usage: python -m eggshell_tpu_torch.examples.waveguide_s11 [out_dir]

Counterpart of `examples/waveguide_s11.py`; `sweep` is the computation
`main` prints and plots.
"""

import sys

import numpy as np

from eggshell_tpu_torch.fem import Rectangle, mesh_shape
from eggshell_tpu_torch.fem.helmholtz import FemConfig, port_beta, solve_driven

C0 = 299792458.0
EPS2, D = 4.0, 0.35


def sweep(*, device="cuda"):
    """(mesh, ks, FEM |S11|, analytic |S11|, the last k's solution) over
    k0 in [3.6, 5.6]."""
    wg = Rectangle(0, 0, 2.0, 1.0)
    wg.Port((0, 0), (0, 1), 1).Port((2.0, 0), (2.0, 1), 2)
    wg.Paint(Rectangle(0.9, 0, 0.9 + D, 1.0), epsilon=EPS2)
    mesh = mesh_shape(wg, 0.035)

    ks = np.linspace(3.6, 5.6, 11)
    fem, ana = [], []
    for k0 in ks:
        sol = solve_driven(
            mesh, FemConfig(type="EZ", frequency=k0 * C0 / (2 * np.pi)), device=device
        )
        fem.append(abs(sol.s_params[1]))
        b1 = complex(port_beta(k0**2, 1.0, device="cpu"))
        b2 = complex(port_beta(EPS2 * k0**2, 1.0, device="cpu"))
        r12 = (b1 - b2) / (b1 + b2)
        ph = np.exp(-2j * b2 * D)
        ana.append(abs(r12 * (1 - ph) / (1 - r12**2 * ph)))
    return mesh, ks, fem, ana, sol


def main(out_dir=".", *, render: bool = True, device="cuda"):
    mesh, ks, fem, ana, sol = sweep(device=device)
    err = np.abs(np.asarray(fem) - np.asarray(ana)).max()
    print(f"max |S11| error vs analytic over sweep: {err:.4f}")
    if render:
        from eggshell_tpu_torch.viz import Figure, draw_field

        f = Figure()
        f.plot(ks, fem, "o-", label="FEM")
        f.plot(ks, ana, "--", label="transmission line")
        f.xlabel("k0").ylabel("|S11|").title("slab-loaded waveguide").legend()
        f.grid().save(f"{out_dir}/waveguide_s11.png")
        draw_field(mesh, sol.field.real, f"{out_dir}/waveguide_field.png")
        print(f"wrote {out_dir}/waveguide_s11.png, {out_dir}/waveguide_field.png")


if __name__ == "__main__":
    main(*sys.argv[1:])
