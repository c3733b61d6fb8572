"""Waveguide cross-section modes: TE and TM cutoff frequencies of
rectangular, circular, and coaxial guides (the rama waveguide_modes
example + the TE/TM ScriptConfig types, rama/examples/waveguide_modes.lua,
rama/solver.h:49-50).

TM modes solve the Dirichlet Laplacian eigenproblem on the cross
section (Ez vanishes on PEC walls); TE modes solve the Neumann problem
(Hz, natural walls), discarding the constant zero mode.  Cutoff
frequency f_c = c * sqrt(lambda) / (2 pi) for eigenvalue lambda = kc^2.

Analytic gates:
  rectangle a x b:  TE10 kc = pi/a;  TM11 kc = pi sqrt(1/a^2 + 1/b^2)
  circle radius a:  TE11 kc = 1.8412/a;  TM01 kc = 2.4048/a

Usage: python -m eggshell_tpu_torch.examples.waveguide_modes [out_dir]

Counterpart of `examples/waveguide_modes.py` (the port's `solve_modes`:
element matrices on the device, ARPACK on the host).
"""

import sys

import numpy as np

from eggshell_tpu_torch.fem import Circle, Rectangle, mesh_shape
from eggshell_tpu_torch.fem.helmholtz import solve_modes

C0 = 299792458.0
MIL = 2.54e-5


def cutoffs(shape, h, num_modes=6, te=True, *, device="cuda"):
    """First `num_modes` nonzero cutoff wavenumbers kc (geometry units)
    of the TE (Neumann) or TM (Dirichlet) problem on the cross section."""
    mesh = mesh_shape(shape, h)
    vals, vecs = solve_modes(mesh, num_modes=num_modes + 2,
                             dirichlet=not te, device=device)
    vals = np.asarray(vals, float)
    keep = vals > 1e-8 * max(vals.max(), 1.0)   # drop the TE zero mode
    kc = np.sqrt(vals[keep])
    return mesh, kc[:num_modes]


def rectangular(a=122.0, aspect=0.5, h=4.0, num_modes=6, *, device="cuda"):
    """Rectangular guide a x (aspect*a), e.g. WR-style 122 x 61 mil."""
    b = a * aspect
    shape = Rectangle(-a / 2, -b / 2, a / 2, b / 2)
    return cutoffs(shape, h, num_modes, te=True, device=device), \
        cutoffs(shape, h, num_modes, te=False, device=device)


def circular(a=61.0, aspect=1.0, h=3.0, num_modes=6, *, device="cuda"):
    """Circular (aspect=1) or elliptic guide of x-radius a."""
    shape = Circle(0, 0, a)
    if aspect != 1.0:
        shape = shape.Scale(1.0, aspect)
    return cutoffs(shape, h, num_modes, te=True, device=device), \
        cutoffs(shape, h, num_modes, te=False, device=device)


def coaxial(a=61.0, ratio=0.35, h=3.0, num_modes=4, *, device="cuda"):
    """Coax: outer radius a, inner radius ratio*a."""
    shape = Circle(0, 0, a) - Circle(0, 0, ratio * a)
    return cutoffs(shape, h, num_modes, te=True, device=device), \
        cutoffs(shape, h, num_modes, te=False, device=device)


def main(out_dir=".", *, render: bool = True, device="cuda"):
    a, K = 122.0, 0.5
    (mesh, kc_te), (_, kc_tm) = rectangular(a, K, device=device)
    te10 = np.pi / a
    tm11 = np.pi * np.hypot(1 / a, 1 / (K * a))
    print("rectangular 122 x 61 mil:")
    print(f"  TE10 kc: fem={kc_te[0]:.6f}  analytic={te10:.6f}")
    print(f"  TM11 kc: fem={kc_tm[0]:.6f}  analytic={tm11:.6f}")
    fc = C0 * kc_te[0] / (2 * np.pi * MIL) / 1e9
    print(f"  TE10 cutoff: {fc:.2f} GHz")

    (cmesh, ckc_te), (_, ckc_tm) = circular(61.0, device=device)
    print("circular radius 61 mil:")
    print(f"  TE11 kc: fem={ckc_te[0]:.6f}  analytic={1.84118/61.0:.6f}")
    print(f"  TM01 kc: fem={ckc_tm[0]:.6f}  analytic={2.40483/61.0:.6f}")

    (xmesh, xkc_te), _ = coaxial(61.0, 0.35, device=device)
    approx = 2.0 / (61.0 * (1 + 0.35))
    print("coax 61/21.4 mil:")
    print(f"  TE11 kc: fem={xkc_te[0]:.6f}  thin-annulus approx={approx:.6f}")
    if not render:
        return
    from eggshell_tpu_torch.viz import draw_field

    # draw the dominant TM mode of the rectangle
    vals, vecs = solve_modes(mesh, num_modes=3, dirichlet=True, device=device)
    draw_field(mesh, vecs[:, 0], f"{out_dir}/waveguide_modes_tm11.png")
    print(f"wrote {out_dir}/waveguide_modes_tm11.png")


if __name__ == "__main__":
    main(*sys.argv[1:])
