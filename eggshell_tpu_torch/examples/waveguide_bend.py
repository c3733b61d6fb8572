"""Waveguide bend study: how sharp can an Ez-guide bend be before it
reflects?  (The rama waveguide_bend example, Python —
rama/examples/waveguide_bend.lua: a centerline polyline stroked to the
guide width, ports on the two straight ends.)

The guide is WR-style, width W = 122 mil, driven at 70 GHz (TE10
propagating: cutoff width c/2f = 84.3 mil < W).  A 90-degree bend of
center radius R is meshed and solved for each R; reflection |S11| drops
as the bend gets gentler while |S11|^2 + |S21|^2 stays 1 (lossless).

Usage: python -m eggshell_tpu_torch.examples.waveguide_bend [out_dir]

Counterpart of `examples/waveguide_bend.py`.
"""

import sys

import numpy as np

from eggshell_tpu_torch.fem import Polyline, Rectangle, mesh_shape
from eggshell_tpu_torch.fem.helmholtz import FemConfig, solve_driven

C0 = 299792458.0
MIL = 2.54e-5            # geometry unit in meters

W = 122.0                # guide width (mil)
L = 100.0                # straight feed length before/after the bend
FREQ = 70e9


def build(radius: float, h: float = 8.0):
    """Mesh a 90-degree bend of center radius `radius` (mil).  The
    centerline runs +x from (-L, -R), turns through the quarter arc,
    and exits +y to (R, L); the capsule stroke's round end caps are
    trimmed flat by intersecting with the port planes."""
    R = float(radius)
    n = max(int(np.ceil((np.pi / 2) * R / 10.0)) + 2, 8)
    ang = -np.pi / 2 + (np.pi / 2) * np.linspace(0.0, 1.0, n)
    center = (
        [(-L - W, -R)]
        + [(R * np.cos(a), R * np.sin(a)) for a in ang]
        + [(R, L + W)]
    )
    guide = Polyline(center, W)
    # flat port planes at x = -L and y = L (trim the round caps)
    guide = guide & Rectangle(-L, -R - W, R + W, L)
    guide.Port((-L, -R - W / 2), (-L, -R + W / 2), 1)
    guide.Port((R - W / 2, L), (R + W / 2, L), 2)
    return mesh_shape(guide, h)


def solve(radius: float, h: float = 8.0, *, device="cuda"):
    mesh = build(radius, h)
    sol = solve_driven(
        mesh, FemConfig(type="EZ", frequency=FREQ, unit=MIL, excited_port=1), device=device
    )
    return mesh, (complex(sol.s_params[1]), complex(sol.s_params[2]))


def main(out_dir=".", *, render: bool = True, device="cuda"):
    radii = [70.0, 100.0, 150.0, 220.0]
    s11, s21 = [], []
    for R in radii:
        _, (r, t) = solve(R, device=device)
        s11.append(abs(r))
        s21.append(abs(t))
        power = abs(r) ** 2 + abs(t) ** 2
        print(f"R={R:6.1f} mil  |S11|={abs(r):.4f}  |S21|={abs(t):.4f}"
              f"  power={power:.4f}")
    if not render:
        return
    from eggshell_tpu_torch.viz import Figure, draw_field

    f = Figure()
    f.plot(radii, s11, "o-", label="|S11|")
    f.plot(radii, s21, "s-", label="|S21|")
    f.xlabel("bend center radius (mil)").ylabel("|S|")
    f.title("90-degree Ez bend at 70 GHz").legend()
    f.grid().save(f"{out_dir}/waveguide_bend.png")

    mesh = build(radii[0])
    sol = solve_driven(
        mesh, FemConfig(type="EZ", frequency=FREQ, unit=MIL, excited_port=1), device=device
    )
    draw_field(mesh, sol.field.real, f"{out_dir}/waveguide_bend_field.png")
    print(f"wrote {out_dir}/waveguide_bend.png, "
          f"{out_dir}/waveguide_bend_field.png")


if __name__ == "__main__":
    main(*sys.argv[1:])
