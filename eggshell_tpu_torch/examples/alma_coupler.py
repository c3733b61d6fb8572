"""WR-10 3 dB branch-line coupler — the reference's
rama/tests/test_ALMA_coupler.lua model ("Designs of Wideband 3dB
Branch-line Couplers for ALMA Bands 3 to 10", Andoh et al., ALMA memo
468) rebuilt on the Python shape API.

Two parallel WR-10 guides joined by five coupling posts; excited at
port 1 it splits roughly equally between the two far ports (3, 4) with
the near ports (1, 2) isolated.  Exercises: multi-port S-matrices,
Select-addressed ports, unioned CSG geometry, finite-depth Exy.

Usage: python -m eggshell_tpu_torch.examples.alma_coupler

Counterpart of `examples/alma_coupler.py`.
"""

import sys

import numpy as np

from eggshell_tpu_torch.fem import Rectangle, mesh_shape
from eggshell_tpu_torch.fem.helmholtz import FemConfig, solve_driven

# ref test_ALMA_coupler.lua default_parameters
POSTS_GAPS = [0.332, 0.542, 0.544, 0.424, 0.598]   # Post1 Gap1 Post2 Gap2 Post3
B = 1.27        # WR-10 B dimension (mm)
S = 0.605       # guide spacing
L = 2.0         # feed length


def build():
    q = list(POSTS_GAPS)
    q += q[-2::-1]          # symmetric post/gap array (ref lua:41-43)
    q.append(L)
    x = L
    cd = None
    for i in range(0, len(q), 2):
        bar = Rectangle(x, 0.1, x + q[i], 2 * B + S - 0.1)
        cd = bar if cd is None else cd + bar
        x = x + q[i] + q[i + 1]
    total = x
    cd = cd + Rectangle(0, 0, total, B) + Rectangle(0, B + S, total, 2 * B + S)
    cd.Port(cd.Select(0, B / 2), 1)
    cd.Port(cd.Select(0, S + B * 1.5), 2)
    cd.Port(cd.Select(total, B / 2), 3)
    cd.Port(cd.Select(total, S + B * 1.5), 4)
    return cd, total


def solve(h=0.1, frequency=93e9, *, device="cuda"):
    cd, total = build()
    mesh = mesh_shape(cd, h)
    cfg = FemConfig(type="EXY", frequency=frequency, unit=1e-3,
                    excited_port=1, depth=2.54)
    sol = solve_driven(mesh, cfg, device=device)
    return mesh, sol


def main(*, device="cuda"):
    mesh, sol = solve(device=device)
    print(f"mesh: {mesh.num_points} nodes")
    total_power = 0.0
    for p in (1, 2, 3, 4):
        db = 10 * np.log10(max(abs(sol.s_params[p]) ** 2, 1e-30))
        total_power += abs(sol.s_params[p]) ** 2
        print(f"port {p}: {db:+7.2f} dB")
    print(f"power sum: {total_power:.4f} (lossless -> 1)")


if __name__ == "__main__":
    sys.exit(main())
