"""Ez waveguide width transition: tapering from width W1 to W2 (the rama
waveguide_transition_Ez example, rama/examples/waveguide_transition_Ez.lua).

If either width is below the TE10 cutoff width c/2f, waves cannot
propagate through that section and the transition reflects (almost) all
power.  If both propagate, a long taper matches well and an abrupt step
reflects.

Usage: python -m eggshell_tpu_torch.examples.waveguide_transition [out_dir]

Counterpart of `examples/waveguide_transition.py`.
"""

import sys

import numpy as np

from eggshell_tpu_torch.fem import Polygon, mesh_shape
from eggshell_tpu_torch.fem.helmholtz import FemConfig, solve_driven

C0 = 299792458.0
MIL = 2.54e-5
L = 500.0                # total length (mil)
FREQ = 70e9


def cutoff_width_mil(freq=FREQ):
    return C0 / (2 * freq) / MIL


def build(w1: float, w2: float, taper: float, h: float = 5.0):
    """Symmetric taper of length `taper` between half-guides of widths
    w1 (left, port 1) and w2 (right, port 2)."""
    t = max(taper, 1e-6)
    cd = Polygon([
        (-L / 2, w1 / 2), (-L / 2, -w1 / 2), (-t / 2, -w1 / 2),
        (t / 2, -w2 / 2), (L / 2, -w2 / 2), (L / 2, w2 / 2),
        (t / 2, w2 / 2), (-t / 2, w1 / 2),
    ])
    cd.Port((-L / 2, -w1 / 2), (-L / 2, w1 / 2), 1)
    cd.Port((L / 2, -w2 / 2), (L / 2, w2 / 2), 2)
    return mesh_shape(cd, h)


def solve(w1: float, w2: float, taper: float, h: float = 5.0, *, device="cuda"):
    """Returns the POWER-WAVE S11/S21 (unitary for lossless, even though
    the two ports have different widths — sol.s_power normalizes by the
    mode power flux; the raw sol.s_params are field amplitudes)."""
    mesh = build(w1, w2, taper, h)
    sol = solve_driven(
        mesh, FemConfig(type="EZ", frequency=FREQ, unit=MIL, excited_port=1), device=device
    )
    i1 = sol.port_numbers.index(1)
    i2 = sol.port_numbers.index(2)
    return mesh, (complex(sol.s_power[i1, 0]), complex(sol.s_power[i2, 0]))


def main(out_dir=".", *, render: bool = True, device="cuda"):
    wc = cutoff_width_mil()
    print(f"TE10 cutoff width at {FREQ/1e9:.0f} GHz: {wc:.1f} mil")
    cases = [
        ("straight  122->122", 122.0, 122.0, 50.0),
        ("taper     122->200", 122.0, 200.0, 300.0),
        ("abrupt    122->200", 122.0, 200.0, 5.0),
        ("cutoff    122->70 ", 122.0, 70.0, 50.0),
    ]
    for name, w1, w2, t in cases:
        _, (r, tr) = solve(w1, w2, t, device=device)
        print(f"{name}: |S11|={abs(r):.4f}  |S21|={abs(tr):.4f}  "
              f"power={abs(r)**2 + abs(tr)**2:.4f}")
    if not render:
        return
    from eggshell_tpu_torch.viz import Figure, draw_field

    # |S11| vs taper length for the 122 -> 200 transition
    tapers = [5.0, 50.0, 150.0, 300.0]
    s11 = [abs(solve(122.0, 200.0, t, device=device)[1][0]) for t in tapers]
    f = Figure()
    f.plot(tapers, s11, "o-")
    f.xlabel("taper length (mil)").ylabel("|S11|")
    f.title("122 -> 200 mil Ez transition at 70 GHz")
    f.grid().save(f"{out_dir}/waveguide_transition.png")

    mesh, _ = solve(122.0, 70.0, 50.0, device=device)
    sol = solve_driven(
        mesh, FemConfig(type="EZ", frequency=FREQ, unit=MIL, excited_port=1), device=device
    )
    draw_field(mesh, sol.field.abs(), f"{out_dir}/waveguide_transition_cutoff.png")
    print(f"wrote {out_dir}/waveguide_transition.png, "
          f"{out_dir}/waveguide_transition_cutoff.png")


if __name__ == "__main__":
    main(*sys.argv[1:])
