"""Horn antenna pattern — the rama horn-antenna example family
(rama/examples/*horn*.lua), Python, at reference-like resolution.

A WR-90 feed guide flares into a 2D horn radiating into an ABC-bounded
free-space region (10k+ mesh nodes -> the sparse solve path).  Computes
S11 at the feed, the far-field pattern via Kirchhoff aperture
integration over the ABC boundary, directivity, and the phase center
(ref rama/solver.h:208-224).

Usage: python -m eggshell_tpu_torch.examples.horn_antenna [out_dir]

Counterpart of `examples/horn_antenna.py`; `solve` and `pattern` are the
computation `main` prints and plots.
"""

import sys

import numpy as np

from eggshell_tpu_torch.fem import Polygon, Rectangle, mesh_shape
from eggshell_tpu_torch.fem.antenna import antenna_pattern, directivity, phase_center
from eggshell_tpu_torch.fem.helmholtz import FemConfig, solve_driven


def build(feed_len=30.0, a=22.86, flare_len=30.0, mouth=70.0,
          space=(55.0, 60.0)):
    """Feed guide + linear flare + ABC-bounded free space (mm)."""
    feed = Rectangle(-feed_len, -a / 2, 0.0, a / 2)
    horn = Polygon([
        (0.0, -a / 2), (flare_len, -mouth / 2),
        (flare_len, mouth / 2), (0.0, a / 2),
    ])
    sx, sy = space
    free = Rectangle(flare_len, -sy, flare_len + sx, sy)
    cd = feed + horn + free
    cd.Port((-feed_len, -a / 2), (-feed_len, a / 2), 1)
    cd.ABC((flare_len, -sy), (flare_len + sx, -sy))
    cd.ABC((flare_len + sx, -sy), (flare_len + sx, sy))
    cd.ABC((flare_len, sy), (flare_len + sx, sy))
    return cd


def solve(h: float = 0.95, *, device="cuda"):
    """(mesh, config, solution) of the horn driven at 10 GHz."""
    mesh = mesh_shape(build(), h)
    cfg = FemConfig(type="EZ", frequency=10e9, unit=1e-3, excited_port=1)
    return mesh, cfg, solve_driven(mesh, cfg, device=device)


def pattern(mesh, cfg, sol):
    """(angles, far-field pattern, peak angle (deg), directivity, 3 dB
    beamwidth (deg), phase center (mm)) of a solution."""
    field = sol.field.cpu().numpy()
    k0 = cfg.k0
    angles = np.radians(np.linspace(-80, 80, 161))
    pat = antenna_pattern(mesh, field, k0, angles)
    p2 = np.abs(pat) ** 2
    peak = np.degrees(angles[int(np.argmax(p2))])
    d = directivity(pat)
    # 3 dB beamwidth
    half = p2 >= p2.max() / 2
    bw = np.degrees(angles[half][-1] - angles[half][0])
    pc = phase_center(mesh, field, k0,
                      np.radians(np.linspace(-25, 25, 31)),
                      search_radius=30.0, grid=31)
    return angles, pat, peak, d, bw, pc


def main(out_dir=".", *, render: bool = True, device="cuda"):
    mesh, cfg, sol = solve(device=device)
    print(f"mesh: {mesh.num_points} nodes, {mesh.num_triangles} triangles "
          f"({'sparse' if mesh.num_points > 1200 else 'dense'} solve path)")
    print(f"feed match: |S11| = {abs(sol.s_params[1]):.3f}")
    _, _, peak, d, bw, pc = pattern(mesh, cfg, sol)
    print(f"pattern: peak at {peak:+.1f} deg, directivity {d:.1f} "
          f"({10 * np.log10(d):.1f} dB over the sampled arc), "
          f"3 dB beamwidth {bw:.1f} deg")
    print(f"phase center: ({pc[0]:.1f}, {pc[1]:.1f}) mm "
          f"(horn throat at x = 0)")
    if not render:
        return
    try:
        from eggshell_tpu_torch.viz import draw_field

        draw_field(mesh, sol.field.abs(), f"{out_dir}/horn_field.png")
        print(f"wrote {out_dir}/horn_field.png")
    except Exception as e:      # headless plotting is best-effort
        print(f"(field plot skipped: {e})")


if __name__ == "__main__":
    main(*sys.argv[1:])
