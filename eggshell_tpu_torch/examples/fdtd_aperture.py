"""FDTD: a pulse diffracting through an aperture in a PEC wall.

Usage: python -m eggshell_tpu_torch.examples.fdtd_aperture [out_dir]

Counterpart of `examples/fdtd_aperture.py`; each step runs the 2D FDTD
kernel (`fem.fdtd.simulate_2d`) on the card.
"""

import sys

import torch

from eggshell_tpu_torch.fem import fdtd


def main(out_dir=".", n: int = 160, *, render: bool = True, device="cuda"):
    n = int(n)
    dx = 1.0 / (n - 1)
    dt = float(fdtd.courant_dt(dx, 2, 0.7))
    pec = torch.zeros((n, n), dtype=torch.bool, device=device)
    pec[:, n // 2] = True
    pec[n // 2 - 8 : n // 2 + 8, n // 2] = False
    f = fdtd.init_2d(n, n, torch.float32, device=device)

    t0, sig = 40 * dt, 12 * dt

    def src(t):
        return torch.exp(-((t - t0) ** 2) / (2 * sig**2))

    steps = int(n * 260 / 160)
    fin, _ = fdtd.simulate_2d(
        f, steps, dt, dx, pec=pec,
        source_ij=(n // 2, n // 5), source_fn=src,
    )
    ez = fin.ez.cpu().numpy()
    print(f"field max {abs(ez).max():.3e}; "
          f"leaked beyond wall: {abs(ez[:, n//2+4:]).max():.3e}")
    leak = float(abs(ez[:, n//2+4:]).max()) / float(abs(ez).max())
    if render:
        from eggshell_tpu_torch.viz import Figure

        Figure(figsize=(6, 6)).imshow(ez.T, cmap="RdBu").title(
            "Ez after aperture diffraction"
        ).save(f"{out_dir}/fdtd_aperture.png")
        print(f"wrote {out_dir}/fdtd_aperture.png")
    return leak, ez


if __name__ == "__main__":
    main(*sys.argv[1:])
