"""Drop a box on the ground and render the result (BASELINE config #1).

Usage: python -m eggshell_tpu_torch.examples.box_drop [out_dir]

Counterpart of `examples/box_drop.py`: `parallel.rollout.rollout` of the
single-scene `step_ode` (PGS).  `simulate` is the rollout `main` renders.
"""

import sys

import torch

from eggshell_tpu_torch.parallel.rollout import rollout
from eggshell_tpu_torch.physics import scenes
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind


def simulate(steps: int = 1200, *, device="cuda"):
    """(spec, cfg, final, trajectory) of the box dropped from 0.5 m."""
    cfg = SimConfig(solver=SolverKind.PGS, solver_iters=60,
                    conditional_cfm=False, cfm_always=0.01,
                    contact_capacity=16)
    spec, state = scenes.box_drop(height=0.5, device=device, dtype=torch.float32)
    final, traj = rollout(spec, state, cfg, int(steps), keep_trajectory=True)
    return spec, cfg, final, traj


def main(out_dir=".", *, steps: int = 1200, render: bool = True, device="cuda"):
    spec, cfg, final, traj = simulate(steps, device=device)
    z = traj.p[:, 0, 2].cpu().numpy()
    print(f"rest height: {float(final.p[0, 2]):.4f} (half extent 0.15)")
    if render:
        import numpy as np

        from eggshell_tpu_torch.viz import Figure, draw_scene

        Figure().plot(np.arange(len(z)) * cfg.dt, z).xlabel("t [s]").ylabel(
            "z [m]"
        ).title("box drop").grid().save(f"{out_dir}/box_drop_z.png")
        draw_scene(spec, final, f"{out_dir}/box_drop_final.png", title="at rest")
        print(f"wrote {out_dir}/box_drop_z.png, {out_dir}/box_drop_final.png")


if __name__ == "__main__":
    main(*sys.argv[1:])
