"""Swinging chain trajectory rendered as a GIF (the reference's default
HangingChain scenario, eggshell/model.cc:97-115).

Usage: python -m eggshell_tpu_torch.examples.chain_swing [out_dir]

Counterpart of `examples/chain_swing.py`: `parallel.rollout.rollout`, a
loop of the single-scene `step_ode` (PGS).  The chain has joints only
(no ground, no box pairs), so no narrowphase runs.
"""

import sys

import torch

from eggshell_tpu_torch.parallel.rollout import rollout
from eggshell_tpu_torch.physics import scenes
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind


def main(out_dir=".", steps: int = 1500, *, render: bool = True, device="cuda",
         dtype=torch.float32):
    cfg = SimConfig(solver=SolverKind.PGS, solver_iters=60)
    spec, state = scenes.chain(10, device=device, dtype=dtype)
    final, traj = rollout(spec, state, cfg, int(steps), keep_trajectory=True)
    if render:
        from eggshell_tpu_torch.viz import save_trajectory_animation

        path = save_trajectory_animation(
            spec, traj, f"{out_dir}/chain_swing.gif", stride=30, fps=15
        )
        print(f"wrote {path}")
    return final, traj


if __name__ == "__main__":
    main(*sys.argv[1:])
