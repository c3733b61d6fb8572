"""Sampling MPC: push a resting box to a target with MPPI
(the north-star control loop on one scene).

Usage: python -m eggshell_tpu_torch.examples.push_mpc [out_dir]

Counterpart of `examples/push_mpc.py`: `mpc.SamplingMPC` with PGS.  The
noise comes from one `torch.Generator` seeded 0, drawn at every control
step, where the script folds the control step into a JAX key.  `main`
runs the MPPI controller that `controller` builds.
"""

import sys

import torch

from eggshell_tpu_torch.mpc import SamplingMPC
from eggshell_tpu_torch.physics import scenes
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind


def controller(num_samples: int = 128, horizon: int = 40, *, device="cuda"):
    """(mpc, state): the MPPI controller pushing the box toward x = 0.25, and
    the box at rest, float32."""
    cfg = SimConfig(solver=SolverKind.PGS, solver_iters=40,
                    conditional_cfm=False, cfm_always=0.01,
                    contact_capacity=16)
    spec, state = scenes.box_drop(height=0.15, device=device, dtype=torch.float32)
    target = torch.tensor([0.25, 0.0, 0.15], dtype=torch.float32, device=device)

    def cost(s):
        return torch.sum((s.p[0] - target) ** 2)

    mpc = SamplingMPC(
        spec=spec, cfg=cfg, cost_fn=cost, horizon=int(horizon),
        num_samples=int(num_samples),
        noise_sigma=15.0, temperature=3e-4, iterations=2,
        substeps=10,    # 10 ms control period
    )
    return mpc, state


def main(out_dir=".", control_steps: int = 60, num_samples: int = 128,
         horizon: int = 40, *, render: bool = True, device="cuda"):
    control_steps = int(control_steps)
    mpc, state = controller(num_samples, horizon, device=device)
    mean = torch.zeros((mpc.horizon, 6), dtype=torch.float32, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    xs = []
    st = state
    for _ in range(control_steps):
        st, mean, best = mpc.control_step(st, mean, generator)
        xs.append(float(st.p[0, 0]))
    print(f"final x = {xs[-1]:.3f} (target 0.25)")
    if render:
        from eggshell_tpu_torch.viz import Figure

        Figure().plot(xs).xlabel("control step").ylabel(
            "box x [m]"
        ).title("MPPI push-to-target").grid().save(f"{out_dir}/push_mpc.png")
        print(f"wrote {out_dir}/push_mpc.png")
    return xs


if __name__ == "__main__":
    main(*sys.argv[1:])
