"""Sampling MPC on the living-room manipulation task, sharded over the
device mesh — BASELINE config #5 end to end.

The living-room clutter scene (mujoco_scratchpad/living_room.xml,
box-ified) with MPPI pushing the table lamp (a free box on the dining
table) toward a target: the sample axis is sharded over the ranks of
`parallel.mesh` (`sharded_mppi_update`, all-reduces), which equals the
single-device update for the same generator state.  Alone it is a world
of one; the mesh is made first, so under `torchrun` each rank's "cuda" is
its own card.

Usage: python -m eggshell_tpu_torch.examples.living_room_mpc [num_samples] [steps]

Counterpart of `examples/living_room_mpc.py`: JACOBI, the unfused branch;
on the card B2 takes the box pairs of every float32 step.  The noise comes
from one `torch.Generator` seeded 0, drawn at every control step, where
the script folds the control step into a JAX key.  `main` is `settle`
then `control`.
"""

import sys

import torch

from eggshell_tpu_torch.parallel import mesh as pmesh
from eggshell_tpu_torch.physics import scenes
from eggshell_tpu_torch.physics.stepper import step_ode
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind

LAMP = 6            # the free "table_lamp" box (scenes.living_room)
SETTLE_STEPS = 500


def settle(device="cuda"):
    """(spec, cfg, state): the room, float32, after SETTLE_STEPS passive
    steps (the free boxes are DROPPED into the room: they spawn above
    their rest heights)."""
    # max_correcting_vel: the MJCF spawns the table lamp interpenetrating
    # the dining table (living_room.xml:63 relies on MuJoCo's soft
    # constraints); cap the ERP ejection at 2 m/s so settling is gentle.
    cfg = SimConfig(
        solver=SolverKind.JACOBI, solver_iters=30, jacobi_omega=0.3,
        jacobi_beta=0.45, conditional_cfm=False, cfm_always=0.01,
        contact_capacity=24, max_correcting_vel=2.0,
    )
    spec, state = scenes.living_room(device=device, dtype=torch.float32)
    for _ in range(SETTLE_STEPS):
        state, _ = step_ode(spec, state, cfg)
    print(f"settled: lamp at ({float(state.p[LAMP, 0]):+.2f}, "
          f"{float(state.p[LAMP, 1]):+.2f}, {float(state.p[LAMP, 2]):+.2f})")
    return spec, cfg, state


def control(spec, cfg, state, mesh, num_samples: int, steps: int):
    """(c0, c1): the task cost before and after `steps` MPPI control
    steps from the settled `state`, the samples sharded over `mesh`."""
    dtype, device = state.p.dtype, state.p.device
    # slide the lamp across whatever it rests on: plan in x-y only
    target_xy = state.p[LAMP, :2] + torch.tensor([0.8, 0.6], dtype=dtype, device=device)

    def cost(s):
        return torch.sum((s.p[LAMP, :2] - target_xy) ** 2)

    n_dev = mesh.size()
    samples = max(num_samples, n_dev) // n_dev * n_dev
    print(f"mesh: {n_dev} device(s); {samples} samples/iteration")

    H = 25
    SUB = 10        # control period = 10 ms (each wrench held 10 sim steps)
    mean = torch.zeros((H, 6), dtype=dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    c0 = float(cost(state))
    for i in range(steps):
        mean, costs = pmesh.sharded_mppi_update(
            spec, state, cfg, mean, generator, cost,
            mesh, controlled_body=LAMP, num_samples=samples,
            noise_sigma=15.0, temperature=3e-4, noise_mode="constant",
            substeps=SUB,
        )
        ext = torch.zeros((spec.num_bodies, 6), dtype=dtype, device=device)
        ext[LAMP] = mean[0]
        for _ in range(SUB):
            state, _ = step_ode(spec, state, cfg, ext_force=ext)
        mean = torch.cat([mean[1:], torch.zeros_like(mean[:1])])
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: lamp at "
                  f"({float(state.p[LAMP, 0]):+.2f}, "
                  f"{float(state.p[LAMP, 1]):+.2f}), "
                  f"cost {float(cost(state)):.3f}")
    c1 = float(cost(state))
    print(f"cost {c0:.3f} -> {c1:.3f} "
          f"({'improved' if c1 < c0 else 'NO IMPROVEMENT'})")
    return c0, c1


def main(num_samples: int = 256, steps: int = 30, *, device="cuda"):
    mesh = pmesh.make_mesh(device=torch.device(device).type)
    spec, cfg, state = settle(device)
    return control(spec, cfg, state, mesh, int(num_samples), int(steps))


if __name__ == "__main__":
    main(*sys.argv[1:])
