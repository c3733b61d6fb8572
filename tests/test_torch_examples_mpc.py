"""The two MPC example scripts of `eggshell_tpu_torch.examples` on the CPU.

- living_room_mpc: the script's `control` for 1 control step at 64
  samples from its settled room (`main` is `settle` then `control`; the
  room is settled once for the module), where the task cost must fall;
  and one MPPI update of the script's own problem (its
  settled room from `living_room_mpc.settle`, its configuration, cost,
  controlled lamp, "constant" noise of sigma 15, temperature 3e-4,
  H = 25, 10 substeps), at S = 8 in float64, fed the samples the JAX
  package's `parallel.mesh.sharded_mppi_update` draws (mesh.py:201-210)
  and held to that update (over the 8 virtual CPU devices of
  tests/conftest.py): the new mean and every sample's cost within
  LIVING_ROOM_TOL.  tests/test_examples_physics.py:25-34 runs the script
  at 64 samples over 12 control steps and asks for the cost below 0.7
  of its start; that depth takes about 110 s here (the settle and
  3,000 batched steps), past a file's budget, so it is checked on the
  card (`chip_smoke.py` `[examples_physics]`, 256 samples, 12 control
  steps), not here.
- push_mpc, held to its outcome (its noise comes from a
  `torch.Generator`, not JAX's keys), float32 as on the card.
  tests/test_examples_physics.py:37-44 runs it at 64 samples, 30 control
  steps, horizon 25, and asks for the box past x = 0.15.  A control step
  is 2 MPPI updates of horizon x 10 batched steps, and the port's PGS row
  loop takes about 0.2 s a batched step on this CPU, so that depth takes
  hours here; it runs 2 control steps at horizon 2, where the box must
  move toward its target, and the JAX test's bound is not checked.  The
  MPPI update of push_mpc's configuration (box_drop, PGS 40 sweeps, cfm
  0.01, K = 16) is held to the JAX package's on shared noise in
  tests/test_torch_mpc.py (`test_single_scene_mppi_matches_jax`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from eggshell_tpu.parallel import mesh as jmesh
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics.scene import State as JaxState
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.examples import living_room_mpc, push_mpc
from eggshell_tpu_torch.parallel import mesh as tmesh
from eggshell_tpu_torch.physics.scene import State
from torch_limits import time_limit  # noqa: F401

CPU = "cpu"
# The update's mean and costs, float64 on both sides from one state: 250
# steps of contact dynamics a sample, then weights exp(-cost / 3e-4)
# (observed: costs within 1.2e-16, the mean equal).
LIVING_ROOM_TOL = 1e-12


@pytest.fixture(scope="module")
def room():
    """(spec, cfg, state) of `living_room_mpc.settle`, float32."""
    return living_room_mpc.settle(CPU)


@pytest.fixture
def world_of_one():
    """living_room_mpc's update runs on a gloo world of one
    (`parallel.mesh`); leave no process group behind."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_living_room_mpc_cost_improves(room, world_of_one):
    c0, c1 = living_room_mpc.control(*room, tmesh.make_mesh(device=CPU), 64, 1)
    assert np.isfinite(c0) and np.isfinite(c1)
    assert c1 < c0, f"living-room MPPI failed to improve cost: {c0:.4f} -> {c1:.4f}"


def test_living_room_mppi_update_matches_jax(room, world_of_one):
    S, H, SUB, SIGMA, TEMP, LAMP = 8, 25, 10, 15.0, 3e-4, living_room_mpc.LAMP
    _, cfg, settled = room
    jspec, _ = js.living_room(dtype=jnp.float64)
    tspec = convert.spec_from_numpy({k: np.asarray(v) for k, v in jspec._asdict().items()},
                                    device=CPU, dtype=torch.float64)
    tstate = State(*(x.double() for x in settled))
    jstate = JaxState(*(jnp.asarray(x.numpy()) for x in tstate))
    target = tstate.p[LAMP, :2] + torch.tensor([0.8, 0.6], dtype=torch.float64)
    jtarget = jnp.asarray(target.numpy())

    def jcost(final):
        return jnp.sum((final.p[LAMP, :2] - jtarget) ** 2)

    def cost(final):
        return torch.sum((final.p[LAMP, :2] - target) ** 2)

    mc = jnp.zeros((H, 6))
    key = jax.random.PRNGKey(0)
    want_mean, want_costs = jmesh.sharded_mppi_update(
        jspec, jstate, JaxSimConfig.from_json(cfg.to_json()), mc, key, jcost, jmesh.make_mesh(8),
        controlled_body=LAMP, num_samples=S, noise_sigma=SIGMA, temperature=TEMP,
        noise_mode="constant", substeps=SUB)
    # the samples exactly as the JAX package draws them in "constant" mode
    ctrls = mc[None] + jnp.broadcast_to(jax.random.normal(key, (S, 1, 6), mc.dtype) * SIGMA,
                                        (S, H, 6))
    mean, costs = tmesh._sharded_mppi_from_controls(
        tspec, tstate, cfg, torch.tensor(np.asarray(ctrls)), cost,
        tmesh.make_mesh(device=CPU), LAMP, TEMP, SUB)
    np.testing.assert_allclose(costs.numpy(), np.asarray(want_costs), rtol=0,
                               atol=LIVING_ROOM_TOL, err_msg="costs")
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=0,
                               atol=LIVING_ROOM_TOL * SIGMA, err_msg="mean")
    assert float(costs.min()) < float(cost(tstate)), "no sample moves the lamp toward the target"


def test_push_mpc_moves_toward_target(tmp_path):
    xs = push_mpc.main(str(tmp_path), control_steps=2, num_samples=64, horizon=2, device=CPU)
    assert (tmp_path / "push_mpc.png").exists()
    assert len(xs) == 2 and np.isfinite(xs).all()
    assert 0.0 < xs[0] < xs[1] < 0.25, f"box at x={xs} (target 0.25)"
