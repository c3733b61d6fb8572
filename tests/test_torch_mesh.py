"""Port parity: `eggshell_tpu_torch.parallel.mesh` on `torch.distributed`
against the JAX package's `eggshell_tpu.parallel.mesh`, float64 on the CPU.

- At a world of one rank in this process (gloo on a `HashStore`, made once
  for the module and destroyed after it), against the JAX package's mesh
  over the 8 virtual CPU devices of tests/conftest.py:
  `sharded_rollout` on tests/test_mpc_parallel.py:98-122's case
  (box_stack(2), B = 16, 20 steps) under the JACOBI configuration of
  :158-161, `sharded_mppi_update` on :139-181's case (box_stack(2),
  JACOBI, H = 5, S = 16) fed the controls the JAX package draws, and
  `sharded_mean_cost`; each within 1e-12.  At world 1 the sharded update
  is the local `mppi_update_batched`, bit for bit.
- :98-122's case under its own PGS configuration: the gathered sharded
  rollout is the port's local `rollout_batched`, bit for bit.  It is not
  held to the JAX package's: on the exactly stacked boxes the box-box clip
  emits the JAX package's contact points in another lane order at some
  steps (step 15 here), and Gauss-Seidel's result depends on the row
  order, so the runs part there (ROADMAP C); Jacobi's does not.
- `eggshell_tpu_torch.parallel` exports `rollout_batched` and
  `batch_states`, as the JAX package's does, and not `rollout`.
- Two gloo ranks, each its own process on a `FileStore`: the gathered
  sharded rollout and the sharded MPPI update equal the local ones within
  1e-12, and `dryrun_multichip(2)` passes.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from eggshell_tpu.parallel import mesh as jmesh
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.mpc import sampling as tmpc
from eggshell_tpu_torch.parallel import mesh as tmesh
from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

TOL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_mpc_parallel.py:14-17 and :158-161
PGS_CFG = SimConfig(solver=SolverKind.PGS, solver_iters=40, conditional_cfm=False,
                    cfm_always=0.01, contact_capacity=16)
JACOBI_CFG = SimConfig(solver=SolverKind.JACOBI, solver_iters=20, jacobi_omega=0.3,
                       conditional_cfm=False, cfm_always=0.01, contact_capacity=16)
TARGET = (0.4, 0.0, 0.15)


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.make_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _port(spec, st):
    return (convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64),
            convert.state_from_numpy(_np(st), device="cpu", dtype=torch.float64))


def _jax_cfg(cfg):
    return JaxSimConfig.from_json(cfg.to_json())


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL, err_msg=what)


def test_parallel_exports():
    import eggshell_tpu.parallel as jpar
    import eggshell_tpu_torch.parallel as tpar
    from eggshell_tpu_torch.parallel import batch_states, rollout_batched  # noqa: F401

    for name in ("rollout_batched", "batch_states"):
        assert hasattr(jpar, name) and getattr(tpar, name).__module__ == \
            "eggshell_tpu_torch.parallel.rollout"
    # the `rollout` attribute stays the module, as in the JAX package
    assert type(tpar.rollout).__name__ == type(jpar.rollout).__name__ == "module"


def test_make_mesh_world_of_one(mesh):
    assert mesh.size() == 1 and mesh.get_local_rank() == 0
    assert mesh.mesh_dim_names == ("batch",) and mesh.device_type == "cpu"
    assert tmesh.make_mesh(1, device="cpu").size() == 1
    with pytest.raises(ValueError):
        tmesh.make_mesh(8, device="cpu")


def _stack_batch(B=16):
    """tests/test_mpc_parallel.py:102-108's batch: box_stack(2), p jittered."""
    spec, state = js.box_stack(2)
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(), state)
    return spec, states._replace(p=states.p + jnp.linspace(0, 1e-3, B)[:, None, None])


def test_sharded_rollout_matches_jax(mesh):
    spec, states = _stack_batch()
    want = jmesh.sharded_rollout(spec, states, _jax_cfg(JACOBI_CFG), 20, jmesh.make_mesh(8))

    tspec, tstates = _port(spec, states)
    shard = tmesh.shard_batch(mesh, tstates)
    got = tmesh.gather(mesh, tmesh.sharded_rollout(tspec, shard, JACOBI_CFG, 20, mesh))
    for k in "pvqw":
        _close(getattr(got, k).numpy(), getattr(want, k), k)


def test_sharded_rollout_pgs_is_local(mesh):
    tspec, tstates = _port(*_stack_batch())
    got = tmesh.gather(mesh, tmesh.sharded_rollout(tspec, tmesh.shard_batch(mesh, tstates),
                                                   PGS_CFG, 20, mesh))
    want = rollout_batched(tspec, tstates, PGS_CFG, 20)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sharded_mppi_update_matches_jax(mesh):
    spec, state = js.box_stack(2, dtype=jnp.float64)
    H, S = 5, 16
    mc = jnp.zeros((H, 6))
    key = jax.random.PRNGKey(7)
    t = jnp.asarray(TARGET)

    def jcost(final):
        return jnp.sum((final.p[0] - t) ** 2)

    want_mean, want_costs = jmesh.sharded_mppi_update(
        spec, state, _jax_cfg(JACOBI_CFG), mc, key, jcost, jmesh.make_mesh(8), num_samples=S,
        noise_sigma=0.5, temperature=0.7)
    # the samples exactly as the JAX package draws them (mesh.py:198-210)
    ctrls = mc[None] + jax.random.normal(key, (S, H, 6), mc.dtype) * 0.5

    tspec, tstate = _port(spec, state)
    tt = torch.tensor(TARGET, dtype=torch.float64)

    def cost(final):
        return torch.sum((final.p[0] - tt) ** 2)

    mean, costs = tmesh._sharded_mppi_from_controls(
        tspec, tstate, JACOBI_CFG, torch.tensor(np.asarray(ctrls)), cost, mesh, 0, 0.7, 1)
    _close(mean.numpy(), want_mean, "mean")
    _close(costs.numpy(), want_costs, "costs")

    # at world 1 the sharded update is the local one, bit for bit
    def update(fn, *extra):
        gen = torch.Generator("cpu").manual_seed(3)
        return fn(tspec, tstate, JACOBI_CFG, torch.zeros((H, 6), dtype=torch.float64), gen, cost,
                  *extra, num_samples=S, noise_sigma=0.5, temperature=0.7)

    local = update(tmpc.mppi_update_batched)
    sharded = update(tmesh.sharded_mppi_update, mesh)
    for g, w in zip(sharded, local):
        assert torch.equal(g, w)


def test_sharded_mean_cost(mesh):
    c = np.arange(64, dtype=np.float64)
    want = float(jmesh.sharded_mean_cost(jnp.asarray(c), jmesh.make_mesh(8)))
    got = tmesh.sharded_mean_cost(torch.tensor(c), mesh)
    assert got.dtype == torch.float64 and got.shape == ()
    _close(float(got), want)
    _close(want, c.mean())


RANK_MAIN = r"""
import json, os, sys
import torch
import torch.distributed as dist
from eggshell_tpu_torch.mpc import sampling
from eggshell_tpu_torch.parallel import mesh as pmesh
from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics import scenes
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind

rank, store_path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank, world_size=2)
mesh = pmesh.make_mesh(2, device="cpu")
cfg = SimConfig(solver=SolverKind.JACOBI, solver_iters=20, jacobi_omega=0.3,
                conditional_cfm=False, cfm_always=0.01, contact_capacity=16)
spec, state = scenes.box_stack(2, device="cpu", dtype=torch.float64)
B = 8
states = State(*(x.expand((B,) + x.shape).clone() for x in state))
states = states._replace(p=states.p + torch.linspace(0, 1e-3, B, dtype=torch.float64)[:, None, None])
got = pmesh.gather(mesh, pmesh.sharded_rollout(spec, pmesh.shard_batch(mesh, states), cfg, 10, mesh))
want = rollout_batched(spec, states, cfg, 10)
roll = max(float((g - w).abs().max()) for g, w in zip(got, want))
target = torch.tensor([0.4, 0.0, 0.15], dtype=torch.float64)
cost = lambda final: torch.sum((final.p[0] - target) ** 2)
def update(fn, *extra):
    gen = torch.Generator("cpu").manual_seed(7)
    return fn(spec, state, cfg, torch.zeros((4, 6), dtype=torch.float64), gen, cost, *extra,
              num_samples=8, noise_sigma=0.5, temperature=0.7)
mean, costs = update(pmesh.sharded_mppi_update, mesh)
lmean, lcosts = update(sampling.mppi_update_batched)
mppi = float((mean - lmean).abs().max())
shard = float((costs - lcosts[rank * 4:(rank + 1) * 4]).abs().max())
mc = float(pmesh.sharded_mean_cost(costs, mesh) - lcosts.mean())
dry = pmesh.dryrun_multichip(2, device="cpu")
print(json.dumps({"rank": rank, "rollout": roll, "mppi": mppi, "costs": shard, "mean_cost": mc,
                  "dry": dry}), flush=True)
dist.barrier()
dist.destroy_process_group()
# A process that ran gloo collectives can abort in its static destructors
# at exit ("terminate called without an active exception", about one exit
# in ten under load); the result is out, so leave without them.
os._exit(0)
"""


def test_two_ranks_file_store(tmp_path):
    store = str(tmp_path / "store")
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_MAIN, str(r), store], cwd=str(tmp_path),
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    results = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert sorted(r["rank"] for r in results) == [0, 1]
    for r in results:
        for k in ("rollout", "mppi", "costs", "mean_cost"):
            assert abs(r[k]) <= TOL, (k, r)
        assert r["dry"]["sharded_minus_local"] < 1e-4
        assert np.isfinite(r["dry"]["best_cost"])
    assert results[0]["dry"] == results[1]["dry"]
