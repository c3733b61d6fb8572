"""Device-mesh scaling on `torch.distributed`, counterpart of
`eggshell_tpu.parallel.mesh`: scenario batches and MPPI samples sharded
over ranks, one process a card.

- `make_mesh` builds a 1-D `DeviceMesh` named `axis` over the world:
  NCCL for "cuda", gloo for "cpu".  Under `torchrun` (RANK, WORLD_SIZE,
  LOCAL_RANK set) it joins that world; where a process group already
  exists it takes it; else it makes a world of one in this process on a
  `HashStore` (no network, no port).
- A rank holds only its own shard, where the JAX package's `Mesh` gives a
  global sharded array: `shard_batch` returns this rank's contiguous slice
  of the leading axis (rank r takes rows r B/n to (r + 1) B/n), the
  sharded entries return this rank's shard, and `gather` collects the
  shards on every rank.
- `sharded_rollout` steps a rank's shard through `parallel.rollout.
  rollout_batched` (on the card a captured `StepGraph`); the scenarios are
  independent, so it needs no collective.
- `sharded_mppi_update`: every rank draws the whole noise tensor from the
  same generator state, as the local update does, rolls out its slice
  through `mpc.sampling.rollout_controlled_batched`, and normalises the
  weights with all-reduces (MIN of the costs, SUM of the weights and of the
  weighted controls).  At world 1 it returns the local update's bits.
- `dryrun_multichip(n)`: one sharded MPPI step on living_room, then the
  check that the sharded update equals the local one.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.utils.config import SimConfig


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch",
              device: str = "cuda") -> DeviceMesh:
    """A 1-D mesh over the world, its one dimension named `axis`.
    `n_devices`, where given, must be the world's size (1 for the world of
    one this makes outside `torchrun`)."""
    backend = {"cuda": "nccl", "cpu": "gloo"}[device]
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        else:
            if n_devices not in (None, 1):
                raise ValueError(f"a mesh of {n_devices} ranks needs torchrun or a process "
                                 "group made by the caller; alone this process is a world of 1")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"mesh of {n_devices} ranks in a world of {world}")
    return init_device_mesh(device, (world,), mesh_dim_names=(axis,))


def _rows(mesh: DeviceMesh, total: int):
    """This rank's slice of `total` rows."""
    n, r = mesh.size(), mesh.get_local_rank()
    if total % n:
        raise ValueError(f"{total} rows do not split over {n} ranks")
    per = total // n
    return slice(r * per, (r + 1) * per)


def shard_batch(mesh: DeviceMesh, states: State, axis: str = "batch") -> State:
    """This rank's contiguous slice of the leading (batch) axis of every
    field, in tensors of its own."""
    rows = _rows(mesh, states.p.shape[0])
    return State(*(x[rows].clone() for x in states))


def gather(mesh: DeviceMesh, x):
    """The shards of every rank concatenated along the leading axis, on
    every rank: a tensor, or a State field by field."""
    if isinstance(x, State):
        return State(*(gather(mesh, f) for f in x))
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group())
    return torch.cat(parts)


def _all_reduce(x: torch.Tensor, op, mesh: DeviceMesh) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, op=op, group=mesh.get_group())
    return x


def sharded_rollout(spec: SceneSpec, states: State, cfg: SimConfig, num_steps: int,
                    mesh: DeviceMesh, axis: str = "batch") -> State:
    """Roll this rank's shard of scenarios (`shard_batch`) `num_steps` steps
    forward through `rollout_batched`.  Returns the shard's final states."""
    return rollout_batched(spec, states, cfg, num_steps)


def _sharded_mppi_from_controls(spec: SceneSpec, state: State, cfg: SimConfig, ctrls, cost_fn,
                                mesh: DeviceMesh, controlled_body: int, temperature: float,
                                substeps: int, graph=None):
    """The sharded MPPI update from the whole sample tensor `ctrls`
    (S, H, 6), the same on every rank: this rank rolls out its slice, and
    the weights exp(-(cost - min cost) / temperature) are normalised over
    every rank.  Returns (new_mean (H, 6), this rank's costs)."""
    from eggshell_tpu_torch.mpc.sampling import rollout_controlled_batched

    mine = ctrls[_rows(mesh, ctrls.shape[0])]
    S = mine.shape[0]
    states = State(*(x.expand((S,) + x.shape) for x in state))
    final, run = rollout_controlled_batched(spec, states, cfg, mine, controlled_body,
                                            substeps=substeps, graph=graph)
    costs = torch.func.vmap(cost_fn)(final) + run
    beta = _all_reduce(torch.min(costs), dist.ReduceOp.MIN, mesh)
    wts = torch.exp(-(costs - beta) / temperature)
    wts = wts / _all_reduce(torch.sum(wts), dist.ReduceOp.SUM, mesh)
    new_mean = _all_reduce(torch.einsum("s,shc->hc", wts, mine), dist.ReduceOp.SUM, mesh)
    return new_mean, costs


def sharded_mppi_update(spec: SceneSpec, state: State, cfg: SimConfig, mean_controls,
                        generator: torch.Generator, cost_fn, mesh: DeviceMesh,
                        controlled_body: int = 0, num_samples: int = 256,
                        noise_sigma: float = 1.0, temperature: float = 1.0,
                        noise_mode: str = "white", axis: str = "batch", substeps: int = 1,
                        graph=None):
    """`mpc.sampling.mppi_update_batched` with the sample axis sharded over
    the mesh: the same samples from the same generator state, this rank's
    slice rolled out here.  Returns (new_mean_controls, this rank's costs);
    the new mean is the same on every rank."""
    from eggshell_tpu_torch.mpc.sampling import _sample

    ctrls = _sample(mean_controls, generator, num_samples, noise_sigma, noise_mode)
    return _sharded_mppi_from_controls(spec, state, cfg, ctrls, cost_fn, mesh, controlled_body,
                                       temperature, substeps, graph)


def sharded_mean_cost(cost_per_scenario: torch.Tensor, mesh: DeviceMesh,
                      axis: str = "batch") -> torch.Tensor:
    """The mean over every rank of the ranks' per-scenario costs."""
    s = _all_reduce(torch.sum(cost_per_scenario), dist.ReduceOp.SUM, mesh)
    n = _all_reduce(torch.tensor(cost_per_scenario.shape[0], dtype=cost_per_scenario.dtype,
                                 device=cost_per_scenario.device), dist.ReduceOp.SUM, mesh)
    return s / n


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One sharded MPPI step over an n-rank mesh on the production scene:
    living_room in float32, fixed-sweep Jacobi (8 sweeps, omega 0.3,
    always-on CFM 0.01, 32 contacts), H = 3, 2 samples a rank drawn from a
    generator seeded with the rank (gathered, then each rank rolls out its
    own), body 4 controlled and costed.  Then the
    check that `sharded_mppi_update` equals the local `mppi_update_batched`
    from the same generator state within 1e-4.  Returns the best cost, the
    mean's norm and that difference (the same on every rank); rank 0
    prints them."""
    from eggshell_tpu_torch.mpc.sampling import mppi_update_batched
    from eggshell_tpu_torch.physics import scenes
    from eggshell_tpu_torch.utils.config import SolverKind

    mesh = make_mesh(n_devices, device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else "cpu"
    dtype = torch.float32
    cfg = SimConfig(solver=SolverKind.JACOBI, solver_iters=8, solver_tol=0.0, jacobi_omega=0.3,
                    conditional_cfm=False, cfm_always=0.01, contact_capacity=32)
    spec, state = scenes.living_room(device=dev, dtype=dtype)
    body, H, s_local = 4, 3, 2
    mean = torch.zeros((H, 6), dtype=dtype, device=dev)
    target = torch.tensor([0.0, 0.0, 0.5], dtype=dtype, device=dev)

    def cost_fn(final):
        return torch.sum((final.p[body] - target) ** 2)

    gen = torch.Generator(dev).manual_seed(mesh.get_local_rank())
    mine = mean[None] + torch.randn((s_local, H, 6), generator=gen, dtype=dtype, device=dev)
    new_mean, costs = _sharded_mppi_from_controls(spec, state, cfg, gather(mesh, mine), cost_fn,
                                                  mesh, body, 1.0, 1)
    best = _all_reduce(torch.min(costs), dist.ReduceOp.MIN, mesh)
    if not (torch.isfinite(new_mean).all() and torch.isfinite(best)):
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite mean or cost")

    s_total = mesh.size() * s_local
    local_mean, _ = mppi_update_batched(spec, state, cfg, mean, torch.Generator(dev).manual_seed(0),
                                        cost_fn, body, s_total)
    shard_mean, _ = sharded_mppi_update(spec, state, cfg, mean,
                                        torch.Generator(dev).manual_seed(0), cost_fn, mesh,
                                        body, s_total)
    err = float((shard_mean - local_mean).abs().max())
    if not err < 1e-4:
        raise RuntimeError(f"sharded MPPI != local MPPI (max |d| = {err})")
    out = {"best_cost": float(best), "mean_norm": float(torch.linalg.norm(new_mean)),
           "sharded_minus_local": err}
    if mesh.get_local_rank() == 0:
        print(f"dryrun_multichip({n_devices}): ok, best cost {out['best_cost']:.4f}, mean ctrl "
              f"norm {out['mean_norm']:.4f}, sharded == local MPPI within {err:.2e}")
    return out


if __name__ == "__main__":
    # torchrun --standalone --nproc-per-node N -m eggshell_tpu_torch.parallel.mesh
    import argparse

    parser = argparse.ArgumentParser(
        description="dryrun_multichip over the ranks torchrun starts, one process a card")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    dryrun_multichip(int(os.environ.get("WORLD_SIZE", "1")), device=args.device)
    dist.destroy_process_group()
