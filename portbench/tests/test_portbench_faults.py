"""`correct` comes out false when the timed path is broken underneath a
run (the rest of the run as on the card, at the rehearsal sizes on the
CPU), once for each fault a cell can have, and when the control (the
plain reference in bfloat16) stands in for the program."""

import multiprocessing
import socket

import pytest
import torch

from eggshell_tpu_torch.mpc import sampling
from eggshell_tpu_torch.parallel import mesh
from eggshell_tpu_torch.parallel import rollout as port_rollout
from eggshell_tpu_torch.physics.scene import State
from portbench import calibrate, harness, run

SEED = 2**32 + 17
real_rollout = port_rollout.rollout_batched
real_from_controls = sampling._mppi_from_controls


def unchanged(spec, states, cfg, num_steps, graph=None):
    return State(*(x.clone() for x in states))


def half_left_out(spec, states, cfg, num_steps, graph=None):
    B = states.p.shape[0]
    done = real_rollout(spec, State(*(x[: B // 2] for x in states)), cfg, num_steps, graph)
    return State(*(torch.cat([a, b[B // 2:]]) for a, b in zip(done, states)))


def altered(spec, states, cfg, num_steps, graph=None):
    out = real_rollout(spec, states, cfg, num_steps, graph)
    out.p[-1, 0, 2] += 0.01
    return out


@pytest.mark.parametrize("cell", ["stack4_rollouts", "living_room_rollouts"])
@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_rollout_fault_is_caught(cell, fault, monkeypatch):
    monkeypatch.setattr(port_rollout, "rollout_batched", fault)
    r = run.rehearse(cell, SEED)
    assert not r["correct"], r
    assert r["failed"] >= 1


def controlled_unchanged(spec, states, cfg, controls, controlled_body, running_cost=None,
                         substeps=1, graph=None):
    return State(*(x.clone() for x in states)), torch.zeros(states.p.shape[0],
                                                            dtype=states.p.dtype)


def mean_over_half(spec, state, cfg, ctrls, *args):
    S = ctrls.shape[0]
    mean, costs = real_from_controls(spec, state, cfg, ctrls[: S // 2], *args)
    return mean, torch.cat([costs, costs])


def mean_altered(*args):
    mean, costs = real_from_controls(*args)
    return mean + 0.01, costs


@pytest.mark.parametrize("name,target,fault", [
    ("unchanged", "rollout_controlled_batched", controlled_unchanged),
    ("half_left_out", "_mppi_from_controls", mean_over_half),
    ("altered", "_mppi_from_controls", mean_altered)])
def test_mpc_fault_is_caught(name, target, fault, monkeypatch):
    monkeypatch.setattr(sampling, target, fault)
    r = run.rehearse("living_room_mpc", SEED)
    assert not r["correct"], r


# The sharded MPC cell, kept ready for BENCHMARK.json (its files are under
# portbench/; PERF.md says why it is not a cell yet).
X4_CELL = {"name": "living_room_mpc_x4", "config": "living_room",
           "traffic": "mppi_s16384_h20_x4", "chips": 4}


def _rank(rank, world, port, fault, out):
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    if fault:
        mesh._all_reduce = lambda x, op, m: x.clone()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    ctx = harness.cell_context(bench, X4_CELL, SEED, 0.0, False, torch.device("cpu"), rank, world,
                               rehearsal=True)
    r = run.run_cell(ctx, 0.0)
    dist.destroy_process_group()
    if rank == 0:
        out.put(r)


def _sharded(fault: bool) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, fault, out)) for r in range(2)]
    for p in procs:
        p.start()
    r = out.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    return r


def test_sharded_update_sound_and_exchange_left_out_caught():
    assert _sharded(False)["correct"]
    assert not _sharded(True)["correct"]


@pytest.mark.parametrize("cell", ["stack4_rollouts", "living_room_mpc"])
def test_control_is_not_correct(cell):
    ctx = harness.context(cell, 0, 0.0, False, torch.device("cpu"), rehearsal=True)
    out = calibrate.readings(ctx, [], [SEED], 0.0)
    ok, _ = harness.judge(out[0]["worst"], ctx.limits)
    assert not ok, out
