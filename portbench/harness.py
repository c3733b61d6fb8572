"""What every cell's run shares: the cell's files found by name, the
program's scene and configuration built from a configuration file, the
sample of answers kept for the check, the comparison with the limits, the
device's description and the result line.

A cell is an entry of `BENCHMARK.json`'s `workloads`; it names a
configuration (`configs/<name>.json`, which names its plain reference
`references/<name>.py`) and a traffic mix (`traffic/<name>.json`, which
names the runner `runners/<name>.py` that runs it).  Each per-layer metric
is read by `layer_metrics/<name>.py`, and each cell's limits are in
`limits/<cell>.json`.  A later cell, configuration, mix or metric is a new
file and a new entry; no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names the run may not load: the JAX package and JAX.
FOREIGN = ("jax", "jaxlib", "flax", "eggshell_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Ctx(NamedTuple):
    """One run of one cell: its entries and files, the run's arguments, and
    where it runs (device, this process's rank, the world's size)."""

    bench: dict
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object           # torch.device
    rank: int
    world: int

    def reference(self):
        return load_module(HERE / "references" / f"{self.config['reference']}.py",
                           f"portbench_reference_{self.config['reference']}")


def context(workload: str, seed: int, seconds: float, trace: bool, device, rank: int = 0,
            world: int = 1, rehearsal: bool = False) -> Ctx:
    """The context of `workload`; `rehearsal` takes the traffic file's tiny
    `rehearsal` sizes (the CPU tests' runs)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of {sorted(cells)}")
    return cell_context(bench, cells[workload], seed, seconds, trace, device, rank, world,
                        rehearsal)


def cell_context(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
                 rank: int = 0, world: int = 1, rehearsal: bool = False) -> Ctx:
    """The context of a cell given as its `workloads` entry."""
    workload = cell["name"]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    if rehearsal:
        traffic = {**traffic, **traffic["rehearsal"]}
    limits = {k: v["limit"] for k, v in load_json(HERE / "limits" / f"{workload}.json")
              ["limits"].items()}
    return Ctx(bench, cell, config, traffic, limits, seed, seconds, trace, device, rank, world)


def runner(ctx: Ctx):
    return load_module(HERE / "runners" / f"{ctx.traffic['runner']}.py",
                       f"portbench_runner_{ctx.traffic['runner']}").Runner(ctx)


def foreign_modules() -> list:
    """The loaded modules whose whole top-level name is in FOREIGN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


# --- the program's scene and configuration, from a configuration file --------


def candidate_pairs(config: dict) -> list:
    static = config["scene"]["static"]
    n = len(static)
    return [(i, j) for i in range(n) for j in range(i + 1, n) if not (static[i] and static[j])]


def port_scene(config: dict, device, dtype=None):
    """The program's (SceneSpec, State) of the configuration, through its
    public `physics.scene.make_scene`, in the stated dtype (or `dtype`);
    static bodies get no ground contacts."""
    import torch

    from eggshell_tpu_torch.physics.scene import make_scene

    sc = config["scene"]
    dtype = getattr(torch, config["solver"]["dtype"]) if dtype is None else dtype
    spec, state = make_scene(sc["positions"], quats=sc["quats"], half_extents=sc["half_extents"],
                             masses=sc["masses"], static=sc["static"], ground=sc["ground"],
                             pairs=candidate_pairs(config), device=device, dtype=dtype)
    ground = torch.tensor([sc["ground"] and not s for s in sc["static"]], device=device)
    return spec._replace(ground_enabled=ground), state


def port_config(config: dict):
    """The program's SimConfig of the configuration's solver settings."""
    from eggshell_tpu_torch.utils.config import FrictionModel, SimConfig, SolverKind

    s = config["solver"]
    return SimConfig(solver=SolverKind[s["solver"].upper()], solver_iters=s["sweeps"],
                     solver_tol=0.0, jacobi_omega=s["omega"], jacobi_beta=s["beta"],
                     conditional_cfm=s["conditional_cfm"], cfm_always=s["cfm_always"],
                     friction_model=FrictionModel[s["friction_model"].upper()],
                     friction_bound=s["friction_bound"], contact_capacity=s["contact_capacity"],
                     dt=s["dt"], gravity=tuple(s["gravity"]), erp=s["erp"],
                     min_constraint_distance=s["min_constraint_distance"],
                     max_correcting_vel=float(s["max_correcting_vel"]))


def derived_seed(seed: int, salt: int) -> int:
    """A generator seed of its own for each use of the run's seed."""
    return (seed * 6364136223846793005 + salt * 1442695040888963407) % (1 << 63)


class Reservoir:
    """A uniform sample of k of the answers produced so far, drawn from the
    seed (reservoir sampling): `offer(i, make)` keeps make() for answer i
    where the draw takes it."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept = k, random.Random(derived_seed(seed, 7)), {}

    def offer(self, i: int, make) -> None:
        if len(self.kept) < self.k:
            self.kept[i] = make()
            return
        r = self.rng.randrange(i + 1)
        if r < self.k:
            del self.kept[sorted(self.kept)[r]]
            self.kept[i] = make()


# --- comparison and result ----------------------------------------------------


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct where every number
    is finite and at most its limit."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def device_info(device, count: int, memory_peak_bytes: int) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
           "memory_peak_bytes": int(memory_peak_bytes)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=20)
        limit, sm, sm_max = (x.strip() for x in smi.stdout.strip().split(","))
        out.update(power_limit_w=float(limit), clock_sm_mhz=float(sm),
                   clock_sm_max_mhz=float(sm_max))
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return out


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metrics (entries of BENCHMARK.json) this cell reports: the
    end-to-end ones without --trace, the per-layer ones with it."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def layer_readings(ctx: Ctx, view) -> dict:
    out = {}
    for m in metrics_of(ctx.bench, ctx.cell["name"], True):
        value = load_module(HERE / "layer_metrics" / f"{m['name']}.py",
                            "portbench_metric_" + m["name"].replace(".", "_")).read(view)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
