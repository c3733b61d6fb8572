"""The benchmark of eggshell_tpu_torch: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  Set-up
(imports, the kernel library, the cell's inputs made on the card from the
seed, graph capture, warm-up) is timed from the process's start to the
window's; then the cell's traffic runs for --seconds; then the peak memory
is read, the program's graphs are freed, and a sample of the window's
answers drawn from the seed is recomputed by the plain reference.  The
last line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with --trace 1 `breakdown`, and `checks`,
each compared number beside its limit); the comparison also ends standard
error.  With --trace 0 the metrics are the cell's end-to-end ones, with
--trace 1 its per-layer ones, read from a profiler trace of the window's
first calls.  A cell on several cards runs one process a card, started
here after the kernel library is built; rank 0's line is printed.

Exits non-zero, printing no result, without enough CUDA cards, or when
jax, jaxlib, flax or eggshell_tpu (whole top-level names) is loaded once
the window has closed.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# A rank waits this long for its peers' rendezvous and collectives; the
# whole run must end within 360 s.
RANK_TIMEOUT_S = 330


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the parent process for each rank of a cell on several cards
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def run_cell(ctx, t0: float) -> dict:
    """Set up, measure, check: the result object of this rank (rank 0's is
    the run's; the other ranks' only take part)."""
    import torch

    from portbench import harness, layers

    drv = harness.runner(ctx)
    drv.prepare(ctx.seed)
    drv.warm()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    # Everything set-up made is kept out of the collector's full passes, which
    # otherwise stall the window some 0.1 s each time over torch's objects.
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - t0
    harness.log(f"[setup] {setup_s:.6f} s")
    win = drv.window(ctx.seconds, ctx.trace)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    if ctx.world > 1:
        fullest = torch.tensor([peak], dtype=torch.int64, device=ctx.device)
        torch.distributed.all_reduce(fullest, op=torch.distributed.ReduceOp.MAX)
        peak = int(fullest.item())
    foreign = harness.foreign_modules()
    drv.release()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    worst, failed, per_call = drv.readings()
    harness.log(f"[check] reference {time.monotonic() - t_check:.3f} s")
    harness.log(f"[work] {drv.flops_per_scenario_step!r} flops a scenario-step, counted from "
                "the reference's contacts")
    if ctx.rank != 0:
        return {}
    for i, g in per_call:
        harness.log(f"[check] answer {i}: " + ", ".join(f"{k} {v:.6e}" for k, v in g.items()))
    correct, checks = harness.judge(worst, ctx.limits)
    result = {"correct": correct, "attempted": win["attempted"], "failed": failed}
    if ctx.device.type != "cuda":
        return {**result, "checks": checks, "readings": worst, "foreign_modules": foreign}
    if ctx.trace:
        view = layers.View(win["trace"], drv.steps_per_call, drv.batch, ctx.config,
                           drv.flops_per_scenario_step)
        result["metrics"] = harness.layer_readings(ctx, view)
    else:
        values = {**win["e2e"], "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in harness.metrics_of(ctx.bench, ctx.cell["name"], False)}
    result["device"] = harness.device_info(ctx.device, ctx.world, peak)
    if ctx.trace:
        from portbench import trace as tr

        result["device"].update(busy_s=tr.busy_s(win["trace"]), window_s=tr.window_s(win["trace"]))
        result["breakdown"] = tr.breakdown(win["trace"])
    result["checks"] = checks
    result["foreign_modules"] = foreign
    return result


def finish(result: dict) -> int:
    """Print the result line (or refuse to) and return the exit code."""
    from portbench import harness

    foreign = sorted(set(result.pop("foreign_modules")) | set(harness.foreign_modules()))
    if foreign:
        harness.log(f"[refused] modules of the JAX package or of JAX are loaded: {foreign}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"[compare] {name} {c['value']!r} limit {c['limit']!r}")
    harness.log(f"[correct] {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(module: str, argv: list, chips: int) -> list:
    """Build the kernel library once, then start `python -m module argv`
    once a card with --rank and a rendezvous --port; rank 0's standard
    output is piped, the others' goes to standard error."""
    from eggshell_tpu_torch import kernels

    kernels.build()
    port = free_port()
    return [subprocess.Popen([sys.executable, "-m", module, *argv, "--rank", str(r), "--port",
                              str(port), "--t0", repr(T0)],
                             stdout=subprocess.PIPE if r == 0 else sys.stderr)
            for r in range(chips)]


def init_rank(rank: int, chips: int, port: int):
    """This process's card, and its place in the world of `chips` ranks."""
    import datetime

    import torch
    import torch.distributed as dist

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    if chips > 1:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=chips,
                                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    return device


def launch_ranks(args, chips: int) -> int:
    """One process a card; rank 0's result passed on."""
    from portbench import harness

    procs = spawn_ranks("portbench.run", ["--workload", args.workload, "--seed", str(args.seed),
                                          "--seconds", str(args.seconds), "--trace",
                                          str(args.trace)], chips)
    try:
        out, _ = procs[0].communicate(timeout=RANK_TIMEOUT_S)
        codes = [procs[0].returncode] + [p.wait(timeout=30) for p in procs[1:]]
    except subprocess.TimeoutExpired:
        harness.log("[ranks] a rank did not finish in time")
        codes = [1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = out.decode().splitlines() if codes[0] == 0 else []
    if any(codes) or not lines:
        harness.log(f"[ranks] exit codes {codes}")
        return 1
    for line in lines[:-1]:
        print(line)
    return finish(json.loads(lines[-1]))


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness

    chips = next((w["chips"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")
                  ["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        harness.log(f"unknown workload {args.workload!r}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA card(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    if chips > 1 and args.rank is None:
        return launch_ranks(args, chips)
    rank = args.rank or 0
    device = init_rank(rank, chips, args.port)
    ctx = harness.context(args.workload, args.seed, args.seconds, bool(args.trace), device,
                          rank, chips)
    result = run_cell(ctx, T0 if args.t0 is None else args.t0)
    if chips > 1:
        torch.distributed.destroy_process_group()
    if rank != 0:
        return 0
    if chips > 1:
        print(json.dumps(result), flush=True)
        return 0
    return finish(result)


def rehearse(workload: str, seed: int, seconds: float = 0.0, trace: bool = False,
             rank: int = 0, world: int = 1) -> dict:
    """A run of `workload` at its traffic's rehearsal sizes on the CPU,
    without the look for cards (the tests' runs): its result object,
    `metrics` and `device` left out (no number of a CPU run is a device
    metric)."""
    import torch

    from portbench import harness

    ctx = harness.context(workload, seed, seconds, trace, torch.device("cpu"), rank, world,
                          rehearsal=True)
    return run_cell(ctx, time.monotonic())


if __name__ == "__main__":
    sys.exit(main())
