"""The readings a cell's limits are set from, in one process a card:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2

For each of --seeds, the cell's traffic from that seed runs for --seconds
through the program, and the compared numbers of the answers drawn from
the seed are printed (the lower readings: sound runs of the program).  For
each of --control-seeds the same, with the plain reference computed in
bfloat16 put in the program's place (the control: the configurations
state float32 and the program's float32 is on the CUDA cores, so the
nearest precision below is bfloat16).  One JSON line a seed on standard
output; the limits are then set between the two by hand (PERF.md).
With --rehearse, the traffic's rehearsal sizes on the CPU.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def readings(ctx, seeds, controls, seconds: float):
    """(kind, seed, worst readings, per-answer readings) of every seed."""
    import torch

    from portbench import harness

    drv = harness.runner(ctx)
    out = []
    for n, (kind, seed) in enumerate([("program", s) for s in seeds]
                                     + [("control", s) for s in controls]):
        drv.prepare(seed)
        if n == 0:
            drv.warm()
            drv.prepare(seed)
        drv.window(seconds, False)
        worst, _, per = drv.readings(torch.bfloat16 if kind == "control" else None)
        if ctx.rank == 0:
            out.append({"kind": kind, "seed": seed, "worst": worst,
                        "per_answer": {str(i): g for i, g in per}})
            print(json.dumps(out[-1]), flush=True)
    drv.release()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import torch

    from portbench import harness, run

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    if args.rehearse:
        ctx = harness.context(args.workload, 0, args.seconds, False, torch.device("cpu"),
                              rehearsal=True)
        readings(ctx, seeds, controls, args.seconds)
        return 0
    chips = next(w["chips"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")
                 ["workloads"] if w["name"] == args.workload)
    if chips > 1 and args.rank is None:
        procs = run.spawn_ranks("portbench.calibrate", list(argv or sys.argv[1:]), chips)
        for line in procs[0].stdout:
            print(line.decode(), end="", flush=True)
        return max(pr.wait() for pr in procs)
    rank = args.rank or 0
    device = run.init_rank(rank, chips, args.port)
    ctx = harness.context(args.workload, 0, args.seconds, False, device, rank, chips)
    readings(ctx, seeds, controls, args.seconds)
    if chips > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
