"""The benchmark's own parts on the CPU at the traffic files' rehearsal
sizes: every cell's generator and check, the files found by name, the
frozen work arithmetic, the trace reader and the per-layer arithmetic on a
made-up trace, and a run that loads nothing of JAX or the JAX package."""

import json
import subprocess
import sys

import pytest

from portbench import harness, layers, run, work
from portbench import trace as tr

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
         if w["chips"] == 1]


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(cell):
    r = run.rehearse(cell, 2**31 + 12345)
    assert r["correct"], r
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == set(harness.context(cell, 0, 0, False, "cpu").limits)


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    import torch

    ctx = harness.context(cell, 5, 0, False, torch.device("cpu"), rehearsal=True)
    a, b = harness.runner(ctx), harness.runner(ctx)
    a.prepare(77)
    b.prepare(77)
    xs = a.starts if hasattr(a, "starts") else a.rooms
    ys = b.starts if hasattr(b, "starts") else b.rooms
    assert all(torch.equal(x, y) for s, t in zip(xs, ys) for x, y in zip(s, t))
    b.prepare(78)
    ys = b.starts if hasattr(b, "starts") else b.rooms
    assert not all(torch.equal(x, y) for s, t in zip(xs, ys) for x, y in zip(s, t))


def test_benchmark_files_found_by_name():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        ctx = harness.context(w["name"], 0, 0, False, "cpu")
        assert (harness.HERE / "runners" / f"{ctx.traffic['runner']}.py").exists()
        assert (harness.HERE / "references" / f"{ctx.config['reference']}.py").exists()
        assert harness.metrics_of(bench, w["name"], True)
        names = {m["name"] for m in harness.metrics_of(bench, w["name"], False)}
        assert "setup_s" in names and len(names) >= 2
    for m in bench["per_layer"]:
        assert (harness.HERE / "layer_metrics" / f"{m['name']}.py").exists()


def _brute_force_flops(free, b0, b1, active, sweeps):
    """contact_flops row by row: the free bodies each row acts on."""
    flops = 0
    for s in range(b0.shape[0]):
        rows = [{int(b) for b in (b0[s, k], b1[s, k]) if b >= 0 and free[b]}
                for k in range(b0.shape[1]) if active[s, k] for _ in range(3)]
        flops += sum(21 * len(r) for r in rows)
        for i, ri in enumerate(rows):
            for j, rj in enumerate(rows):
                flops += 12 * len(ri & rj) * (j >= i) + 2 * sweeps * bool(ri & rj)
    return flops


def test_work_counts_from_shapes():
    import torch

    stack = harness.load_json(harness.HERE / "configs" / "box_stack4.json")
    assert work.step_bytes(stack, 4096) == 2 * 4096 * 4 * 13 * 4 + 4 * 22 * 4 + 6 * 16
    # body 2 static; lanes: ground-0, 0-1, 1-2, an empty lane
    free = torch.tensor([True, True, False])
    b0 = torch.tensor([[-1, 0, 1, -1]])
    b1 = torch.tensor([[0, 1, 2, -1]])
    active = torch.tensor([[True, True, True, False]])
    assert work.contact_flops(free, b0, b1, active, 2) == 21 * 3 * 4 + 12 * (9 * 2 + 6 * 4) \
        + 2 * 2 * 9 * 7
    gen = torch.Generator().manual_seed(3)
    b0 = torch.randint(-1, 5, (3, 8), generator=gen)
    b1 = torch.randint(0, 5, (3, 8), generator=gen)
    active = (torch.rand((3, 8), generator=gen) < 0.7) & (b0 != b1)
    free = torch.tensor([True, False, True, True, False])
    assert work.contact_flops(free, b0, b1, active, 16) == _brute_force_flops(
        free, b0, b1, active, 16)
    tally = work.Tally(free, 16)
    assert tally.per_scenario_step() is None
    tally.add(b0, b1, active)
    tally.add(b0, b1, torch.zeros_like(active))
    assert tally.per_scenario_step() == pytest.approx(
        _brute_force_flops(free, b0, b1, active, 16) / 6)
    assert work.bound_s(3.35e12, 1.0) == 1.0 and work.bound_s(0.0, 67e12) == 1.0


def _event(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _made_up_trace(lost=()):
    """Two calls of 2 replayed steps; each step two kernels, one of them
    overlapping the other; a copy outside the replays; a gap.  `lost`:
    (call, kernel) pairs the profiler lost."""
    ev = [_event("user_annotation", tr.WINDOW, 0, 1000)]
    for c, t0 in enumerate((0, 500)):
        ev.append(_event("user_annotation", tr.CALL, t0, 400))
        ev.append(_event("cuda_runtime", "cudaGraphLaunch", t0 + 1, 2, corr=10 + c))
        for k, (name, at) in enumerate((("step_a", 10), ("step_b", 50), ("step_a", 160))):
            if (c, k) not in lost:
                ev.append(_event("kernel", name, t0 + at, 100, corr=10 + c))
        ev.append(_event("gpu_memcpy", "Memcpy DtoH", t0 + 300, 20, corr=20 + c))
        ev.append(_event("cpu_op", "aten::copy_", t0 + 270, 40))
    return tr.parse(ev)


def test_trace_reader_and_layer_arithmetic():
    t = _made_up_trace()
    assert len(t.ops) == 8 and sum(o.graph for o in t.ops) == 6
    assert tr.busy_s(t) == pytest.approx(2 * (240 + 20) * 1e-6)
    assert tr.window_s(t) == pytest.approx(1e-3)
    stack = harness.load_json(harness.HERE / "configs" / "box_stack4.json")
    assert tr.replayed_per_call(t) == [3, 3] and tr.complete(t, 1) and not tr.complete(t, 2)
    view = layers.View(t, 1, 4096, stack, 2e5)
    assert layers.call_overhead_ms(view) == pytest.approx((400 - 250) * 1e-3)
    assert layers.outside_replays_ms(view) == pytest.approx(20e-3)
    assert layers.collectives_ms(view) is None
    assert layers.ops_per_step(view) == pytest.approx(6 / 2)
    assert layers.chain_roofline(view) == pytest.approx(
        100 * max(work.step_bytes(stack, 4096) / 3.35e12, 2e5 * 4096 / 67e12) / (240e-6 / 1))
    assert layers.chain_roofline(view._replace(flops_per_scenario_step=None)) is None
    assert layers.device_idle_pct(view) == pytest.approx(100 * (1 - 0.52))
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["step_a", pytest.approx(400e-6)]
    assert b["idle_gaps"][0] == ["host, untraced", pytest.approx(190e-6)]
    assert ["aten::copy_", pytest.approx(40e-6)] in b["idle_gaps"]


@pytest.mark.parametrize("lost", [((1, 1),), ((0, 0), (1, 2), (1, 1)), ((0, 2),)])
def test_a_stretch_with_lost_operations_is_not_read(lost):
    t = _made_up_trace(lost)
    assert not tr.complete(t, 1)
    # one operation lost in every call: no longer a whole number of steps
    assert tr.complete(_made_up_trace(), 3) and not tr.complete(_made_up_trace(((0, 0), (1, 2))), 3)
    stack = harness.load_json(harness.HERE / "configs" / "box_stack4.json")
    view = layers.View(t, 1, 4096, stack, 2e5)
    for read in (layers.call_overhead_ms, layers.outside_replays_ms, layers.collectives_ms,
                 layers.ops_per_step, layers.chain_roofline, layers.device_idle_pct):
        assert read(view) is None, read


def test_stretch_is_traced_again_where_operations_were_lost(monkeypatch):
    made = iter([_made_up_trace(((1, 1),)), _made_up_trace(((0, 0),)), _made_up_trace()])
    starts = []
    monkeypatch.setattr(tr, "start", lambda: starts.append(1))
    monkeypatch.setattr(tr, "finish", lambda prof: next(made))
    stretch = tr.Stretch(skip=1, calls=2, steps_per_call=1)
    done = []
    for i in range(12):
        with stretch.span(i):
            pass
        done.append(stretch.done(i))
    # attempts: calls 0-2, 3-5, 6-8; the third is complete
    assert done == [False] * 8 + [True] * 4
    assert stretch.tries == 3 and len(starts) == 3 and tr.complete(stretch.trace, 1)
    made = iter([_made_up_trace(((1, 1),))] * 2)
    stretch = tr.Stretch(skip=0, calls=2, steps_per_call=1, attempts=2)
    done = []
    for i in range(4):
        with stretch.span(i):
            pass
        done.append(stretch.done(i))
    assert done == [False, False, False, True]
    assert not tr.complete(stretch.trace, 1)


def test_run_loads_nothing_of_jax():
    code = ("from portbench import run, harness; r = run.rehearse('stack4_rollouts', 3); "
            "print(r['foreign_modules'], harness.foreign_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_foreign_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "eggshell_tpu_torch_extra", sys)
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.foreign_modules() == ["jax"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "stack4_rollouts",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card only")


@pytest.mark.cuda
def test_run_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "stack4_rollouts",
                          "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "checks"
