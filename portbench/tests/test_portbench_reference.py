"""The benchmark's plain reference (`portbench/references/rigid_contact.py`)
against the program's plain path on the CPU in float64, at small batches:
the rollout of both configurations, and one MPPI update from the same
generator state.  The reference imports nothing of the program; the tests
do, to hold the two together."""

import pytest
import torch

from eggshell_tpu_torch.mpc import sampling
from eggshell_tpu_torch.parallel import rollout as port_rollout
from eggshell_tpu_torch.physics.scene import State
from portbench import harness

TOL = 1e-9


def _setup(name, B, seed):
    config = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    ref = harness.load_module(harness.HERE / "references" / "rigid_contact.py", "ref_under_test")
    spec, base = harness.port_scene(config, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(seed)
    n = base.p.shape[0]
    p = base.p.expand(B, n, 3) + torch.rand((B, 1, 3), generator=gen, dtype=torch.float64) * 1e-3
    start = State(p, base.v.expand(B, n, 3), base.q.expand(B, n, 4), base.w.expand(B, n, 3))
    return config, ref, spec, start


@pytest.mark.parametrize("name", ["box_stack4", "living_room"])
def test_reference_rollout_matches_program(name):
    config, ref, spec, start = _setup(name, 5, 11)
    got = port_rollout.rollout_batched(spec, start, harness.port_config(config), 8)
    scene, _ = ref.scene_of(config, torch.float64, "cpu", torch.float64)
    want = ref.rollout(scene, ref.Bodies(*start), ref.solver_of(config), 8)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=TOL), float((a - b).abs().max())
    assert float((want.p - start.p).abs().max()) > 1e-6          # the step does move them


def test_reference_mppi_update_matches_program():
    config, ref, spec, start = _setup("living_room", 1, 12)
    cfg = harness.port_config(config)
    state = State(*(x[0] for x in start))
    target = torch.tensor([0.0, 0.0, 0.5], dtype=torch.float64)
    mean = torch.randn((4, 6), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    gen = torch.Generator().manual_seed(99)
    g_state = gen.get_state()
    new_mean, costs = sampling.mppi_update_batched(
        spec, state, cfg, mean, gen, lambda f: torch.sum((f.p[4] - target) ** 2),
        controlled_body=4, num_samples=6, noise_sigma=5.0, temperature=1.0,
        noise_mode="constant")
    g = torch.Generator()
    g.set_state(g_state)
    eps = torch.randn((6, 1, 6), generator=g, dtype=torch.float64)
    ctrls = (mean[None] + eps * 5.0).expand(6, 4, 6)
    scene, _ = ref.scene_of(config, torch.float64, "cpu", torch.float64)
    st = ref.Bodies(*(x.expand((6,) + x.shape[1:]) for x in start))
    final = ref.controlled_rollout(scene, st, ref.solver_of(config), ctrls, 4)
    want_costs = torch.sum((final.p[:, 4] - target) ** 2, -1)
    w = torch.exp(-(want_costs - want_costs.min()))
    want_mean = torch.einsum("s,shc->hc", w / w.sum(), ctrls)
    assert torch.allclose(costs, want_costs, rtol=0, atol=TOL)
    assert torch.allclose(new_mean, want_mean, rtol=0, atol=TOL)


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (harness.HERE / "references").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert names <= {"__future__", "math", "typing", "torch"}, (path, names)
