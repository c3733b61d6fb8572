"""Port parity: the direct LCP solvers (`eggshell_tpu_torch.ops.lcp_direct`),
the port's oracle copies and the stepper under SolverKind.DIRECT, against
the JAX package, on the CPU in float64.

- `murty_principal_pivot` without and with bounds, and
  `mixed_constraints_solver`, batched over the first 10 problems of
  tests/test_lcp.py's generator (its bounds and equality splits), against
  the JAX package's vmapped solvers: x and w within 1e-10, `converged` and
  every `LcpInfo` field equal; each scenario's pivots equal a call on it
  alone.
- The fallback and the default pivot budget (tests/test_lcp.py:216-299),
  x and w within 1e-10 of their largest magnitude (the budgeted iterate of
  the near-singular problem reaches |x| ~ 600), LcpInfo against the JAX
  package's (goodness within 1e-12 relative: the sums run in another
  order).
- `mixed_constraints_solver_implicit`'s gradients against the JAX
  package's, within 1e-10.
- `eggshell_tpu_torch.oracle` against `eggshell_tpu.oracle`: exactly equal.
- `step_ode` and `step_ode_batched` under DIRECT, 4 steps on box_stack(3)
  and pendulum_chain(3), against the JAX package's, within 1e-8.
- The port's `step_ode` under DIRECT, 30 steps of box_stack(4) in
  tools/golden/gen_oracle_npz.py's configuration, against
  tests/data/oracle_stack4_f64.npz's p30 and v30, within 1e-8.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.oracle import lcp_oracle as jorc_lcp
from eggshell_tpu.oracle import sim_oracle as jorc_sim
from eggshell_tpu.ops import lcp_direct as jdir
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.ops import lcp_direct as tdir
from eggshell_tpu_torch.oracle import lcp_oracle as torc_lcp
from eggshell_tpu_torch.oracle import sim_oracle as torc_sim
from eggshell_tpu_torch.physics import stepper as tstep
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind
from test_lcp import SIZE, gen_spd
from torch_limits import time_limit  # noqa: F401

ORACLE = os.path.join(os.path.dirname(__file__), "data", "oracle_stack4_f64.npz")
NUM = 10
B = 2
DIRECT = dict(solver=SolverKind.DIRECT, conditional_cfm=False, cfm_always=0.01,
              contact_capacity=12, contact_kernel=False)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _problems():
    """tests/test_lcp.py's first NUM problems, with the bounds of its
    bounded Murty test (seed 1) and the equality split of its mixed test
    (seed 3), stacked."""
    rng = np.random.default_rng(0)
    probs = [(gen_spd(rng, SIZE), rng.uniform(-1, 1, SIZE)) for _ in range(30)][:NUM]
    rb, re = np.random.default_rng(1), np.random.default_rng(3)
    lo_b, hi_b, eq = [], [], []
    for _ in probs:
        lo_b.append(np.full(SIZE, -rb.uniform(0, 2)))
        hi_b.append(np.full(SIZE, rb.uniform(0.01, 2)))
        eq.append(re.uniform(size=SIZE) < 0.4)
    A = np.stack([p[0] for p in probs])
    b = np.stack([p[1] for p in probs])
    return {"A": A, "b": b, "lo0": np.zeros((NUM, SIZE)), "hi0": np.full((NUM, SIZE), np.inf),
            "lo_b": np.stack(lo_b), "hi_b": np.stack(hi_b), "eq": np.stack(eq),
            "lo_m": np.full((NUM, SIZE), -5.0), "hi_m": np.full((NUM, SIZE), 5.0)}


CASES = ("murty", "murty_bounds", "mixed")


def _case_args(case, pr, as_):
    A, b = as_(pr["A"]), as_(pr["b"])
    if case == "murty":
        return A, b, as_(pr["lo0"]), as_(pr["hi0"])
    if case == "murty_bounds":
        return A, b, as_(pr["lo_b"]), as_(pr["hi_b"])
    return A, b, as_(pr["eq"]), as_(pr["lo_m"]), as_(pr["hi_m"])


@functools.lru_cache(maxsize=None)
def _jax_direct():
    pr = _problems()

    def run(*arrays):
        out = {}
        for case in CASES:
            args = _case_args(case, dict(zip(sorted(pr), arrays)), lambda x: x)
            if case == "mixed":
                fn = functools.partial(jdir.mixed_constraints_solver, return_info=True)
            else:
                fn = functools.partial(jdir.murty_principal_pivot, return_info=True)
            out[case] = jax.vmap(fn)(*args)
        return out

    res = jax.jit(run)(*(jnp.asarray(pr[k]) for k in sorted(pr)))
    return {case: jax.tree_util.tree_map(np.asarray, v) for case, v in res.items()}


def _port(case, rows=slice(None)):
    pr = {k: v[rows] for k, v in _problems().items()}
    args = _case_args(case, pr, torch.tensor)
    fn = tdir.mixed_constraints_solver if case == "mixed" else tdir.murty_principal_pivot
    return fn(*args, return_info=True)


def _info_equal(got, want, rows=slice(None)):
    assert np.array_equal(got.converged.numpy(), np.asarray(want.converged)[rows])
    assert np.array_equal(got.iterations.numpy(), np.asarray(want.iterations)[rows])
    assert np.array_equal(got.fallback_used.numpy(), np.asarray(want.fallback_used)[rows])
    np.testing.assert_allclose(got.goodness.numpy(), np.asarray(want.goodness)[rows],
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_direct_solvers_match_jax(case):
    x, w, info = _port(case)
    wx, ww, winfo = _jax_direct()[case]
    _close(x.numpy(), wx, 1e-10, "x")
    _close(w.numpy(), ww, 1e-10, "w")
    _info_equal(info, winfo)
    assert bool(info.converged.all())
    assert int(info.iterations.min()) > 1        # each problem pivots
    assert len(set(info.iterations.tolist())) > 1  # and they part: the carries freeze


@pytest.mark.parametrize("case", CASES)
def test_each_scenario_pivots_as_alone(case):
    _, _, info = _port(case)
    for i in (0, 3):
        x1, _, one = _port(case, slice(i, i + 1))
        assert int(one.iterations[0]) == int(info.iterations[i])
        _close(x1[0].numpy(), _jax_direct()[case][0][i], 1e-10, "x alone")


def _fallback_problem():
    """tests/test_lcp.py:216-227's near-singular problem."""
    rng = np.random.default_rng(11)
    n = 40
    G = rng.normal(size=(n, n // 2))
    return G @ G.T + 0.01 * np.eye(n), rng.normal(size=n) * 5, np.full(n, -0.5), np.full(n, 0.5)


def _murty_family(n):
    """tests/test_lcp.py:262-266: Murty's exponential family."""
    return (np.eye(n) + 2 * np.triu(np.ones((n, n)), 1), np.ones(n), np.zeros(n),
            np.full(n, np.inf))


BUDGETS = [("fallback", 1024), ("fallback", 4), ("family10", None), ("family10", 256),
           ("family12", None)]


@functools.lru_cache(maxsize=None)
def _problem(name):
    return _fallback_problem() if name == "fallback" else _murty_family(int(name[-2:]))


@pytest.mark.parametrize("name,budget", BUDGETS)
def test_fallback_and_pivot_budget_match_jax(name, budget):
    A, b, lo, hi = _problem(name)
    want = jdir.murty_principal_pivot(*map(jnp.asarray, (A, b, lo, hi)), max_iterations=budget,
                                      return_info=True)
    x, w, info = tdir.murty_principal_pivot(*(torch.tensor(v)[None] for v in (A, b, lo, hi)),
                                            max_iterations=budget, return_info=True)
    for got, ref, what in ((x, want[0], "x"), (w, want[1], "w")):
        _close(got[0].numpy(), ref, 1e-10 * max(1.0, float(np.abs(ref).max())), what)
    winfo = jdir.LcpInfo(*(np.asarray(v)[None] for v in want[2]))
    _info_equal(info, winfo)
    expect = {("fallback", 1024): (True, None), ("fallback", 4): (False, 4),
              ("family10", None): (True, None), ("family10", 256): (False, 256),
              ("family12", None): (False, 1000)}[(name, budget)]
    assert bool(info.converged[0]) == expect[0]
    if expect[1] is not None:
        assert int(info.iterations[0]) == expect[1]
    if name == "family10" and budget is None:
        assert int(info.iterations[0]) > 256
    if not expect[0]:
        assert bool(info.fallback_used[0]) and float(info.goodness[0]) > 0
        x2, _, ok = tdir.murty_principal_pivot(*(torch.tensor(v)[None] for v in (A, b, lo, hi)),
                                               max_iterations=budget)
        assert not bool(ok[0]) and torch.equal(x2, x)


@functools.lru_cache(maxsize=None)
def _jax_implicit_grads():
    pr = _problems()
    A, b, eq, lo, hi = (jnp.asarray(pr[k][0]) for k in ("A", "b", "eq", "lo_m", "hi_m"))
    lo, hi = lo * 0.1, hi * 0.1

    def f(A_, b_, lo_, hi_):
        return jnp.sum(jdir.mixed_constraints_solver_implicit(A_, b_, eq, lo_, hi_) ** 3)

    return tuple(map(np.asarray, jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(A, b, lo, hi)))


def test_implicit_mixed_solver_gradients_match_jax():
    pr = _problems()
    A, b, eq, lo, hi = (torch.tensor(pr[k][:1]) for k in ("A", "b", "eq", "lo_m", "hi_m"))
    args = [t.clone().requires_grad_() for t in (A, b, lo * 0.1, hi * 0.1)]
    x = tdir.mixed_constraints_solver_implicit(args[0], args[1], eq, args[2], args[3])
    clamped = ~eq & ((x >= args[3] - 1e-8) | (x <= args[2] + 1e-8))
    assert bool(clamped.any()) and bool((~clamped & ~eq).any())
    torch.sum(x ** 3).backward()
    for t, want, what in zip(args, _jax_implicit_grads(), ("A", "b", "lo", "hi")):
        assert np.abs(want).max() > 0
        _close(t.grad[0].numpy(), want, 1e-10, f"d/d{what}")


def test_oracle_copies_equal_the_jax_packages():
    pr = _problems()
    A, b, eq = pr["A"][0], pr["b"][0], pr["eq"][0]
    for lo, hi in ((None, None), (pr["lo_b"][0], pr["hi_b"][0])):
        got, want = torc_lcp.murty_principal_pivot(A, b, lo, hi), \
            jorc_lcp.murty_principal_pivot(A, b, lo, hi)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    got = torc_lcp.mixed_constraints_solver(A, b, eq, pr["lo_m"][0], pr["hi_m"][0])
    want = jorc_lcp.mixed_constraints_solver(A, b, eq, pr["lo_m"][0], pr["hi_m"][0])
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert torc_lcp.check_lcp_solution(A, b, got[0], got[1], eq, pr["lo_m"][0], pr["hi_m"][0],
                                       1e-8)
    scenes = []
    for mod in (torc_sim, jorc_sim):
        sc = mod.OracleScene(p=[[0, 0, 0.5], [0, 0, 1.5]], v=[[0.1, 0, 0], [0, 0, 0]],
                             q=[[1, 0, 0, 0], [0.9, 0.1, 0, 0]], w=[[0, 0, 0.2], [0, 0.1, 0]],
                             mass=[1.0, 2.0], inertia_body=np.stack([np.eye(3)] * 2) * 0.1,
                             static=[False, False],
                             joints=[(0, 1, np.array([0, 0, 0.5]), np.array([0, 0, -0.5]))])
        contacts = [(-1, 0, np.array([x, y, 0.0]), np.array([0.0, 0.0, 1.0]), 1e-3)
                    for x in (-0.5, 0.5) for y in (-0.5, 0.5)]
        for cond in (True, False, False):
            mod.step_ode(sc, contacts, conditional_cfm=cond)
        scenes.append(sc)
    for k in ("p", "v", "q", "w"):
        assert np.array_equal(getattr(scenes[0], k), getattr(scenes[1], k))


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


STEP_SCENES = {"box_stack3": (lambda: js.box_stack(3), 12),
               "pendulum_chain3": (lambda: js.pendulum_chain(3), 4)}
STEPS = 4


def _step_cfg(name):
    return SimConfig(**{**DIRECT, "contact_capacity": STEP_SCENES[name][1]})


def _batched_fields(st):
    out = {k: np.broadcast_to(np.asarray(v), (B,) + v.shape).copy() for k, v in _np(st).items()}
    out["p"] = out["p"] + np.linspace(0, 1e-3, B)[:, None, None]
    return out


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    """The JAX package's STEPS steps of `step_ode` and of `step_ode_batched`
    under DIRECT, in one program."""
    spec, st = STEP_SCENES[name][0]()
    jcfg = JaxSimConfig.from_json(_step_cfg(name).to_json())
    sts = type(st)(**{k: jnp.asarray(v) for k, v in _batched_fields(st).items()})

    def run(s, ss):
        def body(carry, _):
            a, b = carry
            return (jstep.step_ode(spec, a, jcfg)[0], jstep.step_ode_batched(spec, b, jcfg)), None

        return jax.lax.scan(body, (s, ss), None, length=STEPS)[0]

    single, batched = jax.jit(run)(st, sts)
    return _np(single), _np(batched)


@pytest.mark.parametrize("name", sorted(STEP_SCENES))
def test_direct_steps_match_jax(name):
    spec, st = STEP_SCENES[name][0]()
    cfg = _step_cfg(name)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    single = convert.state_from_numpy(_np(st), device="cpu", dtype=torch.float64)
    fields = _batched_fields(st)
    batched = State(*(torch.tensor(fields[k]) for k in State._fields))
    for _ in range(STEPS):
        single = tstep.step_ode(tspec, single, cfg)[0]
        batched = tstep.step_ode_batched(tspec, batched, cfg)
    want_single, want_batched = _jax_steps(name)
    for k in "pvqw":
        _close(getattr(single, k).numpy(), want_single[k], 1e-8, f"step_ode {k}")
        _close(getattr(batched, k).numpy(), want_batched[k], 1e-8, f"step_ode_batched {k}")
    assert float(np.abs(want_single["v"]).max()) > 1e-3


def test_direct_step_ode_matches_the_oracle_npz():
    """tools/golden/gen_oracle_npz.py's configuration: box_stack(4), f64,
    cfm 0.01 always, contact capacity 64."""
    from eggshell_tpu_torch.physics import scenes as ts

    spec, st = ts.box_stack(4, device="cpu", dtype=torch.float64)
    cfg = SimConfig(solver=SolverKind.DIRECT, conditional_cfm=False, cfm_always=0.01,
                    contact_capacity=64)
    for _ in range(30):
        st = tstep.step_ode(spec, st, cfg)[0]
    ref = np.load(ORACLE)
    _close(st.p.numpy(), ref["p30"], 1e-8, "p30")
    _close(st.v.numpy(), ref["v30"], 1e-8, "v30")
