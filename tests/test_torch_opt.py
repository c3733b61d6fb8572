"""Port parity: `eggshell_tpu_torch.opt`, `.models`, `.utils.hashing` and
`.native` against the JAX package's, float64 on the CPU.

- Levenberg-Marquardt on tests/test_toolkit.py's Rosenbrock residuals and
  curve fit: x and the error within 1e-10, the same iteration count, and
  a budget-bound run.
- Nelder-Mead on tests/test_toolkit.py's quadratic at budgets of 400
  (stopped by xtol) and 25 iterations: x and f within 1e-8, the same
  iteration count.
- `random_search` fed the samples `jax.random.uniform` draws: the same
  best point; drawn from a generator, the JAX test's bound; an objective
  that `vmap` cannot map raises.
- `OptimizerFactory` (each name) and `RepeatedOptimizer` against the JAX
  package's within 1e-8; random search from the same generator state on
  every run.
- `Model`: sweep, optimize (Nelder-Mead and random search), the cache and
  the clipping equal to the JAX package's (tests/test_viz_models.py's
  models).
- `hashing`: `md5_hex`, `md5_file` and `hash_config` equal to the JAX
  digests; `hash_pytree` stable and sensitive to values, dtype, shape and
  structure.
- `native` on tests/test_native_lcp.py's problems equal to
  `eggshell_tpu.native`, with NumPy and with CPU tensors; building it
  leaves the tracked `native/` untouched.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu import native as jnative
from eggshell_tpu import opt as jopt
from eggshell_tpu.models import Model as JaxModel
from eggshell_tpu.models import Parameter as JaxParameter
from eggshell_tpu.utils import hashing as jhash
from eggshell_tpu_torch import native, opt
from eggshell_tpu_torch.models import Model, Parameter
from eggshell_tpu_torch.opt.random_search import _search_from_samples
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils import hashing
from torch_limits import time_limit  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol, err_msg=what)


def _rosenbrock(lib):
    return lambda x: lib.stack([1.0 - x[0], 10.0 * (x[1] - x[0] ** 2)])


T_FIT = np.linspace(0, 1, 20)


def _curve(lib, asarray):
    t = asarray(T_FIT)
    y = 2.0 * lib.exp(-1.5 * t)
    return lambda p: p[0] * lib.exp(p[1] * t) - y


LM_CASES = {
    "rosenbrock": (_rosenbrock(torch), _rosenbrock(jnp), [-1.2, 1.0], 100),
    "curve_fit": (_curve(torch, _t), _curve(jnp, jnp.asarray), [1.0, 0.0], 50),
    "rosenbrock_budget": (_rosenbrock(torch), _rosenbrock(jnp), [-1.2, 1.0], 4),
}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_levenberg_marquardt(case):
    fn, jfn, x0, iters = LM_CASES[case]
    res = opt.levenberg_marquardt(fn, _t(x0), opt.LMOptions(max_iterations=iters))
    want = jopt.levenberg_marquardt(jfn, jnp.asarray(x0), jopt.LMOptions(max_iterations=iters))
    _close(res.x.numpy(), want.x, 1e-10, "x")
    _close(float(res.error), float(want.error), 1e-10, "error")
    assert res.iterations == int(want.iterations)
    assert bool(res.converged) == bool(want.converged)
    if case != "rosenbrock_budget":
        _close(res.x.numpy(), [1.0, 1.0] if case == "rosenbrock" else [2.0, -1.5], 1e-6)
    else:
        assert res.iterations == 4


def _quadratic(x):
    return (x[0] - 3.0) ** 2 + 2.0 * (x[1] + 1.0) ** 2


@pytest.mark.parametrize("budget", [400, 25])
def test_nelder_mead(budget):
    res = opt.nelder_mead(_quadratic, _t([0.0, 0.0]), max_iterations=budget)
    want = jopt.nelder_mead(_quadratic, jnp.asarray([0.0, 0.0]), max_iterations=budget)
    _close(res.x.numpy(), want.x, 1e-8, "x")
    _close(float(res.fun), float(want.fun), 1e-8, "fun")
    assert int(res.iterations) == int(want.iterations)
    if budget == 400:
        assert int(res.iterations) < budget         # stopped by xtol
        _close(res.x.numpy(), [3.0, -1.0], 1e-3)


def _bowl(x):
    return (x - 0.5).pow(2).sum() if isinstance(x, torch.Tensor) else jnp.sum((x - 0.5) ** 2)


def test_random_search_from_jax_samples():
    lo, hi = np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    key = jax.random.PRNGKey(3)
    want = jopt.random_search(_bowl, jnp.asarray(lo), jnp.asarray(hi), key, num_samples=512)
    u = jax.random.uniform(key, (512, 2), jnp.float64)
    got = _search_from_samples(_bowl, _t(lo), _t(hi), _t(u))
    _close(got.x.numpy(), want.x, 1e-15, "x")
    _close(float(got.fun), float(want.fun), 1e-15, "fun")


def test_random_search_generator_and_refusal():
    gen = torch.Generator("cpu").manual_seed(0)
    res = opt.random_search(_bowl, _t([-1.0, -1.0]), _t([1.0, 1.0]), gen, num_samples=4096)
    assert float(res.fun) < 1e-2
    assert res.x.shape == (2,) and res.x.dtype == torch.float64

    def host_read(x):
        return torch.tensor(float(x.sum()))

    with pytest.raises(RuntimeError):
        opt.random_search(host_read, _t([0.0]), _t([1.0]), gen, num_samples=8)


def _target2(x):
    return ((x - 2.0) ** 2).sum()


def test_optimizer_factory():
    o = opt.OptimizerFactory.create("nelder_mead", _target2, device="cpu", max_iterations=300)
    jo = jopt.OptimizerFactory.create("nelder_mead", lambda x: jnp.sum((x - 2.0) ** 2),
                                      max_iterations=300)
    assert o.initialize(np.zeros(2)) is None and o.step(0.0) is None
    jo.initialize(np.zeros(2))
    (x, f), (jx, jf) = o.best(), jo.best()
    assert isinstance(x, np.ndarray) and isinstance(f, float)
    _close(x, jx, 1e-8)
    _close(f, jf, 1e-8)
    _close(x, [2.0, 2.0], 1e-3)

    # LM takes f itself as the one residual, so with two unknowns its damped
    # system is a rank-one JtJ plus lambda diag(JtJ), near singular once
    # lambda is small, and the two packages' rounding part (1.5e-7 after 10
    # iterations); with one unknown it is a scalar solve.
    o = opt.OptimizerFactory.create("levenberg_marquardt", _target2, device="cpu")
    jo = jopt.OptimizerFactory.create("levenberg_marquardt", lambda x: jnp.sum((x - 2.0) ** 2))
    o.initialize(np.zeros(1))
    jo.initialize(np.zeros(1))
    _close(o.best()[0], jo.best()[0], 1e-12)
    _close(o.best()[1], jo.best()[1], 1e-12)
    _close(o.best()[0], [2.0], 1e-6)

    bounds = (np.asarray([0.0, 0.0]), np.asarray([4.0, 4.0]))
    o = opt.OptimizerFactory.create("random_search", _target2, bounds=bounds, device="cpu")
    o.initialize(np.zeros(2))
    first = o.best()
    assert first[1] < 0.1
    o.initialize(np.ones(2))            # the same generator state on every run
    np.testing.assert_array_equal(o.best()[0], first[0])
    with pytest.raises(ValueError):
        opt.OptimizerFactory.create("simplex", _target2, device="cpu")


def test_repeated_optimizer():
    def make(lib_opt, fn, **kw):
        return lambda: lib_opt.OptimizerFactory.create("nelder_mead", fn, max_iterations=60, **kw)

    r = opt.RepeatedOptimizer(make(opt, _quadratic, device="cpu"), repeats=3, jitter=0.5, seed=2)
    jr = jopt.RepeatedOptimizer(make(jopt, _quadratic), repeats=3, jitter=0.5, seed=2)
    r.initialize(np.zeros(2))
    jr.initialize(np.zeros(2))
    _close(r.best()[0], jr.best()[0], 1e-8)
    _close(r.best()[1], jr.best()[1], 1e-8)


def _models(lib_model, lib_param):
    calls = []

    def builder(params):
        calls.append(dict(params))
        return params

    def output(sol):
        return (sol["x"] - 1.0) ** 2 + (sol["y"] + 2.0) ** 2

    m = lib_model(builder, [lib_param("x", -5, 5, 0.0), lib_param("y", -5, 5, 0.0)],
                  output=output)
    return m, calls


def test_model_sweep_optimize_cache_and_clip():
    m, calls = _models(Model, Parameter)
    jm, _ = _models(JaxModel, JaxParameter)
    vals = m.sweep("x", [0.0, 0.5, 1.0, 1.5])
    assert vals == jm.sweep("x", [0.0, 0.5, 1.0, 1.5])
    assert np.argmin(vals) == 2

    best, fval = m.optimize("nelder_mead")
    jbest, jfval = jm.optimize("nelder_mead")
    assert best == jbest and fval == jfval
    assert abs(best["x"] - 1.0) < 1e-3 and abs(best["y"] + 2.0) < 1e-3

    best, fval = m.optimize("random_search", num_samples=300, seed=4)
    assert (best, fval) == jm.optimize("random_search", num_samples=300, seed=4)

    n0 = len(calls)
    m.run({"x": 1.0, "y": 1.0})
    m.run({"x": 1.0, "y": 1.0})
    assert len(calls) == n0 + 1
    assert m.run({"x": 99.0, "y": 0.0})["x"] == 5.0
    assert jm.run({"x": 99.0, "y": 0.0}) == m.run({"x": 99.0, "y": 0.0})

    ints = Model(lambda p: p, [Parameter("k", 0, 10, 2.4, integer=True)], output=lambda s: s["k"])
    assert ints.run() == {"k": 2} and ints.run({"k": 7.6}) == {"k": 8}
    with pytest.raises(ValueError):
        m.optimize("gradient")


def test_hashing(tmp_path):
    data = b"eggshell" * 1000
    assert hashing.md5_hex(data) == jhash.md5_hex(data)
    path = tmp_path / "blob.bin"
    path.write_bytes(os.urandom(3 << 20))
    assert hashing.md5_file(str(path)) == jhash.md5_file(str(path))
    cfg = {"b": [1, 2.5, "x"], "a": {"z": None, "y": True}, "c": np.float64(0.1)}
    assert hashing.hash_config(cfg) == jhash.hash_config(cfg)

    def tree(scale=1.0, dtype=torch.float64, n=3):
        st = State(*(scale * torch.arange(n * k, dtype=dtype).reshape(n, k) for k in (3, 3, 4, 3)))
        return {"state": st, "steps": [1, 2], "eps": np.eye(2)}

    h = hashing.hash_pytree(tree())
    assert h == hashing.hash_pytree(tree())
    assert len(h) == 32
    others = [tree(scale=2.0), tree(dtype=torch.float32), tree(n=4),
              {**tree(), "steps": (1, 2)}, {**tree(), "extra": None}]
    assert len({h, *(hashing.hash_pytree(t) for t in others)}) == 1 + len(others)
    # a tensor and the equal NumPy array are the same leaf
    assert hashing.hash_pytree([torch.eye(2, dtype=torch.float64)]) == hashing.hash_pytree(
        [np.eye(2)])


def _spd(rng, n):
    m = rng.uniform(-1, 1, (n, n))
    return m.T @ m + 0.1 * n * np.eye(n)


def _native_equal(got, want):
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g == w
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_native_matches_jax_package(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    problems = []
    for _ in range(10):                              # test_native_certification_100's load
        n = 50
        problems.append((_spd(rng, n), rng.uniform(-1, 1, n), np.full(n, -rng.uniform(0.1, 1.0)),
                         np.full(n, rng.uniform(0.1, 1.0))))
    rng = np.random.default_rng(3)
    for _ in range(5):                               # the Cottle-Dantzig and Schur problems
        n = 25
        lo = np.where(rng.random(n) < 0.4, -np.inf, -rng.random(n))
        problems.append((_spd(rng, n), rng.uniform(-3, 3, n), lo,
                         np.where(np.isinf(lo), np.inf, rng.random(n))))
    for A, b, lo, hi in problems:
        for alg in ("murty", "cottle_dantzig"):
            _native_equal(native.solve_box_lcp(A, b, lo, hi, algorithm=alg, return_info=True),
                          jnative.solve_box_lcp(A, b, lo, hi, algorithm=alg, return_info=True))
        _native_equal(native.solve_box_lcp_schur(A, b, lo, hi),
                      jnative.solve_box_lcp_schur(A, b, lo, hi))

    rng = np.random.default_rng(11)                  # test_native_fallback_and_stats
    G = rng.normal(size=(40, 20))
    A, b = G @ G.T + 0.01 * np.eye(40), rng.normal(size=40) * 5
    lo, hi = np.full(40, -0.5), np.full(40, 0.5)
    x, w, info = native.solve_box_lcp(A, b, lo, hi, max_iterations=4, return_info=True)
    assert info["fallback_used"] and info["iterations"] == 4
    _native_equal((x, w, info), jnative.solve_box_lcp(A, b, lo, hi, max_iterations=4,
                                                      return_info=True))

    rng = np.random.default_rng(2)                   # test_native_batch
    A = np.stack([_spd(rng, 20) for _ in range(32)])
    b = rng.uniform(-1, 1, (32, 20))
    lo, hi = np.full((32, 20), -1.0), np.full((32, 20), 1.0)
    want = jnative.solve_box_lcp_batch(A, b, lo, hi)
    assert want[2].all()
    _native_equal(native.solve_box_lcp_batch(A, b, lo, hi), want)
    got = native.solve_box_lcp_batch(*(torch.tensor(v) for v in (A, b, lo, hi)))
    assert all(isinstance(g, torch.Tensor) for g in got)
    _native_equal(got, want)
    with pytest.raises(ValueError):
        native.solve_box_lcp_batch(A[:, :19], b, lo, hi)

    # a fresh build writes only into its build directory
    tracked = os.path.join(ROOT, "native", "libeggshell_native.so")
    listing = sorted(os.listdir(os.path.join(ROOT, "native")))
    with open(tracked, "rb") as f:
        before = f.read()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    lib = native.build()
    assert lib.parent == tmp_path / "build" and lib.exists()
    _native_equal(native.solve_box_lcp(*problems[0]), jnative.solve_box_lcp(*problems[0]))
    with open(tracked, "rb") as f:
        assert f.read() == before
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == listing
