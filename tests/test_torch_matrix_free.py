"""Port parity: the matrix-free large-scene tier of `eggshell_tpu_torch`
against the JAX package, on the CPU in float64.

- `build_compact_constraints` on a compressed `box_pile(27)` (and on a
  jointed chain) under NO_FRICTION, INFINITE and BOX friction: ids and
  masks equal, blocks and bounds within 1e-10; COULOMB_PYRAMID raises on
  both sides; `compact_blocks` from the dense system within 1e-10;
- `jt_x`, `j_v`, `jmjt_matvec` and `jmjt_diagonal` within 1e-10, and
  `solve_lcp_matrix_free` on the step's rhs in every `matvec_mode`
  ("segment", "onehot", "sorted", "auto") against the JAX package's
  "segment" and "onehot", within 1e-10 of the solution's largest
  magnitude;
- `step_ode_batched` and `step_ode` under MATRIX_FREE on `box_pile(27)`
  (B = 3, K = 256, pair capacity 128, margin 0.05, 40 sweeps, the JAX
  package's `test_step_ode_batched_matrix_free_matches_single`), with and
  without control wrenches, 4 steps, states within 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.ops import lcp_matrix_free as jmf
from eggshell_tpu.physics import constraints as jcon
from eggshell_tpu.physics import contacts as jcont
from eggshell_tpu.physics import scene as jscene
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.physics.scene import State as JaxState
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.ops import lcp_matrix_free as tmf
from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics import constraints as tcon
from eggshell_tpu_torch.physics import contacts as tcont
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.physics.stepper import step_ode, step_ode_batched
from eggshell_tpu_torch.utils.config import BENCH, FrictionModel, SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

TOL = 1e-10


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _jax_cfg(cfg: SimConfig) -> JaxSimConfig:
    return JaxSimConfig.from_json(cfg.to_json())


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _pile(B=2, seed=0):
    """A compressed box_pile(27), each box shifted by up to 2 mm and turned
    by up to about 0.05 rad (seeded): B scenarios with some 250 contacts."""
    spec, st = js.box_pile(27, spacing=0.97, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    n = st.p.shape[0]
    p = np.asarray(st.p)[None] + rng.uniform(-2e-3, 2e-3, (B, n, 3))
    p[..., 2] -= 3e-3
    phi = rng.uniform(-0.05, 0.05, (B, n, 3))
    ang = np.linalg.norm(phi, axis=-1, keepdims=True)
    q = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * phi / ang], -1)
    v = rng.uniform(-0.1, 0.1, (B, n, 3))
    w = rng.uniform(-0.1, 0.1, (B, n, 3))
    jst = JaxState(p=jnp.asarray(p), v=jnp.asarray(v), q=jnp.asarray(q), w=jnp.asarray(w))
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tst = convert.state_from_numpy(_np(jst), device="cpu", dtype=torch.float64)
    return spec, jst, tspec, tst


PILE_CFG = BENCH.replace(solver=SolverKind.MATRIX_FREE, solver_iters=40, contact_capacity=256,
                         pair_capacity=128, broadphase_margin=0.05, max_correcting_vel=2.0)


@functools.lru_cache(maxsize=None)
def _jax_system(fm):
    """The JAX package's contacts and compact system of the pile under
    friction model `fm`, and its dense system (for compact_blocks)."""
    spec, jst, _, _ = _pile()
    jcfg = _jax_cfg(PILE_CFG.replace(friction_model=fm))

    def one(s):
        cs = jcont.make_contacts(spec, s, jcfg)
        return cs, jcon.build_compact_constraints(spec, s, cs, jcfg), \
            jcon.build_constraints(spec, s, cs, jcfg)
    return jax.jit(jax.vmap(one))(jst)


@pytest.mark.parametrize("fm", ["NO_FRICTION", "INFINITE", "BOX"])
def test_build_compact_constraints_matches_jax(fm):
    fm = FrictionModel[fm]
    _, _, tspec, tst = _pile()
    cfg = PILE_CFG.replace(friction_model=fm)
    cs = tcont.make_contacts_batched(tspec, tst, cfg)
    jcs, want, jdense = _jax_system(fm)
    np.testing.assert_array_equal(cs.active.numpy(), np.asarray(jcs.active))
    assert int(cs.active.sum(1).min()) > 150
    got = tcon.build_compact_constraints(tspec, tst, cs, cfg)
    for k in ("b0", "b1", "is_eq", "row_active"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    for k in ("blocks", "err", "lo", "hi"):
        _close(getattr(got, k), getattr(want, k), what=k)
    # the compact blocks taken out of the dense system
    dense = tcon.build_constraints(tspec, tst, cs, cfg)
    blocks, b0, b1 = tmf.compact_blocks(dense, cs, tspec)
    _close(dense.J, jdense.J, what="J")
    jb = jax.jit(jax.vmap(lambda d, c: jmf.compact_blocks(d, c, _pile()[0])))(jdense, jcs)
    _close(blocks, jb[0], what="compact_blocks")
    np.testing.assert_array_equal(b0.numpy(), np.asarray(jb[1]))


def test_compact_constraints_joints_and_pyramid():
    """A compressed collide-chain: joint lanes first, then contacts; and
    COULOMB_PYRAMID raises as in the JAX package."""
    spec, st = js.chain(3, collide=True, dtype=jnp.float64)
    st = st._replace(p=st.p * jnp.asarray([0.98, 1.0, 1.0]))
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tst = convert.state_from_numpy(_np(st), device="cpu", dtype=torch.float64)
    tst = State(*(x[None] for x in tst))
    cfg = BENCH.replace(contact_capacity=16, min_constraint_distance=0.05)
    cs = tcont.make_contacts_batched(tspec, tst, cfg)
    got = tcon.build_compact_constraints(tspec, tst, cs, cfg)
    jcfg = _jax_cfg(cfg)

    def one(s):
        c = jcont.make_contacts(spec, s, jcfg)
        return c, jcon.build_compact_constraints(spec, s, c, jcfg)
    jcs, want = jax.jit(one)(st)
    for k in ("b0", "b1", "is_eq", "row_active"):
        np.testing.assert_array_equal(getattr(got, k)[0].numpy(), np.asarray(getattr(want, k)))
    for k in ("blocks", "err", "lo", "hi"):
        _close(getattr(got, k)[0], getattr(want, k), what=k)
    pyr = cfg.replace(friction_model=FrictionModel.COULOMB_PYRAMID)
    with pytest.raises(NotImplementedError, match="dense-path"):
        tcon.build_compact_constraints(tspec, tst, cs, pyr)
    with pytest.raises(NotImplementedError):
        jcon.build_compact_constraints(spec, st, jcs, _jax_cfg(pyr))


@functools.lru_cache(maxsize=None)
def _lcp():
    """The pile's compact BOX system, Minv, the step's rhs and random x
    and v, both sides."""
    spec, jst, tspec, tst = _pile()
    _, sysc, _ = _jax_system(FrictionModel.BOX)
    Minv = jax.vmap(lambda s: jscene.inv_mass_blocks(spec, s))(jst)
    rng = np.random.default_rng(5)
    B, L = sysc.b0.shape
    # the step's rhs, -erp/dt^2 err - J (u/dt + M^-1 F)
    cfg = PILE_CFG

    def step_rhs(st, sc, M):
        F = jscene.external_forces(spec, st, cfg.gravity)
        u = jscene.pack_velocity(st) / cfg.dt + jnp.einsum("nij,nj->ni", M, F)
        return -cfg.erp / cfg.dt / cfg.dt * sc.err - jmf.j_v(sc.blocks, sc.b0, sc.b1, u)
    rhs = jax.vmap(step_rhs)(jst, sysc, Minv)
    x = jnp.asarray(rng.normal(size=(B, 3 * L)))
    v = jnp.asarray(rng.normal(size=(B, spec.num_bodies, 6)))
    t = {k: torch.as_tensor(np.array(getattr(sysc, k))) for k in sysc._fields}
    tt = lambda a: torch.as_tensor(np.array(a))
    return sysc, Minv, rhs, x, v, t, tt(Minv), tt(rhs), tt(x), tt(v)


@pytest.mark.parametrize("mode", ["segment", "onehot", "sorted"])
def test_matvec_pieces_match_jax(mode):
    sysc, Minv, rhs, x, v, t, tMinv, trhs, tx, tv = _lcp()
    n = Minv.shape[1]
    args = (sysc.blocks, sysc.b0, sysc.b1)
    targs = (t["blocks"], t["b0"], t["b1"])
    _close(tmf.jt_x(*targs, tx, n, mode), jax.vmap(lambda *a: jmf.jt_x(*a, n))(*args, x))
    _close(tmf.j_v(*targs, tv), jax.vmap(jmf.j_v)(*args, v))
    _close(tmf.jmjt_matvec(*targs, tMinv, tx, 0.01, mode),
           jax.vmap(lambda *a: jmf.jmjt_matvec(*a, 0.01))(*args, Minv, x))
    _close(tmf.jmjt_diagonal(*targs, tMinv, 0.01),
           jax.vmap(lambda *a: jmf.jmjt_diagonal(*a, 0.01))(*args, Minv))


@pytest.mark.parametrize("mode", ["segment", "onehot", "sorted", "auto"])
def test_solve_lcp_matrix_free_matches_jax(mode):
    sysc, Minv, rhs, _, _, t, tMinv, trhs, _, _ = _lcp()
    jmode = "onehot" if mode == "onehot" else "segment"
    want = jax.jit(jax.vmap(lambda b, b0, b1, M, r, e, lo, hi: jmf.solve_lcp_matrix_free(
        b, b0, b1, M, r, e, lo, hi, iters=30, omega=0.3, beta=0.45, cfm=0.01,
        matvec_mode=jmode)))(sysc.blocks, sysc.b0, sysc.b1, Minv, rhs, sysc.is_eq, sysc.lo,
                             sysc.hi)
    got = tmf.solve_lcp_matrix_free(t["blocks"], t["b0"], t["b1"], tMinv, trhs, t["is_eq"],
                                    t["lo"], t["hi"], iters=30, omega=0.3, beta=0.45, cfm=0.01,
                                    matvec_mode=mode)
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 1.0
    _close(got, want, TOL * scale)
    with pytest.raises(ValueError, match="matvec_mode"):
        tmf.BodyIncidence(t["b0"], t["b1"], 27, "scatter")


@functools.lru_cache(maxsize=None)
def _jax_pile_steps(ext: bool, steps: int):
    spec, st = js.box_pile(27, dtype=jnp.float64)
    B = 3
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    states = states._replace(
        p=states.p + 1e-3 * jax.random.normal(jax.random.PRNGKey(0), states.p.shape))
    # drop the pile 2 cm into itself so the first steps have box-box contacts
    states = states._replace(p=states.p * jnp.asarray([0.86, 0.86, 0.9]))
    ext_f = None
    if ext:
        ext_f = jnp.asarray(np.random.default_rng(2).normal(size=(B, spec.num_bodies, 6)))
    jcfg = _jax_cfg(PILE_CFG)
    run = jax.jit(lambda s: jax.lax.fori_loop(
        0, steps, lambda _, x: jstep.step_ode_batched(spec, x, jcfg, ext_f), s))
    return spec, states, ext_f, run(states)


@pytest.mark.parametrize("ext", [False, True])
def test_step_ode_batched_matrix_free_matches_jax(ext):
    steps = 4
    spec, states, ext_f, want = _jax_pile_steps(ext, steps)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tst = convert.state_from_numpy(_np(states), device="cpu", dtype=torch.float64)
    text = None if ext_f is None else torch.as_tensor(np.array(ext_f))
    got = tst
    for _ in range(steps):
        got = step_ode_batched(tspec, got, PILE_CFG, text)
    for k in "pvqw":
        _close(getattr(got, k), getattr(want, k), 1e-8, k)
    cs = tcont.make_contacts_batched(tspec, tst, PILE_CFG)
    assert int(cs.active.sum(1).min()) > 50
    # box-box lanes, and the broadphase cuts the 351 pairs to 128 lanes
    assert bool((cs.b0[cs.active] >= 0).any())
    if not ext:
        # the rollout's loop is the same steps; one scene alone is the batch's row
        loop = rollout_batched(tspec, tst, PILE_CFG, steps)
        assert all(torch.equal(a, b) for a, b in zip(loop, got))
        one = State(*(x[1] for x in tst))
        for _ in range(steps):
            one, one_cs = step_ode(tspec, one, PILE_CFG)
        for k in "pvqw":
            _close(getattr(one, k), getattr(want, k)[1], 1e-8, k)
        assert one_cs.active.shape == (256,)
