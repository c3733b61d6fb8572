"""Port parity: the fused chain of `eggshell_tpu_torch` against the JAX
package.

- Each kernel's plain version against the JAX package's Pallas kernel run
  in interpret mode, at small K and n, float64: B1 `prep_packed` (with and
  without external forces), B4 `contact_jacobian_blocks` (normals +z, -z
  and generic; equality, ground and inactive lanes), B5
  `contact_system_matrix_packed` (A and diag; at K = 2, and at K = 3,
  whose 16 rows put lane and padding rows in every kind of slab), B6
  `solve_lcp_jacobi_packed` (equality and inactive lanes; its block and
  pyramid forms are held in tests/test_torch_lcp_solvers.py) and B7
  `integrate_step` (a body below the small-angle threshold).  The JAX kernels' packed (8, 128) tile layout is
  unpacked here.  Tolerance 1e-12 for the straight-line kernels, whose
  expressions are the same and only the rounding of XLA's CPU code can
  differ; 1e-9 for 16 Jacobi sweeps, as tests/test_torch_lcp.py.
- The slice: 30 steps of the port's fused `rollout_batched` under the bench
  configuration against 30 steps of the JAX package's XLA twin of the fused
  step (`_step_xla_twin`: the same math, XLA only), B=8 `box_stack(4)`,
  float64, within 1e-8.
- The f32 oracle gate of bench.py under the bench configuration on the CPU.
- The builders of `physics/scenes.py` default to the card.
- The fused step's phases, seen through its hook: the packed narrowphase,
  the compaction kernel, then the five kernels of the solve.
"""

import functools
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.ops.amat_kernel import contact_system_matrix_packed
from eggshell_tpu.ops.integrate_kernel import integrate_step as jax_integrate_step
from eggshell_tpu.ops.jassembly_kernel import TILE, _pack
from eggshell_tpu.ops.jassembly_kernel import contact_jacobian_blocks as jax_jacobian_blocks
from eggshell_tpu.ops.pgs_kernel import solve_lcp_jacobi_packed as jax_jacobi_packed
from eggshell_tpu.ops.prep_kernel import prep_packed
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.ops.amat_kernel import (contact_system_matrix,
                                                contact_system_matrix_plain, padded_rows)
from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes_packed
from eggshell_tpu_torch.ops.compact_kernel import compact_contacts
from eggshell_tpu_torch.ops.integrate_kernel import integrate_step, integrate_step_plain
from eggshell_tpu_torch.ops.jassembly_kernel import (contact_jacobian_blocks,
                                                     contact_jacobian_blocks_plain)
from eggshell_tpu_torch.ops.pgs_kernel import (solve_lcp_jacobi_packed,
                                               solve_lcp_jacobi_packed_block,
                                               solve_lcp_jacobi_packed_plain,
                                               solve_lcp_jacobi_packed_pyramid,
                                               solve_lcp_jacobi_packed_stream)
from eggshell_tpu_torch.ops.prep_kernel import prep_bodies, prep_bodies_plain
from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics import scenes as ts
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.physics.stepper import _fused_step, step_ode_batched
from eggshell_tpu_torch.utils.config import BENCH
from torch_limits import time_limit  # noqa: F401

ORACLE = os.path.join(os.path.dirname(__file__), "data", "oracle_stack4_f64.npz")
TOL = 1e-12
TOL_SWEEPS = 1e-9

B, K, N = 4, 3, 2
K2 = 2
DT, ERP_DT2 = 1e-3, 0.2 / 1e-3 / 1e-3


def _unpack(x, B):
    """(nt, c, 8, 128) tile layout -> (B, c)."""
    nt, c = x.shape[:2]
    return np.asarray(x).transpose(0, 2, 3, 1).reshape(nt * TILE, c)[:B]


def _pack_np(x):
    """(B, ...) -> the (nt, c, 8, 128) tile layout."""
    x = np.asarray(x)
    return _pack(jnp.asarray(x.reshape(x.shape[0], -1)), int(np.prod(x.shape[1:])))[0]


def _stripes(x):
    """(B, c) -> the (nt, 8, c, 128) sublane-major layout of A and diag."""
    return jnp.transpose(_pack_np(x), (0, 2, 1, 3))


def _t(x):
    return torch.tensor(np.asarray(x))


def _bodies(seed):
    """Random per-body data; body 0 is static (inverse mass and inertia 0)
    and spins slowly enough to take the small-angle branch of B7."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(B, N, 3))
    w = rng.normal(size=(B, N, 3))
    w[:, 0] = 1e-4 * rng.normal(size=(B, 3))
    G = rng.normal(size=(N, 3, 3))
    Ib = G @ G.transpose(0, 2, 1) + np.eye(3)
    invIb = np.linalg.inv(Ib)
    inv_mass = rng.uniform(0.5, 2.0, N)
    inv_mass[0] = 0.0
    invIb[0] = 0.0
    p = rng.normal(size=(B, N, 3))
    return dict(q=q, v=v, w=w, Ib=Ib, invIb=invIb, inv_mass=inv_mass, p=p)


def _lanes(seed):
    """K = 3 lanes in each of the B = 4 scenarios, covering the cases of the
    J-assembly kernel: lane 0 has n = +z and is an equality lane in odd
    scenarios; lane 1 has n = -z and is a ground lane (b0 = -1) in odd
    scenarios; lane 2 has a generic n and is, by scenario, a ground lane, an
    inactive lane with its bodies set, an idle lane (b0 = b1 = -1) and a
    contact between two bodies."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(B, K, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:, 0] = [0.0, 0.0, 1.0]
    nrm[:, 1] = [0.0, 0.0, -1.0]
    b0 = rng.integers(0, N, size=(B, K))
    b1 = (b0 + rng.integers(1, N, size=(B, K))) % N
    odd = np.arange(B) % 2 == 1
    b0[odd, 1] = -1
    b0[0, 2] = -1
    b0[2, 2] = b1[2, 2] = -1
    act = np.ones((B, K), bool)
    act[1:3, 2] = False
    eq = np.zeros((B, K), bool)
    eq[odd, 0] = True
    pos = rng.normal(size=(B, K, 3))
    pos1 = pos + 0.05 * rng.normal(size=(B, K, 3))
    dep = rng.uniform(0.0, 0.01, (B, K))
    return dict(b0=b0, b1=b1, nrm=nrm, act=act, eq=eq, pos=pos, pos1=pos1, dep=dep)


@functools.lru_cache(maxsize=None)
def _jax_prep(with_ext):
    d = _bodies(0)
    ext = np.random.default_rng(7).normal(size=(B, N, 6)) if with_ext else None
    uhat, invig, f = prep_packed(
        *[jnp.asarray(d[k]) for k in ("q", "v", "w", "inv_mass", "Ib", "invIb")],
        dt=DT, gravity=(0.0, 0.0, -9.8), interpret=True,
        ext_forces=None if ext is None else jnp.asarray(ext))
    return ext, _unpack(uhat, B), _unpack(invig, B), _unpack(f, B)


@pytest.mark.parametrize("with_ext", [False, True], ids=["gravity", "ext_forces"])
def test_prep_plain_matches_pallas_kernel(with_ext):
    d = _bodies(0)
    ext, uhat, invig, f = _jax_prep(with_ext)
    got = prep_bodies_plain(*[_t(d[k]) for k in ("q", "v", "w", "inv_mass", "Ib", "invIb")],
                            DT, (0.0, 0.0, -9.8), None if ext is None else _t(ext))
    for g, want in zip(got, (uhat, invig, f)):
        np.testing.assert_allclose(g.reshape(B, -1).numpy(), want, rtol=TOL, atol=TOL)


@functools.lru_cache(maxsize=None)
def _jax_jacobian_blocks():
    d, c = _bodies(1), _lanes(2)
    uhat = np.random.default_rng(3).normal(size=(B, N, 6))
    Jc, rhs = jax_jacobian_blocks(
        jnp.asarray(c["b0"]), jnp.asarray(c["b1"]), jnp.asarray(c["pos"]),
        jnp.asarray(c["nrm"]), jnp.asarray(c["dep"]), jnp.asarray(c["act"]),
        jnp.asarray(d["p"]), jnp.asarray(uhat), erp_dt2=ERP_DT2, interpret=True,
        position1=jnp.asarray(c["pos1"]), is_eq=jnp.asarray(c["eq"]))
    return uhat, np.asarray(Jc), np.asarray(rhs)


def test_jacobian_blocks_plain_matches_pallas_kernel():
    d, c = _bodies(1), _lanes(2)
    uhat, Jc_want, rhs_want = _jax_jacobian_blocks()
    Jc, rhs = contact_jacobian_blocks_plain(
        *[_t(c[k]) for k in ("b0", "b1", "pos", "pos1", "nrm", "dep", "act", "eq")],
        _t(d["p"]), _t(uhat), ERP_DT2)
    np.testing.assert_allclose(Jc.numpy(), Jc_want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rhs.numpy(), rhs_want, rtol=TOL, atol=TOL * ERP_DT2)
    J = Jc.numpy().reshape(B, K, 3, 12)
    # n = -z: the antiparallel fallback turns 180 degrees about n x e_x
    # (e_x: least |n_i|, the tie between x and y goes to x), i.e. about y
    np.testing.assert_array_equal(J[:, 1, :, 6:9], np.broadcast_to(np.diag([-1.0, 1.0, -1.0]),
                                                                   (B, 3, 3)))
    assert not J[1::2, 1, :, :6].any() and not J[0, 2, :, :6].any()      # ground slots
    assert not J[1:3, 2].any()                                           # inactive lanes


def _matrix_inputs(seed):
    """Bodies, lanes 1 and 2 of `_lanes` (K2 = 2 lanes: body and ground
    contacts, inactive and idle lanes), their Jc and invIg: the inputs of
    the A and integrate kernels, kept small for their interpret-mode
    compiles."""
    d, c = _bodies(seed), _lanes(seed + 1)
    Jc, _ = contact_jacobian_blocks_plain(
        *[_t(c[k]) for k in ("b0", "b1", "pos", "pos1", "nrm", "dep", "act", "eq")],
        _t(d["p"]), torch.zeros(B, N, 6, dtype=torch.float64), ERP_DT2)
    _, invig, _ = prep_bodies_plain(*[_t(d[k]) for k in ("q", "v", "w", "inv_mass", "Ib", "invIb")],
                                    DT, (0.0, 0.0, -9.8))
    c = {k: x[:, 1:3] for k, x in c.items()}
    return d, c, Jc.numpy()[:, 3:9], invig.numpy()


@functools.lru_cache(maxsize=None)
def _jax_system_matrix():
    d, c, Jc, invig = _matrix_inputs(4)
    A, diag = contact_system_matrix_packed(
        _pack_np(Jc), _pack_np(c["b0"].astype(np.float64)), _pack_np(c["b1"].astype(np.float64)),
        _pack_np(c["act"].astype(np.float64)),
        _pack_np(np.broadcast_to(d["inv_mass"], (B, N))), _pack_np(invig),
        K=K2, n=N, cfm=0.01, interpret=True)
    mp = padded_rows(K2)
    A = np.asarray(A).transpose(0, 1, 3, 2).reshape(-1, mp, mp)[:B]
    diag = np.asarray(diag).transpose(0, 1, 3, 2).reshape(-1, mp)[:B]
    return A, diag


def test_system_matrix_plain_matches_pallas_kernel():
    d, c, Jc, invig = _matrix_inputs(4)
    A_want, diag_want = _jax_system_matrix()
    A, diag = contact_system_matrix_plain(_t(Jc), _t(c["b0"]), _t(c["b1"]), _t(c["act"]),
                                          _t(d["inv_mass"]), _t(invig), K2, 0.01)
    np.testing.assert_allclose(A.numpy(), A_want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(diag.numpy(), diag_want, rtol=TOL, atol=TOL)
    # inactive and padding rows: unit diagonal, nothing else
    mp = padded_rows(K2)
    idle = np.concatenate([np.repeat(~c["act"], 3, axis=1), np.ones((B, mp - 6), bool)], 1)
    np.testing.assert_array_equal(A.numpy()[idle], np.eye(mp)[np.nonzero(idle)[1]])
    assert (np.abs(A.numpy()[:, :6, :6]) > 0).sum() > B * 6   # coupled active rows


@functools.lru_cache(maxsize=None)
def _padded_matrix_inputs(K_pad=3, seed=11):
    """Random Jc (B, 3K, 12) and lane bodies at K = 3 lanes, mp = 16: body,
    ground (b0 = -1), inactive and idle (b0 = b1 = -1) lanes."""
    rng = np.random.default_rng(seed)
    d = _bodies(seed)
    Jc = rng.normal(size=(B, 3 * K_pad, 12))
    b0 = rng.integers(-1, N, size=(B, K_pad))
    b1 = (np.maximum(b0, 0) + rng.integers(1, N, size=(B, K_pad))) % N
    act = rng.uniform(size=(B, K_pad)) < 0.8
    act[0, 0] = False
    b0[1, 2] = b1[1, 2] = -1
    act[1, 2] = False
    invig = d["invIb"][None] + 0.1 * rng.normal(size=(B, N, 3, 3))
    return d, Jc, b0, b1, act, invig


def test_system_matrix_plain_matches_pallas_kernel_with_padding_slabs():
    """K = 3: mp = 16 rows for 9 lane rows, so the Pallas kernel's 4-row
    slabs hold lane rows only, lane and padding rows, and padding rows only
    (the interpret-mode call costs about 6 s a lane on the CPU)."""
    d, Jc, b0, b1, act, invig = _padded_matrix_inputs()
    K_pad = b0.shape[1]
    mp = padded_rows(K_pad)
    assert mp == 16 != 3 * K_pad
    A_want, diag_want = contact_system_matrix_packed(
        _pack_np(Jc), _pack_np(b0.astype(np.float64)), _pack_np(b1.astype(np.float64)),
        _pack_np(act.astype(np.float64)), _pack_np(np.broadcast_to(d["inv_mass"], (B, N))),
        _pack_np(invig), K=K_pad, n=N, cfm=0.01, interpret=True)
    A_want = np.asarray(A_want).transpose(0, 1, 3, 2).reshape(-1, mp, mp)[:B]
    diag_want = np.asarray(diag_want).transpose(0, 1, 3, 2).reshape(-1, mp)[:B]
    A, diag = contact_system_matrix_plain(_t(Jc), _t(b0), _t(b1), _t(act), _t(d["inv_mass"]),
                                          _t(invig), K_pad, 0.01)
    np.testing.assert_allclose(A.numpy(), A_want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(diag.numpy(), diag_want, rtol=TOL, atol=TOL)
    eye = np.eye(mp)[3 * K_pad:]
    np.testing.assert_array_equal(A.numpy()[:, 3 * K_pad:], np.broadcast_to(eye, (B, *eye.shape)))
    assert (np.abs(A.numpy()[:, :9, :9]) > 0).sum() > B * 9   # coupled lane rows


def _lcp_inputs(seed):
    rng = np.random.default_rng(seed)
    mp = padded_rows(K)
    G = rng.normal(size=(B, mp, 12))
    A = G @ G.transpose(0, 2, 1) / 12 + 0.5 * np.eye(mp)
    diag = np.diagonal(A, axis1=1, axis2=2).copy()
    rhs = rng.normal(size=(B, 3 * K))
    c = _lanes(seed + 1)
    return A, diag, rhs, c["act"], c["eq"]


@functools.lru_cache(maxsize=None)
def _jax_jacobi_packed():
    A, diag, rhs, act, eq = _lcp_inputs(5)
    mp = padded_rows(K)
    x = jax_jacobi_packed(
        _stripes(A), _pack_np(rhs), _pack_np(act.astype(np.float64)), K=K, mu=1.0,
        iters=16, omega=0.3, beta=0.45, interpret=True,
        eq_packed=_pack_np(eq.astype(np.float64)), diag_packed=_stripes(diag))
    return np.asarray(x).transpose(0, 2, 3, 1).reshape(-1, mp)[:B]


def test_jacobi_packed_plain_matches_pallas_kernel():
    A, diag, rhs, act, eq = _lcp_inputs(5)
    want = _jax_jacobi_packed()
    got = solve_lcp_jacobi_packed_plain(_t(A), _t(diag), _t(rhs), _t(act), _t(eq), K, 1.0,
                                        16, 0.3, 0.45).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SWEEPS)
    x = got[:, :3 * K].reshape(B, K, 3)
    box = act & ~eq
    assert (np.abs(x[box][:, :2]) <= 1.0).all() and (x[box][:, 2] >= 0).all()


def test_jacobi_packed_wrappers_take_block_and_pyramid_plain_on_cpu():
    """On CPU tensors the resident B6 wrappers run the plain version of the
    block, pyramid and block + pyramid forms and count no launch; the
    streamed path refuses both, as the JAX package's does."""
    A, diag, rhs, act, eq = (_t(x) for x in _lcp_inputs(5))
    lcp = (A, diag, rhs, act, eq, K, 1.0, 4, 0.3, 0.45)
    counters = (solve_lcp_jacobi_packed, solve_lcp_jacobi_packed_block,
                solve_lcp_jacobi_packed_pyramid)
    before = [f.launches for f in counters]
    for block, pyramid_mu in ((True, 0.0), (False, 0.5), (True, 0.5)):
        want = solve_lcp_jacobi_packed_plain(*lcp, block, pyramid_mu)
        assert torch.equal(solve_lcp_jacobi_packed(*lcp, block=block, pyramid_mu=pyramid_mu), want)
        assert not torch.equal(want, solve_lcp_jacobi_packed_plain(*lcp))
    assert torch.equal(solve_lcp_jacobi_packed_block(*lcp, pyramid_mu=0.5),
                       solve_lcp_jacobi_packed_plain(*lcp, True, 0.5))
    assert torch.equal(solve_lcp_jacobi_packed_pyramid(*lcp, 0.5),
                       solve_lcp_jacobi_packed_plain(*lcp, False, 0.5))
    assert [f.launches for f in counters] == before
    for kw in (dict(block=True), dict(pyramid_mu=0.5)):
        with pytest.raises(ValueError, match="streamed-A path"):
            solve_lcp_jacobi_packed(*lcp, stream=True, **kw)


def _integrate_inputs(seed):
    d, c, Jc, invig = _matrix_inputs(seed)
    rng = np.random.default_rng(seed + 2)
    lam = rng.normal(size=(B, padded_rows(K2)))
    F = rng.normal(size=(B, N, 6))
    return d, c, Jc, invig, lam, F


@functools.lru_cache(maxsize=None)
def _jax_integrate():
    d, c, Jc, invig, lam, F = _integrate_inputs(8)
    Minv = np.zeros((B, N, 6, 6))
    Minv[:, :, :3, :3] = d["inv_mass"][None, :, None, None] * np.eye(3)
    Minv[:, :, 3:, 3:] = invig
    out = jax_integrate_step(
        jnp.asarray(Jc), jnp.asarray(lam[:, :3 * K2]), jnp.asarray(c["b0"]), jnp.asarray(c["b1"]),
        jnp.asarray(d["p"]), jnp.asarray(d["q"]), jnp.asarray(d["v"]), jnp.asarray(d["w"]),
        jnp.asarray(Minv), jnp.asarray(F), dt=DT, interpret=True)
    return [np.asarray(x) for x in out]


def test_integrate_plain_matches_pallas_kernel():
    d, c, Jc, invig, lam, F = _integrate_inputs(8)
    want = _jax_integrate()
    got = integrate_step_plain(_t(Jc), _t(lam), _t(c["b0"]), _t(c["b1"]), _t(d["p"]),
                               _t(d["q"]), _t(d["v"]), _t(d["w"]), _t(d["inv_mass"]),
                               _t(invig), _t(F), DT)
    for name, g, wnt in zip("pqvw", got, want):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=TOL, atol=TOL, err_msg=name)
    # body 0 spins below the small-angle threshold: |w dt|^2 < 1e-12
    assert (np.sum((d["w"][:, 0] * DT) ** 2, -1) < 1e-12).all()


def test_wrappers_take_plain_versions_on_cpu():
    d, c, Jc, invig, lam, F = _integrate_inputs(8)
    wrappers = (collide_boxes_lanes_packed, compact_contacts, prep_bodies,
                contact_jacobian_blocks, contact_system_matrix, solve_lcp_jacobi_packed,
                solve_lcp_jacobi_packed_stream, integrate_step)
    before = [f.launches for f in wrappers]
    got = integrate_step(_t(Jc), _t(lam), _t(c["b0"]), _t(c["b1"]), _t(d["p"]), _t(d["q"]),
                         _t(d["v"]), _t(d["w"]), _t(d["inv_mass"]), _t(invig), _t(F), DT)
    want = integrate_step_plain(_t(Jc), _t(lam), _t(c["b0"]), _t(c["b1"]), _t(d["p"]),
                                _t(d["q"]), _t(d["v"]), _t(d["w"]), _t(d["inv_mass"]),
                                _t(invig), _t(F), DT)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    spec, st = ts.box_stack(2, device="cpu", dtype=torch.float64)
    rollout_batched(spec, State(*[x[None] for x in st]), BENCH, 1)
    assert [f.launches for f in wrappers] == before


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@functools.lru_cache(maxsize=None)
def _jax_twin_rollout(B, steps):
    spec, st = js.box_stack(4)
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    states = states._replace(p=states.p + jnp.linspace(0, 1e-3, B)[:, None, None])
    cfg = JaxSimConfig.from_json(BENCH.to_json()).replace(contact_kernel=False)

    @jax.jit
    def run(sts):
        def body(s, _):
            return jstep._step_xla_twin(spec, s, cfg, None), None
        return jax.lax.scan(body, sts, None, length=steps)[0]

    return spec, states, run(states)


def test_fused_slice_matches_jax_twin():
    spec, states, want = _jax_twin_rollout(8, 30)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tstates = convert.state_from_numpy(_np(states), device="cpu", dtype=torch.float64)
    got = rollout_batched(tspec, tstates, BENCH, 30)
    for field in ("p", "v", "q", "w"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-8, err_msg=field)
    # the stack settled without falling over (jitter lifts it by up to 1 mm)
    assert np.abs(got.p.numpy() - tstates.p.numpy()).max() < 2e-3


def test_fused_oracle_gate_f32():
    ref = np.load(ORACLE)
    spec, st = ts.box_stack(4, device="cpu", dtype=torch.float32)
    states = State(*[x.expand((8,) + x.shape).clone() for x in st])
    cfg = BENCH
    prev = 0
    for ck in [int(s) for s in ref["steps"]]:
        states = rollout_batched(spec, states, cfg, ck - prev)
        prev = ck
        assert states.p.dtype == torch.float32
        err_p = np.abs(states.p[0].double().numpy() - ref[f"p{ck}"]).max()
        err_v = np.abs(states.v[0].double().numpy() - ref[f"v{ck}"]).max()
        assert err_p < 1e-3 and err_v < 1e-3, (ck, err_p, err_v)


def test_fused_step_honours_ext_forces():
    """A constant upward push of m g on every body cancels gravity: the
    boxes of a stack in the air keep their velocity, on both branches."""
    spec, st = ts.box_stack(2, device="cpu", dtype=torch.float64)
    st = st._replace(p=st.p + torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64))
    states = State(*[x.expand((3,) + x.shape).clone() for x in st])
    push = torch.zeros(2, 6, dtype=torch.float64)
    push[:, 2] = 9.8
    for conditional in (False, True):
        cfg = BENCH.replace(conditional_cfm=conditional)
        free = step_ode_batched(spec, states, cfg)
        held = step_ode_batched(spec, states, cfg, ext_forces=push)
        held_b = step_ode_batched(spec, states, cfg, ext_forces=push.expand(3, 2, 6))
        assert float(free.v[..., 2].max()) < -9.7e-3
        assert float(held.v.abs().max()) < 1e-12
        assert torch.equal(held.p, held_b.p)


def test_scene_builders_default_to_the_card():
    for builder in (ts.cairn, ts.box_drop, ts.box_stack, ts.chain, ts.pendulum_chain,
                    ts.living_room):
        assert inspect.signature(builder).parameters["device"].default == "cuda"


def test_fused_step_runs_each_phase_through_its_hook():
    """`chip_smoke.py` and `profile_step` see the step's own kernel calls
    through `_fused_step`'s hook, and the hook does not change the step."""
    spec, st = ts.box_stack(2, device="cpu", dtype=torch.float64)
    states = State(*[x[None] for x in st])
    names = []

    def record(name, fn, args):
        names.append(name)
        return fn(*args)

    got = _fused_step(spec, states, BENCH, call=record)
    want = step_ode_batched(spec, states, BENCH)
    assert names == ["narrowphase", "compact", "prep", "jassembly", "amat", "jacobi_packed",
                     "integrate"]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
