"""Port parity: the packed narrowphase, the compaction kernel, the
joint-contact dedupe and the streamed Jacobi of the all-kernel fused chain,
their plain versions against the JAX package, float64 on the CPU.

- B2p, the packed narrowphase: `collide_boxes_lanes_packed_plain` against
  `jax.vmap(collision.collide_boxes)` on the gathered pairs of jittered
  `box_stack(4)` scenarios (R from q by the JAX package's `quat_to_mat`),
  within 1e-12 and flags exact.
- B3, the compaction and dedupe with pairs: `compact_contacts_plain` on
  B2p's lanes against the JAX package's XLA contact path,
  `make_contacts_batched(use_kernel=False)` with `effective_depth`, at
  B=1024 `box_stack(4)`: K=20, an overflow (K=6), a dedupe with
  min_constraint_distance raised to 0.35 (the corners of a face are 0.3
  apart), and a finite depth cap.  The
  XLA path is the reference here because the interpret-mode compile of the
  JAX compaction kernel with pairs takes about 85 s cold;
  tests/test_compact_kernel.py pins that kernel to the same XLA path.  Ids
  and active flags exact, geometry within 1e-6.
- B3g, the ground-only variant: `compact_contacts_plain` against the JAX
  package's Pallas kernel `compact_contacts_packed` (Pk=0) in interpret
  mode at B=1024 `box_drop`, K=8, with and without a depth cap.  Ids and
  flags exact, geometry within 1e-6.
- B6b: `solve_lcp_jacobi_packed_plain` against the JAX package's streamed
  Pallas solve (`stream=True`) in interpret mode at K=24 (mp=72), within
  1e-9 as the resident solve's test; the port's stream switch and its
  refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.ops import collision as jcollision
from eggshell_tpu.ops import compact_kernel as jck
from eggshell_tpu.ops import quaternion as jquat
from eggshell_tpu.ops.jassembly_kernel import TILE, _pack
from eggshell_tpu.ops.pgs_kernel import solve_lcp_jacobi_packed as jax_jacobi_packed
from eggshell_tpu.physics import contacts as jcont
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.ops.amat_kernel import padded_rows
from eggshell_tpu_torch.ops.collision_kernel import (collide_boxes_lanes_packed,
                                                    collide_boxes_lanes_packed_plain)
from eggshell_tpu_torch.ops.compact_kernel import compact_contacts, compact_contacts_plain
from eggshell_tpu_torch.ops.pgs_kernel import (solve_lcp_jacobi_packed,
                                               solve_lcp_jacobi_packed_plain,
                                               solve_lcp_jacobi_packed_stream, streams_a)
from eggshell_tpu_torch.physics import stepper as tstep
from eggshell_tpu_torch.physics.contacts import depth_cap
from eggshell_tpu_torch.utils.config import BENCH
from torch_limits import time_limit  # noqa: F401

B = 1024
GEOM_TOL = 1e-6


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _jittered(spec_state, seed, eps=2e-3, B=B):
    """B copies of a JAX scene with every coordinate of p moved by eps N(0, 1)."""
    spec, st = spec_state
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    noise = np.random.default_rng(seed).normal(size=states.p.shape)
    return spec, states._replace(p=states.p + eps * jnp.asarray(noise))


def _torch(spec, states):
    return (convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64),
            convert.state_from_numpy(_np(states), device="cpu", dtype=torch.float64))


def _assert_lanes_equal(got, want_b0, want_b1, want_pos, want_nrm, want_dep, want_act):
    np.testing.assert_array_equal(got.active.numpy(), want_act)
    np.testing.assert_array_equal(got.b0.numpy(), want_b0)
    np.testing.assert_array_equal(got.b1.numpy(), want_b1)
    np.testing.assert_allclose(got.position.numpy(), want_pos, rtol=0, atol=GEOM_TOL)
    np.testing.assert_allclose(got.normal.numpy(), want_nrm, rtol=0, atol=GEOM_TOL)
    np.testing.assert_allclose(got.depth.numpy(), want_dep, rtol=0, atol=GEOM_TOL)


def test_packed_narrowphase_plain_matches_jax():
    spec, states = _jittered(js.box_stack(4), seed=0, B=64)
    pi, pj = spec.pair_i, spec.pair_j
    R = jquat.quat_to_mat(states.q)
    P = pi.shape[0]

    def flat(x):
        return x.reshape((-1,) + x.shape[2:])

    want = jax.vmap(jcollision.collide_boxes)(
        flat(states.p[:, pi]), flat(R[:, pi]), flat(jnp.broadcast_to(spec.half_extents[pi],
                                                                     (64, P, 3))),
        flat(states.p[:, pj]), flat(R[:, pj]), flat(jnp.broadcast_to(spec.half_extents[pj],
                                                                     (64, P, 3))))
    tspec, tst = _torch(spec, states)
    pos, nrm, dep, act = collide_boxes_lanes_packed_plain(tst.p, tst.q, tspec.half_extents,
                                                          tspec.pair_i, tspec.pair_j)
    np.testing.assert_array_equal(act.numpy().reshape(64 * P, -1), np.asarray(want.active))
    assert act.any()
    np.testing.assert_allclose(pos.numpy().reshape(64 * P, -1, 3), np.asarray(want.position),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(dep.numpy().reshape(64 * P, -1), np.asarray(want.depth),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(nrm.numpy().reshape(64 * P, 3), np.asarray(want.normal)[:, 0],
                               rtol=0, atol=1e-12)


COMPACT_CASES = {
    # name: (contact capacity, min_constraint_distance, max_correcting_vel)
    "k20": (20, 1e-6, float("inf")),
    "overflow_k6": (6, 1e-6, float("inf")),
    "dedupe_0.35": (20, 0.35, float("inf")),
    "depth_cap": (20, 1e-6, 0.01),
}


@functools.lru_cache(maxsize=None)
def _jax_contacts(name):
    K, mcd, mcv = COMPACT_CASES[name]
    spec, states = _jittered(js.box_stack(4), seed=1)
    cfg = JaxSimConfig.from_json(BENCH.to_json()).replace(
        contact_capacity=K, min_constraint_distance=mcd, max_correcting_vel=mcv)
    cs = jcont.make_contacts_batched(spec, states, cfg, use_kernel=False)
    return spec, states, cs._replace(depth=jcont.effective_depth(cs.depth, cfg))


@pytest.mark.parametrize("name", sorted(COMPACT_CASES))
def test_compact_plain_matches_jax_contacts(name):
    spec, states, want = _jax_contacts(name)
    K, mcd, mcv = COMPACT_CASES[name]
    tspec, tst = _torch(spec, states)
    cfg = BENCH.replace(contact_capacity=K, min_constraint_distance=mcd, max_correcting_vel=mcv)
    pair = collide_boxes_lanes_packed_plain(tst.p, tst.q, tspec.half_extents, tspec.pair_i,
                                            tspec.pair_j)
    got = compact_contacts_plain(tst.p, tst.q, tspec.half_extents, tspec.ground_enabled, pair,
                                 tspec.pair_i, tspec.pair_j, K, mcd ** 2, depth_cap(cfg))
    w = _np(want)
    _assert_lanes_equal(got, w["b0"], w["b1"], w["position"], w["normal"], w["depth"],
                        w["active"])
    act, filled = got.active.numpy(), got.b1.numpy() >= 0
    if name == "overflow_k6":
        assert filled.all(1).mean() > 0.5        # more active candidates than lanes
    if name == "dedupe_0.35":
        assert (filled & ~act).sum() > B         # lanes dropped with their ids kept
    if name == "depth_cap":
        cap = depth_cap(cfg)
        assert np.isclose(got.depth.numpy()[act].max(), cap)


def _unpack(x, c):
    return np.asarray(x).transpose(0, 2, 3, 1).reshape(-1, c)[:B]


@functools.lru_cache(maxsize=None)
def _jax_ground_kernel(cap):
    spec, states = _jittered(js.box_drop(height=0.1495), seed=2)
    n, K = 1, 8
    pt, _, _, nt = _pack(states.p, 3 * n)
    qt, _, _, _ = _pack(states.q, 4 * n)
    hst, _, _, _ = _pack(jnp.broadcast_to(spec.half_extents.reshape(1, 3 * n), (B, 3 * n)), 3 * n)
    gent, _, _, _ = _pack(jnp.broadcast_to(spec.ground_enabled.astype(jnp.float64).reshape(1, n),
                                           (B, n)), n)
    out = jck.compact_contacts_packed(pt, qt, hst, gent, None, None, None, None, None, None,
                                      K=K, n=n, Pk=0, nt=nt, eps2=1e-12, depth_cap=cap,
                                      interpret=True)
    b0, b1, pos, nrm, dep, act = (_unpack(x, c) for x, c in zip(out, (K, K, 3 * K, 3 * K, K, K)))
    return spec, states, (b0.astype(np.int64), b1.astype(np.int64), pos.reshape(B, K, 3),
                          nrm.reshape(B, K, 3), dep, act > 0.5)


@pytest.mark.parametrize("cap", [None, 2e-4], ids=["no_cap", "cap"])
def test_ground_compact_plain_matches_pallas_kernel(cap):
    assert B % TILE == 0
    spec, states, want = _jax_ground_kernel(cap)
    tspec, tst = _torch(spec, states)
    got = compact_contacts_plain(tst.p, tst.q, tspec.half_extents, tspec.ground_enabled, None,
                                 tspec.pair_i, tspec.pair_j, 8, 1e-12, cap)
    _assert_lanes_equal(got, *want)
    assert 0 < got.active.sum() < B * 8


K_STREAM = 24


def _lcp_inputs(seed, nb=4):
    rng = np.random.default_rng(seed)
    mp = padded_rows(K_STREAM)
    G = rng.normal(size=(nb, mp, 12))
    A = G @ G.transpose(0, 2, 1) / 12 + 0.5 * np.eye(mp)
    diag = np.diagonal(A, axis1=1, axis2=2).copy()
    rhs = rng.normal(size=(nb, 3 * K_STREAM))
    act = rng.uniform(size=(nb, K_STREAM)) < 0.8
    eq = rng.uniform(size=(nb, K_STREAM)) < 0.15
    return A, diag, rhs, act, eq


def _pack_np(x):
    x = np.asarray(x)
    return _pack(jnp.asarray(x.reshape(x.shape[0], -1)), int(np.prod(x.shape[1:])))[0]


@functools.lru_cache(maxsize=None)
def _jax_stream():
    A, diag, rhs, act, eq = _lcp_inputs(5)
    mp = padded_rows(K_STREAM)

    def stripes(x):
        return jnp.transpose(_pack_np(x), (0, 2, 1, 3))

    x = jax_jacobi_packed(stripes(A), _pack_np(rhs), _pack_np(act.astype(np.float64)),
                          K=K_STREAM, mu=1.0, iters=16, omega=0.3, beta=0.45, interpret=True,
                          eq_packed=_pack_np(eq.astype(np.float64)), stream=True,
                          diag_packed=stripes(diag))
    return np.asarray(x).transpose(0, 2, 3, 1).reshape(-1, mp)[:A.shape[0]]


def test_streamed_jacobi_plain_matches_pallas_kernel():
    A, diag, rhs, act, eq = _lcp_inputs(5)
    args = [torch.tensor(x) for x in (A, diag, rhs, act, eq)]
    got = solve_lcp_jacobi_packed_plain(*args, K_STREAM, 1.0, 16, 0.3, 0.45).numpy()
    np.testing.assert_allclose(got, _jax_stream(), rtol=0, atol=1e-9)
    x = got[:, :3 * K_STREAM].reshape(-1, K_STREAM, 3)
    box = act & ~eq
    assert (np.abs(x[box][:, :2]) <= 1.0).all() and (x[box][:, 2] >= 0).all()


def test_stream_switch_follows_the_jax_rule():
    """The JAX package streams from mp >= 72 (K >= 22 lanes), and there the
    port refuses block and pyramid as the JAX package does; the port takes
    the cluster B6b only past the crossing measured on the card (K = 32,
    mp = 96, stays on B6; K = 64, mp = 192, does not).  The dispatch on the
    CPU runs the plain version either way."""
    assert not streams_a(padded_rows(21)) and streams_a(padded_rows(22))
    assert tstep.jacobi_phase(20) == "jacobi_packed" and tstep.jacobi_phase(32) == \
        "jacobi_packed" and tstep.jacobi_phase(64) == "jacobi_packed_stream"
    A, diag, rhs, act, eq = (torch.tensor(x) for x in _lcp_inputs(6))
    want = solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K_STREAM, 1.0, 4, 0.3, 0.45)
    for stream in (None, True, False):
        got = solve_lcp_jacobi_packed(A, diag, rhs, act, eq, K_STREAM, 1.0, 4, 0.3, 0.45,
                                      stream=stream)
        assert torch.equal(got, want)
    for kw in (dict(block=True), dict(pyramid_mu=0.5)):
        with pytest.raises(ValueError, match="streamed-A path"):
            solve_lcp_jacobi_packed(A, diag, rhs, act, eq, K_STREAM, 1.0, 4, 0.3, 0.45, **kw)


def test_new_wrappers_take_plain_versions_on_cpu():
    spec, states = _torch(*_jittered(js.box_stack(3), seed=4, B=4))
    wrappers = (collide_boxes_lanes_packed, compact_contacts, solve_lcp_jacobi_packed_stream)
    before = [f.launches for f in wrappers]
    pair = collide_boxes_lanes_packed(states.p, states.q, spec.half_extents, spec.pair_i,
                                      spec.pair_j)
    want = collide_boxes_lanes_packed_plain(states.p, states.q, spec.half_extents, spec.pair_i,
                                            spec.pair_j)
    assert all(torch.equal(g, w) for g, w in zip(pair, want))
    args = (states.p, states.q, spec.half_extents, spec.ground_enabled, pair, spec.pair_i,
            spec.pair_j, 12, 1e-12, None)
    assert all(torch.equal(g, w) for g, w in zip(compact_contacts(*args),
                                                  compact_contacts_plain(*args)))
    A, diag, rhs, act, eq = (torch.tensor(x) for x in _lcp_inputs(7))
    assert torch.equal(solve_lcp_jacobi_packed_stream(A, diag, rhs, act, eq, K_STREAM, 1.0, 4,
                                                      0.3, 0.45),
                       solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K_STREAM, 1.0, 4,
                                                     0.3, 0.45))
    assert [f.launches for f in wrappers] == before
