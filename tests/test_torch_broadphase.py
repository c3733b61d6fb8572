"""Port parity: the broadphase (`eggshell_tpu_torch.ops.broadphase`), the
contacts that take its pairs, the gated pair lists of B2p and B3, and the
scene builders `box_pile` and `mjcf_boxes`, against the JAX package on
the CPU in float64.

- `pair_overlap_mask`, `select_pairs` / `select_scene_pairs` in both
  kinds, `sap_select_pairs` and `sweep_and_prune_pairs` on random boxes
  (n = 16 to 96, the scenes of `tests/test_broadphase_sap.py`, a leading
  batch of the seeds): masks, pairs and gates equal lane for lane, with
  capacities below and above the overlapping pairs;
- `make_contacts_batched` with the broadphase on a compressed, slightly
  turned `box_pile(27)`: at K = 256 (pairwise dedupe), at K = 384 (the
  windowed dedupe) and at K = 4096 without the broadphase (K * C > 2**23:
  the JAX package compacts with `top_k` there); ids and flags equal,
  geometry within 1e-9; `count_dropped_contacts` equal, with the contact
  and the pair capacity each too small once;
- the plain B2p and B3 on the broadphase's (B, Pc) pair lists and gate
  against the JAX package's contacts, the capacity above the overlapping
  pairs so that gated-off lanes (the self-pair (0, 0)) exist;
- the fused chain with the broadphase on living_room (B = 2, K = 16, pc =
  6, margin 0.1) against the JAX package's XLA step of the same
  configuration (SolverKind.JACOBI), 6 steps, within 1e-8;
- `box_pile` and `mjcf_boxes` (an XML the test writes) field for field.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.ops import broadphase as jbp
from eggshell_tpu.physics import contacts as jcont
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.physics.scene import State as JaxState
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.ops import broadphase as tbp
from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes_packed_plain
from eggshell_tpu_torch.ops.compact_kernel import compact_contacts_plain
from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics import contacts as tcont
from eggshell_tpu_torch.physics import scenes as ts
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils.config import BENCH, SimConfig
from torch_limits import time_limit  # noqa: F401


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _jax_cfg(cfg: SimConfig) -> JaxSimConfig:
    return JaxSimConfig.from_json(cfg.to_json())


def _random_boxes(n, seeds, spread=2.0):
    """p, q, h of `tests/test_broadphase_sap.py`'s random scene, one
    scenario a seed (h of the first seed for all)."""
    ps, qs, h = [], [], None
    for seed in seeds:
        rng = np.random.default_rng(seed)
        p = rng.uniform(-spread, spread, (n, 3))
        p[:, 2] += spread
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        hh = rng.uniform(0.1, 0.4, (n, 3))
        h = hh if h is None else h
        ps.append(p)
        qs.append(q)
    return np.stack(ps), np.stack(qs), h


def _jax_lanes(fn, *args):
    return [np.asarray(x) for x in jax.jit(jax.vmap(fn))(*args)]


@pytest.mark.parametrize("n", [16, 48, 96])
def test_pair_selection_matches_jax(n):
    p, q, h = _random_boxes(n, [0, 1, 2])
    pi, pj = map(jnp.asarray, np.triu_indices(n, k=1))
    P = len(pi)
    jh = jnp.asarray(h)
    tp, tq, th = _t(p), _t(q), _t(h)
    tpi, tpj = _t(pi, torch.int64), _t(pj, torch.int64)
    margin = 0.05
    want_mask = np.asarray(jax.jit(jax.vmap(
        lambda a, b: jbp.pair_overlap_mask(a, b, jh, pi, pj, margin)))(p, q))
    got_mask = tbp.pair_overlap_mask(tp, tq, th, tpi, tpj, margin)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    overlapping = int(want_mask.sum(1).max())
    assert overlapping > 0
    for cap in (max(1, overlapping // 2), overlapping + 7):
        want = _jax_lanes(lambda m: jbp.select_pairs(m, pi, pj, cap), want_mask)
        got = tbp.select_pairs(got_mask, tpi, tpj, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        # the sort-and-sweep strip, the window covering the scene
        want = _jax_lanes(lambda a, b: jbp.sap_select_pairs(a, b, jh, cap, n - 1, margin, P),
                          p, q)
        got = tbp.sap_select_pairs(tp, tq, th, cap, n - 1, margin, P)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    # a window too short for the scene drops pairs as the JAX package does
    cap = overlapping + 3
    want = _jax_lanes(lambda a, b: jbp.sap_select_pairs(a, b, jh, cap, 2, margin), p, q)
    got = tbp.sap_select_pairs(tp, tq, th, cap, 2, margin)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # every i < j pair, compacted without a host read
    lo, hi = tbp.box_aabbs(tp, tq, th, margin)
    jlo, jhi = jax.jit(jax.vmap(lambda a, b: jbp.box_aabbs(a, b, jh, margin)))(p, q)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=0, atol=1e-15)
    for cap in (max(1, overlapping // 2), overlapping + 5):
        want = _jax_lanes(lambda a, b: jbp.sweep_and_prune_pairs(a, b, cap), jlo, jhi)
        got = tbp.sweep_and_prune_pairs(lo, hi, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", ["mask", "sap"])
def test_select_scene_pairs_matches_jax(kind):
    spec, st = js.box_pile(27, spacing=0.97, dtype=jnp.float64)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    jstates, tstates = _pile_states(st, 3)
    cfg = SimConfig(pair_capacity=200, broadphase_margin=0.05, broadphase_kind=kind,
                    sap_window=8)
    want = _jax_lanes(lambda s: jbp.select_scene_pairs(spec, s, _jax_cfg(cfg)), jstates)
    got = tbp.select_scene_pairs(tspec, tstates, cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert 0 < int(got[2].sum(1).min()) and int(got[2].sum(1).max()) < 200
    # a pair list that is not the canonical one takes the mask
    rev = tspec._replace(pair_i=tspec.pair_i.flip(0).clone(), pair_j=tspec.pair_j.flip(0).clone())
    assert not tbp._canonical_pairs(rev) and tbp._canonical_pairs(tspec)


def _pile_states(st, B, seed=0):
    """B scenarios of a compressed box_pile, each box turned by up to
    about 0.05 rad and shifted by up to 2 mm (seeded), so that neighbours
    and the ground touch on generic, untied SAT axes."""
    rng = np.random.default_rng(seed)
    n = st.p.shape[0]
    p = np.asarray(st.p)[None] + rng.uniform(-2e-3, 2e-3, (B, n, 3))
    p[..., 2] -= 3e-3
    phi = rng.uniform(-0.05, 0.05, (B, n, 3))
    ang = np.linalg.norm(phi, axis=-1, keepdims=True)
    q = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * phi / ang], -1)
    z = np.zeros((B, n, 3))
    jstates = JaxState(p=jnp.asarray(p), v=jnp.asarray(z), q=jnp.asarray(q), w=jnp.asarray(z))
    return jstates, State(p=_t(p), v=_t(z), q=_t(q), w=_t(z))


def _contacts_close(got, want, what=""):
    for k in ("b0", "b1", "active"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=f"{what} {k}")
    for k in ("position", "normal", "depth"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-9, err_msg=f"{what} {k}")


@functools.lru_cache(maxsize=None)
def _pile():
    spec, st = js.box_pile(27, spacing=0.97, dtype=jnp.float64)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    return spec, tspec, _pile_states(st, 2)


# name: configuration of make_contacts_batched on the compressed pile
CONTACT_CASES = {
    "broadphase_k256": SimConfig(contact_capacity=256, pair_capacity=200,
                                 broadphase_margin=0.05),
    "windowed_dedupe_k384": SimConfig(contact_capacity=384, pair_capacity=200,
                                      broadphase_margin=0.05, min_constraint_distance=0.02),
    "top_k_compaction_k4096": SimConfig(contact_capacity=4096),
}


@pytest.mark.parametrize("name", sorted(CONTACT_CASES))
def test_make_contacts_batched_matches_jax(name):
    cfg = CONTACT_CASES[name]
    spec, tspec, (jstates, tstates) = _pile()
    jcfg = _jax_cfg(cfg)
    want = jax.jit(jax.vmap(lambda s: jcont.make_contacts(spec, s, jcfg)))(jstates)
    got = tcont.make_contacts_batched(tspec, tstates, cfg)
    _contacts_close(got, want, name)
    assert int(got.active.sum(1).min()) > 40
    if name == "windowed_dedupe_k384":
        # the dedupe drops lanes here
        loose = tcont.make_contacts_batched(tspec, tstates, cfg.replace(
            min_constraint_distance=1e-6))
        assert int(loose.active.sum()) > int(got.active.sum())


def test_count_dropped_contacts_matches_jax():
    spec, tspec, (jstates, tstates) = _pile()
    for K, pc, dropped in ((640, 200, False), (256, 200, True), (640, 100, True)):
        cfg = SimConfig(contact_capacity=K, pair_capacity=pc, broadphase_margin=0.05)
        jcfg = _jax_cfg(cfg)
        want = np.asarray(jax.jit(jax.vmap(
            lambda s: jcont.count_dropped_contacts(spec, s, jcfg)))(jstates))
        got = tcont.count_dropped_contacts(tspec, tstates, cfg)
        np.testing.assert_array_equal(got.numpy(), want)
        assert bool((got > 0).all()) if dropped else not bool(got.any())


def test_gated_b2p_b3_plain_match_jax():
    """The plain B2p and B3 on each scenario's (Pc,) pairs and gate give
    the JAX package's contacts (pairwise dedupe, K below 384)."""
    spec, tspec, (jstates, tstates) = _pile()
    cfg = SimConfig(contact_capacity=256, pair_capacity=200, broadphase_margin=0.05)
    pi, pj, gate = tbp.select_scene_pairs(tspec, tstates, cfg)
    assert not bool(gate.all()) and int(pi[~gate].abs().sum()) == 0   # self-pairs (0, 0)
    pair = collide_boxes_lanes_packed_plain(tstates.p, tstates.q, tspec.half_extents, pi, pj,
                                            gate)
    ungated = collide_boxes_lanes_packed_plain(tstates.p, tstates.q, tspec.half_extents, pi, pj)
    assert bool(ungated[3][~gate].any()) and not bool(pair[3][~gate].any())
    got = compact_contacts_plain(tstates.p, tstates.q, tspec.half_extents, tspec.ground_enabled,
                                 pair, pi, pj, cfg.contact_capacity,
                                 cfg.min_constraint_distance ** 2)
    want = jax.jit(jax.vmap(lambda s: jcont.make_contacts(spec, s, _jax_cfg(cfg))))(jstates)
    _contacts_close(got, want, "gated B2p -> B3")


def test_fused_chain_with_broadphase_matches_jax():
    spec, st = js.living_room(dtype=jnp.float64)
    B, steps = 2, 6
    jstates = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    jstates = jstates._replace(p=jstates.p + jnp.linspace(0, 1e-3, B)[:, None, None])
    cfg = BENCH.replace(contact_capacity=16, pair_capacity=6, broadphase_margin=0.1)
    jcfg = _jax_cfg(cfg).replace(solver=jstep.SolverKind.JACOBI, contact_kernel=False)
    run = jax.jit(lambda s: jax.lax.fori_loop(
        0, steps, lambda _, x: jstep.step_ode_batched(spec, x, jcfg), s))
    want = run(jstates)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tstates = convert.state_from_numpy(_np(jstates), device="cpu", dtype=torch.float64)
    got = rollout_batched(tspec, tstates, cfg, steps)
    for k in "pvqw":
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-8, err_msg=k)
    # the selection is live: the 15 candidate pairs are cut to 6 lanes
    pi, _, gate = tcont.scene_pairs(tspec, tstates, cfg)
    assert pi.shape == (B, 6) and 0 < int(gate.sum(1).max()) < 6


def test_box_pile_and_mjcf_boxes_match_jax(tmp_path):
    for want, got in ((js.box_pile(27, jitter=0.05, seed=3, dtype=jnp.float64),
                       ts.box_pile(27, jitter=0.05, seed=3, device="cpu")),):
        for w, g in zip(want, got):
            for k, v in _np(w).items():
                np.testing.assert_allclose(getattr(g, k).numpy(), v, rtol=0, atol=1e-15,
                                           err_msg=k)
    xml = tmp_path / "room.xml"
    xml.write_text("""<mujoco><worldbody>
  <body name="floor_table"><geom type="box" pos="0 0 0.4" size="1 0.5 0.4"/></body>
  <body name="shelf"><geom type="box" pos="2 0 1" size="0.3 0.8 1" euler="0 0 30"/></body>
  <body name="crate"><freejoint/>
    <geom type="box" pos="0.2 0.1 1.2" size="0.2 0.2 0.2" euler="10 20 45"/></body>
  <body name="book"><freejoint/><geom type="box" pos="2 0 2.3" size="0.1 0.15 0.02"/>
    <geom type="sphere" size="0.1"/></body>
</worldbody></mujoco>""")
    want = js.mjcf_boxes(str(xml), dtype=jnp.float64)
    got = ts.mjcf_boxes(str(xml), device="cpu")
    for w, g in zip(want, got):
        for k, v in _np(w).items():
            np.testing.assert_allclose(getattr(g, k).numpy(), v, rtol=0, atol=1e-14, err_msg=k)
    assert got[0].num_pairs == 5 and got[0].ground_enabled.tolist() == [False, False, True, True]
