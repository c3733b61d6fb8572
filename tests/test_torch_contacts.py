"""Port parity: contact assembly (`make_contacts_batched`) and constraint
assembly (`build_constraints`) of `eggshell_tpu_torch` against the JAX
package, float64, on the 4-box stack and a tumbled 4-box cairn.  Lanes
(b0, b1, active, row masks, bounds) must be equal; geometry and Jacobian
values within 1e-9."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.physics import constraints as jcon
from eggshell_tpu.physics import contacts as jcont
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.physics import constraints as tcon
from eggshell_tpu_torch.physics import contacts as tcont
from eggshell_tpu_torch.utils.config import SimConfig
from torch_limits import time_limit  # noqa: F401

TOL = 1e-9


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _stack(B):
    spec, st = js.box_stack(4)
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    return spec, states._replace(p=states.p + jnp.linspace(0, 1e-3, B)[:, None, None])


def _tumbled_cairn(B):
    """cairn(4)'s random orientations and velocities, dropped into a heap
    touching the ground and each other."""
    spec, st = js.cairn(4, seed=0)
    p0 = jnp.asarray([[0.0, 0.0, 0.1], [0.05, 0.02, 0.33], [-0.04, 0.06, 0.56],
                      [0.25, -0.1, 0.12]])
    rng = np.random.default_rng(4)
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    return spec, states._replace(p=p0 + jnp.asarray(rng.uniform(-0.02, 0.02, (B, 4, 3))))


SCENES = {"box_stack4": (_stack, 20), "cairn4_tumbled": (_tumbled_cairn, 40)}


def _both(name, **cfg_kw):
    build, K = SCENES[name]
    spec, states = build(4)
    kw = dict(contact_capacity=K, **cfg_kw)
    jcfg = JaxSimConfig(**kw)
    tcfg = SimConfig(**kw)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tstates = convert.state_from_numpy(_np(states), device="cpu", dtype=torch.float64)
    return (spec, states, jcfg), (tspec, tstates, tcfg)


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """JAX contacts, contact frames and constraints (with and without
    `ref_app_bounds`) of one scene, in one compiled program (compiling is
    most of this file's time)."""
    (spec, states, jcfg), _ = _both(name)

    def run(sts):
        css = jcont.make_contacts_batched(spec, sts, jcfg, use_kernel=False)
        sys_ = {ref: jax.vmap(lambda st, cs: jcon.build_constraints(
                    spec, st, cs, jcfg.replace(ref_app_bounds=ref)))(sts, css)
                for ref in (False, True)}
        return css, jax.vmap(jcont.contact_frames)(css), sys_

    return jax.jit(run)(states)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_make_contacts_batched_matches_jax(name):
    _, (tspec, tstates, tcfg) = _both(name)
    want, want_frames, _ = _jax_reference(name)
    got = tcont.make_contacts_batched(tspec, tstates, tcfg)
    for field in ("b0", "b1", "active"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    for field in ("position", "normal", "depth"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=TOL, err_msg=field)
    np.testing.assert_allclose(tcont.contact_frames(got).numpy(), np.asarray(want_frames),
                               rtol=0, atol=TOL)
    n_active = np.asarray(want.active).sum(-1)
    assert (n_active > 4).all() and (n_active < SCENES[name][1]).all()


@pytest.mark.parametrize("name,ref_app_bounds",
                         [("box_stack4", False), ("cairn4_tumbled", False), ("box_stack4", True)])
def test_build_constraints_matches_jax(name, ref_app_bounds):
    _, (tspec, tstates, tcfg) = _both(name, ref_app_bounds=ref_app_bounds)
    want = _jax_reference(name)[2][ref_app_bounds]
    got = tcon.build_constraints(
        tspec, tstates, tcont.make_contacts_batched(tspec, tstates, tcfg), tcfg)
    for field in ("is_eq", "row_active", "lo", "hi"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    for field in ("J", "err"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=TOL, err_msg=field)
