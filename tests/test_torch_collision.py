"""Port parity: the plain SAT narrowphase of `eggshell_tpu_torch`
(`ops.collision.collide_boxes`, the plain version of the CUDA narrowphase
kernel, and what `collide_boxes_lanes` runs on CPU tensors) against
`jax.vmap(eggshell_tpu.ops.collision.collide_boxes)`, float64.

Codes and active lanes must be equal and positions / depths agree within
1e-9.  Generic random poses never tie two axes; the aligned and
shared-axis pairs of `random_boxes` do tie two face axes exactly, and
which one wins is decided by rounding (XLA's CPU mat-vec rounds through
fused multiply-adds, torch's does not), so there the test holds the two
to the same verdict and depth, as the JAX package's own kernel test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.ops import collision as jc
from eggshell_tpu.ops import quaternion as jq
from eggshell_tpu_torch.ops import collision as tc
from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes
from torch_limits import time_limit  # noqa: F401

TOL = 1e-9


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.array(jq.quat_to_mat(jnp.asarray(q)))


def _generic_pairs(rng, n):
    c1 = rng.uniform(-1, 1, (n, 3))
    c2 = rng.uniform(-1, 1, (n, 3))
    h1 = rng.uniform(1e-2, 1.0, (n, 3))
    h2 = rng.uniform(1e-2, 1.0, (n, 3))
    return c1, _rotations(rng, n), h1, c2, _rotations(rng, n), h2


def _axis_aligned_pairs(rng):
    """Stacked (overlapping), exactly touching, coincident, side by side
    and separated boxes with identity rotations, as in a box stack."""
    c1, h1, h2, c2 = [], [], [], []
    for k in range(40):
        a = rng.uniform(0.05, 0.5, 3)
        b = rng.uniform(0.05, 0.5, 3)
        p = rng.uniform(-1, 1, 3)
        off = [np.array([0, 0, 0.95 * (a[2] + b[2])]),           # stacked
               np.array([0, 0, a[2] + b[2]]),                    # touching
               np.zeros(3),                                      # coincident
               np.array([0.5 * (a[0] + b[0]), 0, 0.9 * (a[2] + b[2])]),  # offset stack
               np.array([0, 0, 1.5 * (a[2] + b[2])])][k % 5]     # separated
        c1.append(p), h1.append(a), h2.append(b), c2.append(p + off)
    eye = np.broadcast_to(np.eye(3), (40, 3, 3)).copy()
    return np.array(c1), eye, np.array(h1), np.array(c2), eye.copy(), np.array(h2)


def _degenerate_pairs(rng):
    """The shared-axis and fully aligned random pairs of tests/test_collision.py."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_collision import random_boxes

    return random_boxes(rng, 300)


@pytest.fixture(scope="module")
def results():
    """JAX and port results for all three pair sets, from one compiled
    JAX call (compiling dominates this file's time)."""
    sets = {
        "generic": _generic_pairs(np.random.default_rng(0), 500),
        "axis_aligned": _axis_aligned_pairs(np.random.default_rng(0)),
        "degenerate": _degenerate_pairs(np.random.default_rng(0)),
    }
    args = [np.concatenate([sets[k][i] for k in sets]) for i in range(6)]
    want = jax.jit(jax.vmap(jc.collide_boxes))(*[jnp.asarray(a) for a in args])
    out, start = {}, 0
    for k, v in sets.items():
        sl = slice(start, start + len(v[0]))
        start = sl.stop
        out[k] = (type(want)(*[np.asarray(x)[sl] for x in want]),
                  tc.collide_boxes(*[torch.tensor(a) for a in v]))
    return out


def _assert_equal_lanes(want, got):
    np.testing.assert_array_equal(got.code.numpy(), np.asarray(want.code))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    act = np.asarray(want.active)
    np.testing.assert_allclose(got.position.numpy()[act], np.asarray(want.position)[act],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.depth.numpy()[act], np.asarray(want.depth)[act],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.info_depth.numpy(), np.asarray(want.info_depth),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.separating_axis.numpy(), np.asarray(want.separating_axis),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["generic", "axis_aligned"])
def test_plain_narrowphase_matches_jax(results, case):
    want, got = results[case]
    _assert_equal_lanes(want, got)
    codes = np.asarray(want.code)
    if case == "generic":
        # the set reaches separated, face, edge-edge and fallback contacts
        assert (codes == 0).any() and (codes >= 7).any() and ((codes >= 1) & (codes <= 6)).any()
    else:
        kind = np.arange(codes.size) % 5
        # separated pairs separate, overlapping ones collide; exactly
        # touching pairs go either way with the rounding of p + offset
        assert (codes[kind == 4] == 0).all()
        assert (codes[np.isin(kind, (0, 2, 3))] > 0).all()


def test_plain_narrowphase_degenerate_pairs_same_verdict(results):
    """Shared-axis and fully aligned random pairs: equal codes wherever no
    two axes tie; on tied pairs the same verdict, the same depth and a
    contact."""
    want, got = results["degenerate"]
    wc, gc = np.asarray(want.code), got.code.numpy()
    tie = wc != gc
    assert tie.mean() < 0.05
    np.testing.assert_allclose(got.info_depth.numpy()[tie], np.asarray(want.info_depth)[tie],
                               rtol=0, atol=TOL)
    assert ((wc[tie] > 0) == (gc[tie] > 0)).all()
    assert (got.active.numpy()[tie].sum(-1) > 0).all()
    same = ~tie
    np.testing.assert_array_equal(got.active.numpy()[same], np.asarray(want.active)[same])


def test_ground_contacts_match_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(-0.3, 0.3, (64, 3))
    R = _rotations(rng, 64)
    hs = rng.uniform(0.05, 0.5, (64, 3))
    want = jax.vmap(jc.collide_box_and_ground)(jnp.asarray(p), jnp.asarray(R), jnp.asarray(hs))
    got = tc.collide_box_and_ground(torch.tensor(p), torch.tensor(R), torch.tensor(hs))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    assert np.asarray(want[3]).any() and not np.asarray(want[3]).all()


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    args = [torch.tensor(a) for a in _generic_pairs(np.random.default_rng(2), 50)]
    before = collide_boxes_lanes.launches
    got = collide_boxes_lanes(*args)
    want = tc.collide_boxes(*args)
    assert collide_boxes_lanes.launches == before
    for w, g in zip(want, got):
        assert torch.equal(w, g)
