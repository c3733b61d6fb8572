"""Port parity: quaternion / SO(3) primitives of `eggshell_tpu_torch`
against `eggshell_tpu.ops.quaternion`, float64, same numpy inputs.
Tolerance 1e-12: the same formulas in the same order, so only the last
bits of library sqrt/sin/cos may differ.  `random_quat` and
`random_rotation` draw on a torch.Generator where the JAX package takes a
key: they are held to unit norm and orthonormality instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.ops import quaternion as jq
from eggshell_tpu_torch.ops import quaternion as tq
from torch_limits import time_limit  # noqa: F401

TOL = 1e-12


def _close(want, got):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {
        "q1": rng.normal(size=(64, 4)),
        "q2": rng.normal(size=(64, 4)),
        "v": rng.normal(size=(64, 3)),
        "phi": np.concatenate([rng.normal(size=(60, 3)), 1e-8 * rng.normal(size=(4, 3))]),
    }


@pytest.mark.parametrize("name", ["quat_to_mat", "quat_normalize", "quat_mul",
                                  "quat_from_scaled_axis", "cross_mat", "integrate_quat"])
def test_quaternion_op_matches_jax(data, name):
    q1, q2, v, phi = data["q1"], data["q2"], data["v"], data["phi"]
    args = {
        "quat_to_mat": (q1,),
        "quat_normalize": (q1,),
        "quat_mul": (q1, q2),
        "quat_from_scaled_axis": (phi,),
        "cross_mat": (v,),
        "integrate_quat": (jq.quat_normalize(jnp.asarray(q1)), v, 1e-3),
    }[name]
    want = getattr(jq, name)(*[jnp.asarray(a) if not isinstance(a, float) else a for a in args])
    got = getattr(tq, name)(*[torch.tensor(np.asarray(a)) if not isinstance(a, float) else a
                              for a in args])
    _close(want, got)


def test_align_vectors_matches_jax_including_antiparallel(data):
    """Stacked boxes give normals antiparallel to +z: the w < 1e-8 branch,
    whose axis is the argmin of |a| with ties going to the first index."""
    v = data["v"]
    special = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -2.5], [1.0, 1.0, 0.0],
                        [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
    a = np.concatenate([v, special])
    b = np.broadcast_to([0.0, 0.0, 1.0], a.shape).copy()
    want = jq.align_vectors_mat(jnp.asarray(a), jnp.asarray(b))
    got = tq.align_vectors_mat(torch.as_tensor(a), torch.as_tensor(b))
    _close(want, got)
    # R maps a-hat onto +z (zero vectors map to the identity-free fallback)
    ah = a[:-1] / np.linalg.norm(a[:-1], axis=1, keepdims=True)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", got.numpy()[:-1], ah),
                               b[:-1], atol=1e-12)


def test_box_inertia_matches_jax(data):
    rng = np.random.default_rng(1)
    m = rng.uniform(0.5, 2.0, 16)
    s = rng.uniform(0.1, 1.0, (16, 3))
    _close(jq.box_inertia(jnp.asarray(m), jnp.asarray(s)),
           tq.box_inertia(torch.as_tensor(m), torch.as_tensor(s)))


@pytest.fixture(scope="module")
def quat_data():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4))
    R = tq.quat_to_mat(tq.quat_normalize(torch.as_tensor(q))).numpy()
    # near the identity and at half turns about each axis (mat_to_quat's branches)
    special = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
                        np.diag([-1.0, -1.0, 1.0]),
                        tq.quat_to_mat(torch.tensor([1.0, 1e-7, -2e-7, 1e-7])).numpy()])
    return {"q": q, "v": rng.normal(size=(64, 3)), "R": np.concatenate([R, special]),
            "M": rng.normal(size=(64, 3, 3))}


@pytest.mark.parametrize("name", ["quat_conj", "quat_rotate", "quat_rotate_inv", "mat_to_quat",
                                  "gram_schmidt", "is_orthonormal"])
def test_quaternion_helper_matches_jax(quat_data, name):
    q, v, R, M = quat_data["q"], quat_data["v"], quat_data["R"], quat_data["M"]
    args = {"quat_conj": (q,), "quat_rotate": (q, v), "quat_rotate_inv": (q, v),
            "mat_to_quat": (R,), "gram_schmidt": (M,),
            "is_orthonormal": (np.concatenate([R, M[:8]]),)}[name]
    want = np.asarray(jax.jit(getattr(jq, name))(*map(jnp.asarray, args)))
    got = getattr(tq, name)(*map(torch.as_tensor, args))
    if name == "is_orthonormal":
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[:len(R)].all() and not want[len(R):].any()
    else:
        _close(want, got)


def test_quat_identity_defaults_to_the_card():
    """The identity is made on the card unless the caller asks for the CPU,
    as the scene builders do; on the CPU it is (1, 0, 0, 0)."""
    import inspect

    assert inspect.signature(tq.quat_identity).parameters["device"].default == "cuda"
    q = tq.quat_identity(torch.float32, device="cpu")
    assert q.device.type == "cpu" and q.tolist() == [1.0, 0.0, 0.0, 0.0]


def test_quaternion_identity_and_random_rotations():
    np.testing.assert_array_equal(tq.quat_identity(torch.float64, device="cpu").numpy(),
                                  np.asarray(jq.quat_identity(jnp.float64)))
    gen = torch.Generator().manual_seed(0)
    q = tq.random_quat(gen, (100,), torch.float64)
    assert q.shape == (100, 4)
    np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=-1).numpy(), 1.0, rtol=0, atol=TOL)
    R = tq.random_rotation(gen, (7, 3), torch.float64)
    assert R.shape == (7, 3, 3, 3) and bool(tq.is_orthonormal(R).all())
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, rtol=0, atol=TOL)
    v = torch.as_tensor(np.random.default_rng(1).normal(size=(100, 3)))
    _close(torch.einsum("nij,nj->ni", tq.quat_to_mat(q), v).numpy(), tq.quat_rotate(q, v))
    _close(v.numpy(), tq.quat_rotate_inv(q, tq.quat_rotate(q, v)))
