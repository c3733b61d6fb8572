"""Port parity: the plain projected-Jacobi LCP solve of
`eggshell_tpu_torch` (`ops.pgs_kernel.solve_lcp_jacobi_plain`, the plain
version of the CUDA Jacobi kernel) against the JAX package's Pallas
kernel `solve_lcp_jacobi_pallas` run in interpret mode, float64, within
1e-9.  m = 24 needs no row padding; m = 30 (the joints slice's row count)
is padded to 32 and m = 60 to 64; the block-Jacobi form at m = 30 and 60."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.ops import lcp as jlcp
from eggshell_tpu.ops.pgs_kernel import solve_lcp_jacobi_pallas
from eggshell_tpu_torch.ops import lcp as tlcp
from eggshell_tpu_torch.ops.pgs_kernel import solve_lcp_jacobi, solve_lcp_jacobi_plain
from torch_limits import time_limit  # noqa: F401

TOL = 1e-9


def _problem(B, m, seed):
    """SPD systems (J M^-1 J^T-like plus a diagonal shift) with contact-like
    rows: tangent rows boxed in [-1, 1], normal rows in [0, inf), and a
    few equality rows."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, m, 12))
    A = G @ G.transpose(0, 2, 1) / 12 + 0.5 * np.eye(m)
    b = rng.normal(size=(B, m))
    row = np.arange(m)
    is_eq = np.broadcast_to(row % 7 == 6, (B, m)).copy()
    normal = np.broadcast_to(row % 3 == 2, (B, m))
    lo = np.where(normal, 0.0, -1.0)
    hi = np.where(normal, np.inf, 1.0)
    return A, b, is_eq, lo, hi


@pytest.mark.parametrize("m", [24, 30, 60])
def test_plain_jacobi_matches_pallas_kernel(m):
    A, b, is_eq, lo, hi = _problem(8, m, seed=m)
    kw = dict(iters=16, omega=0.3, beta=0.45)
    want = solve_lcp_jacobi_pallas(*[jnp.asarray(x) for x in (A, b, is_eq, lo, hi)],
                                   interpret=True, **kw)
    got = solve_lcp_jacobi_plain(*[torch.tensor(x) for x in (A, b, is_eq, lo, hi)], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    x = got.numpy()
    assert (x[~is_eq] >= lo[~is_eq]).all() and (x[~is_eq] <= hi[~is_eq]).all()


@pytest.mark.parametrize("m", [30, 60])
def test_plain_block_jacobi_matches_pallas_kernel(m):
    A, b, is_eq, lo, hi = _problem(8, m, seed=m + 1)
    kw = dict(iters=16, omega=0.3)
    want = solve_lcp_jacobi_pallas(*[jnp.asarray(x) for x in (A, b, is_eq, lo, hi)],
                                   interpret=True, block=True, **kw)
    got = solve_lcp_jacobi_plain(*[torch.tensor(x) for x in (A, b, is_eq, lo, hi)], block=True,
                                 **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    x = got.numpy()
    assert (x[~is_eq] >= lo[~is_eq]).all() and (x[~is_eq] <= hi[~is_eq]).all()


def test_project_matches_jax():
    A, b, is_eq, lo, hi = _problem(4, 24, seed=1)
    x = 3.0 * b
    want = jlcp.project(*[jnp.asarray(v) for v in (x, is_eq, lo, hi)])
    got = tlcp.project(*[torch.tensor(v) for v in (x, is_eq, lo, hi)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_wrapper_takes_plain_version_on_cpu():
    args = [torch.tensor(x) for x in _problem(4, 24, seed=2)]
    before = solve_lcp_jacobi.launches
    got = solve_lcp_jacobi(*args, iters=8, omega=0.3, beta=0.45)
    assert solve_lcp_jacobi.launches == before
    assert torch.equal(got, solve_lcp_jacobi_plain(*args, iters=8, omega=0.3, beta=0.45))
