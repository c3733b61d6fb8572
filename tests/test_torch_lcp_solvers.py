"""Port parity: the LCP solvers of `eggshell_tpu_torch` against the JAX
package, float64.

- `ops.lcp.solve_lcp` against the JAX `solve_lcp_batched` for PGS, SOR,
  plain, heavy-ball, block, coupled (Coulomb-pyramid) and block + coupled
  Jacobi, and Jacobi with an early exit (`check_tol`), B = 6, m = 12 or 24,
  within 1e-10: the same sweeps, summed in another order.
- The plain version of the block-Jacobi kernel B6c'
  (`solve_lcp_jacobi_plain(block=True)`) against the JAX package's Pallas
  kernel `solve_lcp_jacobi_pallas(block=True)` in interpret mode, m = 24
  (no row padding) and m = 60 (padded to 64), within tests/test_torch_lcp.py's
  TOL; `beta` is given and ignored by both.
- The plain versions of B6's block, pyramid and block + pyramid forms
  against the JAX package's `solve_lcp_jacobi_packed(interpret=True)` on
  tests/test_torch_fused.py's packed inputs (equality, inactive and idle
  lanes), within that file's TOL_SWEEPS.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.ops import lcp as jlcp
from eggshell_tpu.ops.pgs_kernel import solve_lcp_jacobi_pallas
from eggshell_tpu.ops.pgs_kernel import solve_lcp_jacobi_packed as jax_jacobi_packed
from eggshell_tpu_torch.ops import lcp as tlcp
from eggshell_tpu_torch.ops.amat_kernel import padded_rows
from eggshell_tpu_torch.ops.pgs_kernel import (solve_lcp_jacobi, solve_lcp_jacobi_block,
                                               solve_lcp_jacobi_packed_plain,
                                               solve_lcp_jacobi_plain)
from test_torch_fused import TOL_SWEEPS, B, K, _lcp_inputs, _pack_np, _stripes
from test_torch_lcp import TOL, _problem
from torch_limits import time_limit  # noqa: F401

TOL_SOLVE = 1e-10
MU = 0.5


def _pyramid_problem(Bn, m, seed):
    """`_problem`'s SPD systems with Coulomb-pyramid rows: each normal row
    (3k + 2) in [0, inf), its two tangent rows coupled to it (static bounds
    [0, 0]); no equality rows."""
    A, b, _, _, _ = _problem(Bn, m, seed)
    row = np.arange(m)
    normal = np.broadcast_to(row % 3 == 2, (Bn, m))
    is_eq = np.zeros((Bn, m), bool)
    lo = np.zeros((Bn, m))
    hi = np.where(normal, np.inf, 0.0)
    couple = np.broadcast_to(np.where(row % 3 == 2, -1, 3 * (row // 3) + 2), (Bn, m)).copy()
    return A, b, is_eq, lo, hi, couple


SOLVER_CASES = {
    # name: (m, coupled, keyword arguments of solve_lcp)
    "pgs": (24, False, dict(method="pgs", iters=12)),
    "pgs_coupled": (12, True, dict(method="pgs", iters=12, mu=MU)),
    "sor": (24, False, dict(method="sor", iters=12, omega=1.5)),
    "jacobi": (24, False, dict(method="jacobi", iters=20, jacobi_omega=0.3)),
    "jacobi_heavy_ball": (24, False, dict(method="jacobi", iters=20, jacobi_omega=0.3,
                                          jacobi_beta=0.45)),
    "jacobi_block": (24, False, dict(method="jacobi", iters=12, jacobi_omega=0.5,
                                     jacobi_block=True)),
    "jacobi_coupled": (12, True, dict(method="jacobi", iters=20, jacobi_omega=0.3,
                                      jacobi_beta=0.45, mu=MU)),
    "jacobi_block_coupled": (12, True, dict(method="jacobi", iters=12, jacobi_omega=0.5,
                                            jacobi_beta=0.2, jacobi_block=True, mu=MU)),
    "jacobi_check_tol": (24, False, dict(method="jacobi", iters=60, jacobi_omega=0.5,
                                         check_tol=1e-2)),
}


def _solver_inputs(name):
    m, coupled, kw = SOLVER_CASES[name]
    if coupled:
        return _pyramid_problem(6, m, seed=m + 1), kw
    return (*_problem(6, m, seed=m), None), kw


@pytest.mark.parametrize("name", sorted(SOLVER_CASES))
def test_solve_lcp_matches_jax(name):
    (A, b, is_eq, lo, hi, couple), kw = _solver_inputs(name)
    jargs = [jnp.asarray(x) for x in (A, b, is_eq, lo, hi)]
    targs = [torch.tensor(x) for x in (A, b, is_eq, lo, hi)]
    if couple is None:
        want = jlcp.solve_lcp_batched(*jargs, **kw)
        got = tlcp.solve_lcp_batched(*targs, **kw)
    else:
        # couple is per scenario: vmap it along with the system
        import jax

        want = jax.vmap(lambda A_, b_, e_, l_, h_, c_: jlcp.solve_lcp(
            A_, b_, e_, l_, h_, couple=c_, **kw))(*jargs, jnp.asarray(couple))
        got = tlcp.solve_lcp(*targs, couple=torch.tensor(couple), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL_SOLVE)
    x = got.numpy()
    assert np.isfinite(x).all() and np.abs(x).max() > 0
    if couple is not None:
        # normal impulses push; the coupled bounds bite (not the static [0, 0])
        assert (x[:, 2::3] >= 0).all() and np.abs(x[:, 0::3]).max() > 0
    if "check_tol" in kw:
        # scenarios stop early, each at its own sweep: fewer sweeps than the cap
        full = tlcp.solve_lcp(*targs, **{**kw, "check_tol": None}).numpy()
        res = tlcp.residual_error(*targs[:2], got, *targs[2:]).numpy()
        assert (res <= kw["check_tol"]).all()
        assert not np.allclose(x, full, rtol=0, atol=1e-12)


@pytest.mark.parametrize("m", [24, 60])
def test_plain_block_jacobi_matches_pallas_kernel(m):
    A, b, is_eq, lo, hi = _problem(8, m, seed=m + 2)
    kw = dict(iters=16, omega=0.5)
    want = solve_lcp_jacobi_pallas(*[jnp.asarray(x) for x in (A, b, is_eq, lo, hi)],
                                   interpret=True, block=True, beta=0.45, **kw)
    args = [torch.tensor(x) for x in (A, b, is_eq, lo, hi)]
    got = solve_lcp_jacobi_plain(*args, beta=0.45, block=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # beta is ignored in block mode; on the CPU the wrapper is the plain version
    before = solve_lcp_jacobi_block.launches
    assert torch.equal(solve_lcp_jacobi(*args, beta=0.0, block=True, **kw), got)
    assert solve_lcp_jacobi_block.launches == before
    # block sweeps are not the scalar ones
    assert not torch.allclose(got, solve_lcp_jacobi_plain(*args, beta=0.0, **kw))
    with pytest.raises(ValueError, match="3-row"):
        solve_lcp_jacobi(args[0][:, 1:, 1:], *[x[:, 1:] for x in args[1:]], block=True, **kw)


PACKED_CASES = {
    "block": dict(block=True),
    "pyramid": dict(pyramid_mu=MU),
    "block_pyramid": dict(block=True, pyramid_mu=MU),
}


@functools.lru_cache(maxsize=None)
def _jax_packed(name):
    A, diag, rhs, act, eq = _lcp_inputs(5)
    mp = padded_rows(K)
    x = jax_jacobi_packed(
        _stripes(A), _pack_np(rhs), _pack_np(act.astype(np.float64)), K=K, mu=1.0,
        iters=16, omega=0.3, beta=0.45, interpret=True,
        eq_packed=_pack_np(eq.astype(np.float64)), diag_packed=_stripes(diag),
        **PACKED_CASES[name])
    return np.asarray(x).transpose(0, 2, 3, 1).reshape(-1, mp)[:B]


@pytest.mark.parametrize("name", sorted(PACKED_CASES))
def test_packed_block_and_pyramid_plain_match_pallas_kernel(name):
    A, diag, rhs, act, eq = (torch.tensor(x) for x in _lcp_inputs(5))
    kw = PACKED_CASES[name]
    lcp = (A, diag, rhs, act, eq, K, 1.0, 16, 0.3, 0.45)
    got = solve_lcp_jacobi_packed_plain(*lcp, **kw)
    np.testing.assert_allclose(got.numpy(), _jax_packed(name), rtol=0, atol=TOL_SWEEPS)
    assert not torch.allclose(got, solve_lcp_jacobi_packed_plain(*lcp))
    x = got.numpy()[:, :3 * K].reshape(B, K, 3)
    assert (x[act.numpy() & ~eq.numpy()][:, 2] >= 0).all()      # normal impulses push
