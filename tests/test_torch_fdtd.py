"""Port parity: the 2D FDTD core of `eggshell_tpu_torch.fem.fdtd` against
the JAX package's `eggshell_tpu.fem.fdtd`, float64.

- The plain version of the fused step B8 (`step_2d_fused_plain`) against
  the JAX package's Pallas kernel `step_2d_pallas` in interpret mode and
  against its XLA stencil `step_2d`, at n = 32 with random fields, an
  `eps_r` and a PEC mask, within 1e-12: the same expressions, and the two
  updates compute the same field (the JAX package's tests/test_fdtd.py
  holds them to 1e-6 in float32).  The port's own `step_2d` too.
- `simulate_2d` against the JAX `simulate_2d` at n = 48 for 300 steps,
  with a PEC wall and its aperture (examples/fdtd_aperture.py's layout), an
  `eps_r`, a Gaussian soft source and a probe: field and trace within
  1e-10.
- `convert.field2d_from_numpy`, and the wrapper's plain version on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import torch

from eggshell_tpu.fem import fdtd as jfdtd
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.fem import fdtd as tfdtd
from torch_limits import time_limit  # noqa: F401

TOL_STEP = 1e-12
TOL_SIM = 1e-10


def _grids(n, seed):
    """Random ez, hx, hy of an n x n grid, a relative permittivity in
    [1, 4] and a PEC mask (a wall with an aperture, and random cells)."""
    rng = np.random.default_rng(seed)
    ez = rng.normal(size=(n, n))
    hx = rng.normal(size=(n, n - 1))
    hy = rng.normal(size=(n - 1, n))
    eps_r = rng.uniform(1.0, 4.0, (n, n))
    pec = rng.uniform(size=(n, n)) < 0.05
    pec[:, n // 2] = True
    pec[n // 2 - 3:n // 2 + 3, n // 2] = False
    return ez, hx, hy, eps_r, pec


def _t(x):
    return torch.tensor(np.asarray(x))


def test_fused_step_plain_matches_pallas_kernel_and_stencil():
    n = 32
    dx = 1.0 / (n - 1)
    dt = tfdtd.courant_dt(dx, 2, 0.7)
    ez, hx, hy, eps_r, pec = _grids(n, 0)
    field = tfdtd.Field2D(_t(ez), _t(hx), _t(hy))
    ez0, hxp, hyp, inv_eps, pec_free = tfdtd.fused_grids(field, _t(eps_r), _t(pec))
    got = tfdtd.step_2d_fused_plain(ez0, hxp, hyp, inv_eps, pec_free, dt, dx)

    want = jfdtd.step_2d_pallas(*[jnp.asarray(x.numpy()) for x in (ez0, hxp, hyp, inv_eps,
                                                                    pec_free)],
                                dt, dx, interpret=True)
    for g, w, name in zip(got, want, ("ez", "hx_pad", "hy_pad")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL_STEP, err_msg=name)

    ref = jfdtd.step_2d(jfdtd.Field2D(jnp.asarray(ez), jnp.asarray(hx), jnp.asarray(hy)), dt, dx,
                        jnp.asarray(eps_r), jnp.asarray(pec))
    mine = tfdtd.step_2d(field, dt, dx, _t(eps_r), _t(pec))
    for k, g in (("ez", got[0]), ("hx", got[1][:, :-1]), ("hy", got[2][:-1, :])):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, k)), rtol=0, atol=TOL_STEP,
                                   err_msg=k)
        np.testing.assert_allclose(getattr(mine, k).numpy(), np.asarray(getattr(ref, k)), rtol=0,
                                   atol=TOL_STEP, err_msg=k)
    # E vanishes on PEC cells and the rim; the padding of H stays as it came
    assert (got[0].numpy()[pec] == 0).all() and (got[0].numpy()[[0, -1]] == 0).all()
    assert torch.equal(got[1][:, -1], hxp[:, -1]) and torch.equal(got[2][-1], hyp[-1])

    # on the CPU the wrapper is the plain version and counts nothing
    before = tfdtd.step_2d_fused.launches
    again = tfdtd.step_2d_fused(ez0, hxp, hyp, inv_eps, pec_free, dt, dx)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert tfdtd.step_2d_fused.launches == before


def test_simulate_2d_matches_jax():
    n, steps = 48, 300
    dx = 1.0 / (n - 1)
    dt = tfdtd.courant_dt(dx, 2, 0.7)
    pec = np.zeros((n, n), bool)
    pec[:, n // 2] = True
    pec[n // 2 - 4:n // 2 + 4, n // 2] = False
    eps_r = np.ones((n, n))
    eps_r[:, 3 * n // 4:] = 2.5
    t0, sig = 40 * dt, 12 * dt
    src_ij, probe_ij = (n // 2, n // 5), (n // 2, 3 * n // 4 + 2)

    def jsrc(t):
        return jnp.exp(-((t - t0) ** 2) / (2 * sig ** 2))

    def tsrc(t):
        return torch.exp(-((t - t0) ** 2) / (2 * sig ** 2))

    jf, jtrace = jfdtd.simulate_2d(jfdtd.init_2d(n, n, jnp.float64), steps, dt, dx,
                                   eps_r=jnp.asarray(eps_r), pec=jnp.asarray(pec),
                                   source_ij=src_ij, source_fn=jsrc, probe_ij=probe_ij)
    f0 = tfdtd.init_2d(n, n, torch.float64, device="cpu")
    tf, ttrace = tfdtd.simulate_2d(f0, steps, dt, dx, eps_r=_t(eps_r), pec=_t(pec),
                                   source_ij=src_ij, source_fn=tsrc, probe_ij=probe_ij)
    for k in ("ez", "hx", "hy"):
        np.testing.assert_allclose(getattr(tf, k).numpy(), np.asarray(getattr(jf, k)), rtol=0,
                                   atol=TOL_SIM, err_msg=k)
    np.testing.assert_allclose(ttrace.numpy(), np.asarray(jtrace), rtol=0, atol=TOL_SIM)
    ez = tf.ez.numpy()
    assert (ez[pec] == 0).all()
    # the pulse went through the aperture and reached the probe
    assert np.abs(ez[:, n // 2 + 2:]).max() > 1e-6 and np.abs(ttrace.numpy()).max() > 1e-6
    # without a probe the trace is zeros
    _, none = tfdtd.simulate_2d(f0, 3, dt, dx)
    assert none.shape == (3,) and not none.any()


def test_field2d_from_numpy():
    ez, hx, hy, _, _ = _grids(8, 1)
    jf = jfdtd.Field2D(jnp.asarray(ez), jnp.asarray(hx), jnp.asarray(hy))
    tf = convert.field2d_from_numpy({k: np.asarray(v) for k, v in jf._asdict().items()},
                                    device="cpu", dtype=torch.float32)
    assert isinstance(tf, tfdtd.Field2D)
    for k, want in zip(tfdtd.Field2D._fields, (ez, hx, hy)):
        x = getattr(tf, k)
        assert x.dtype == torch.float32 and x.shape == want.shape
        assert torch.equal(x, torch.tensor(want, dtype=torch.float32))
    assert tfdtd.init_2d(8, 6, device="cpu").hx.shape == (8, 5)
