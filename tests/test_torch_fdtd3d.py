"""Port parity: the 3D FDTD of `eggshell_tpu_torch.fem.fdtd` against the
JAX package's `eggshell_tpu.fem.fdtd`, float64.

- `make_cpml_3d`'s filter arrays within 1e-15 (both build them in float64
  NumPy), for all walls, one-sided bits and a box that is not a cube.
- `step_3d` over 20 steps from random fields at n = 14: plain, with an
  eps grid and PEC voxels, each TOROID_* bit and all three, CPML on every
  wall and on one-sided walls (with a periodic axis beside them); field
  and psi within 1e-12.
- `simulate_3d` with CPML, a soft source on Hy and the probe on Ez, and
  without CPML with the probe on the source's component: trace, field and
  psi within 1e-12.
- `energy_3d` and `efield_change` within 1e-12 of their scale;
  `export_fields_3d`'s files read back equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.fem import fdtd as jfdtd
from eggshell_tpu.utils.mat_file import load_mat as jax_load_mat
from eggshell_tpu_torch.fem import fdtd as tfdtd
from eggshell_tpu_torch.utils.mat_file import load_mat
from torch_limits import time_limit  # noqa: F401

TOL = 1e-12
N, STEPS = 14, 20


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol, err_msg=what)


def _tuples_close(got, want, tol=TOL):
    for name, g, w in zip(type(got)._fields, got, want):
        _close(g.numpy(), w, name, tol)


def _fields(n, seed):
    return np.random.default_rng(seed).normal(size=(6, n, n, n))


def _both_fields(arrays):
    return (tfdtd.Field3D(*(torch.tensor(a) for a in arrays)),
            jfdtd.Field3D(*(jnp.asarray(a) for a in arrays)))


def _materials(n, seed):
    rng = np.random.default_rng(seed)
    eps_r = rng.uniform(1.0, 4.0, (n, n, n))
    pec = rng.uniform(size=(n, n, n)) < 0.05
    pec[n // 2, 2:-2, 2:-2] = True
    return eps_r, pec


@pytest.mark.parametrize("shape,pml,depth", [
    ((14, 14, 14), jfdtd.PML_ALL, 4),
    ((12, 16, 10), jfdtd.PML_XMIN | jfdtd.PML_YMAX | jfdtd.PML_ZMIN, 3),
    ((20, 20, 20), jfdtd.PML_ZMAX, 8),
])
def test_make_cpml_3d(shape, pml, depth):
    dx = 1.0 / 13
    dt = tfdtd.courant_dt(dx, 3, 0.9)
    cpml, psi = tfdtd.make_cpml_3d(shape, dt, dx, pml=pml, depth=depth, dtype=torch.float64,
                                   device="cpu")
    jcpml, jpsi = jfdtd.make_cpml_3d(shape, dt, dx, pml=pml, depth=depth, dtype=jnp.float64)
    for name in ("a_e", "b_e", "a_h", "b_h"):
        for ax in range(3):
            _close(getattr(cpml, name)[ax].numpy(), getattr(jcpml, name)[ax], f"{name}[{ax}]",
                   1e-15)
    assert all(p.shape == shape and not p.any() for p in psi)
    assert len(psi) == len(jpsi) == 12


CASES = {
    "plain": dict(),
    "eps_pec": dict(materials=True),
    "toroid_x": dict(periodic=jfdtd.TOROID_X),
    "toroid_y": dict(periodic=jfdtd.TOROID_Y),
    "toroid_z": dict(periodic=jfdtd.TOROID_Z, materials=True),
    "toroid_xyz": dict(periodic=jfdtd.TOROID_X | jfdtd.TOROID_Y | jfdtd.TOROID_Z),
    "cpml_all": dict(pml=jfdtd.PML_ALL, materials=True),
    "cpml_one_sided": dict(pml=jfdtd.PML_XMIN | jfdtd.PML_ZMAX, periodic=jfdtd.TOROID_Y),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_3d(case):
    opts = CASES[case]
    dx = 1.0 / (N - 1)
    dt = tfdtd.courant_dt(dx, 3, 0.9)
    f, jf = _both_fields(_fields(N, 1))
    eps = pec = jeps = jpec = None
    if opts.get("materials"):
        e, p = _materials(N, 2)
        eps, pec, jeps, jpec = torch.tensor(e), torch.tensor(p), jnp.asarray(e), jnp.asarray(p)
    periodic = opts.get("periodic", 0)
    pml = opts.get("pml")
    if pml is None:
        for _ in range(STEPS):
            f = tfdtd.step_3d(f, dt, dx, eps, pec, periodic=periodic)
            jf = jfdtd.step_3d(jf, dt, dx, jeps, jpec, periodic=periodic)
    else:
        cpml, psi = tfdtd.make_cpml_3d((N,) * 3, dt, dx, pml=pml, depth=4, dtype=torch.float64,
                                       device="cpu")
        jcpml, jpsi = jfdtd.make_cpml_3d((N,) * 3, dt, dx, pml=pml, depth=4, dtype=jnp.float64)
        for _ in range(STEPS):
            f, psi = tfdtd.step_3d(f, dt, dx, eps, pec, cpml, psi, periodic)
            jf, jpsi = jfdtd.step_3d(jf, dt, dx, jeps, jpec, jcpml, jpsi, periodic)
        _tuples_close(psi, jpsi)
        assert float(max(p.abs().max() for p in psi)) > 0
    assert isinstance(f, tfdtd.Field3D)
    _tuples_close(f, jf)


def _sources(dt):
    t0, tau = 8 * dt, 3 * dt
    return (lambda t: torch.exp(-((t - t0) ** 2) / (2 * tau ** 2)),
            lambda t: jnp.exp(-((t - t0) ** 2) / (2 * tau ** 2)))


def test_simulate_3d_cpml_source_and_probe():
    n, steps = 12, 30
    dx = 1.0 / (n - 1)
    dt = tfdtd.courant_dt(dx, 3, 0.9)
    src, jsrc = _sources(dt)
    e, p = _materials(n, 3)
    cpml, psi = tfdtd.make_cpml_3d((n,) * 3, dt, dx, depth=3, dtype=torch.float64, device="cpu")
    jcpml, jpsi = jfdtd.make_cpml_3d((n,) * 3, dt, dx, depth=3, dtype=jnp.float64)
    kw = dict(source_ijk=(4, 6, 6), source_component="hy", probe_ijk=(7, 6, 5),
              probe_component="ez")
    f, psi, trace = tfdtd.simulate_3d(tfdtd.init_3d(n, torch.float64, device="cpu"), steps, dt,
                                      dx, torch.tensor(e), torch.tensor(p), cpml, psi,
                                      source_fn=src, **kw)
    jf, jpsi, jtrace = jfdtd.simulate_3d(jfdtd.init_3d(n, jnp.float64), steps, dt, dx,
                                         jnp.asarray(e), jnp.asarray(p), jcpml, jpsi,
                                         source_fn=jsrc, **kw)
    assert trace.shape == (steps,) and float(trace.abs().max()) > 0
    _close(trace.numpy(), jtrace, "trace")
    _tuples_close(f, jf)
    _tuples_close(psi, jpsi)


def test_simulate_3d_probe_defaults_to_source_component():
    n, steps = 12, 25
    dx = 1.0 / (n - 1)
    dt = tfdtd.courant_dt(dx, 3, 0.9)
    src, jsrc = _sources(dt)
    kw = dict(source_ijk=(5, 5, 6), source_component="ex", probe_ijk=(6, 5, 6),
              periodic=jfdtd.TOROID_Z)
    f, trace = tfdtd.simulate_3d(tfdtd.init_3d(n, torch.float64, device="cpu"), steps, dt, dx,
                                 source_fn=src, **kw)
    jf, jtrace = jfdtd.simulate_3d(jfdtd.init_3d(n, jnp.float64), steps, dt, dx,
                                   source_fn=jsrc, **kw)
    assert float(trace.abs().max()) > 0
    _close(trace.numpy(), jtrace, "trace")
    _tuples_close(f, jf)


def test_energy_and_efield_change():
    f, jf = _both_fields(_fields(10, 4))
    g, jg = _both_fields(_fields(10, 5))
    dx = 0.1
    e, je = float(tfdtd.energy_3d(f, dx)), float(jfdtd.energy_3d(jf, dx))
    assert abs(e - je) <= TOL * abs(je)
    c, jc = float(tfdtd.efield_change(f, g)), float(jfdtd.efield_change(jf, jg))
    assert abs(c - jc) <= TOL * abs(jc)
    assert float(tfdtd.efield_change(f, f)) == 0.0
    zero = tfdtd.init_3d(10, torch.float64, device="cpu")
    assert float(tfdtd.efield_change(zero, zero)) == float(jfdtd.efield_change(
        jfdtd.init_3d(10, jnp.float64), jfdtd.init_3d(10, jnp.float64))) == 0.0


def test_export_fields_3d(tmp_path):
    f, jf = _both_fields(_fields(6, 6).astype(np.float32))
    tfdtd.export_fields_3d(str(tmp_path / "port.mat"), f, 0.25)
    jfdtd.export_fields_3d(str(tmp_path / "jax.mat"), jf, 0.25)
    got, want = load_mat(str(tmp_path / "port.mat")), jax_load_mat(str(tmp_path / "jax.mat"))
    assert sorted(got) == sorted(want) == ["Ex", "Ey", "Ez", "Hx", "Hy", "Hz", "dx"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
