"""Port parity: the FEM engine of `eggshell_tpu_torch` (assembly, the
driven solves, S-parameters, eigenmodes, fields and sweeps) against the
JAX package's, complex128/float64 on the CPU, within 1e-10 of the scale
unless a case says otherwise.  The meshes are made once by the JAX
package and handed to the port through `convert.mesh_from_numpy`.

- assembly: `element_matrices` (anisotropic), `assemble_matrices`,
  `edge_mass_vals`, `_boundary_mass`, `port_beta`;
- `solve_driven` with every solve (dense, "sparse", "bicgstab" within
  1e-6 of the scale, its stopping rule being |r| <= 1e-8 |b|, "bcr") on
  an EZ guide with a dielectric block, and on the problem types EXY
  (finite depth, anisotropic sigmas), ES (painted potentials), a
  dielectric-loaded port with numerical modes and two modes (the DtN
  block), and a point source with ABC and Robin walls;
- `make_driven_fn` with a batch of k0 against one k0 at a time;
- the gradient of |S21|^2 with respect to eps_tri and the points against
  `jax.grad`, through the dense, "sparse" and "bcr" solves (1e-8);
- `solve_modes` eigenvalues by "arpack", "shift_invert" and "lobpcg"
  (1e-8 relative), SCHRODINGER levels with a potential, and an unknown
  method raising;
- `fields`: the triangle index and probes, gradients, Poynting flux,
  cutoff frequencies, `solve_sweep`, `export_solution`, `wideband_pulse`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.fem import fields as jfields
from eggshell_tpu.fem import helmholtz as jh
from eggshell_tpu.fem import mesher as jmesher
from eggshell_tpu.fem import metal as jmetal
from eggshell_tpu.fem import shape as jshape
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.fem import fields as tfields
from eggshell_tpu_torch.fem import helmholtz as th
from torch_limits import time_limit  # noqa: F401

TOL = 1e-10
CPU = "cpu"


def _close(want, got, tol=TOL, what=""):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def _port(mesh):
    return convert.mesh_from_numpy(dataclasses.asdict(mesh))


def _tcfg(cfg):
    return th.FemConfig(**dataclasses.asdict(cfg))


def _guide(W=6.0, H=1.0, h=0.25, block_eps=None):
    cd = jshape.Rectangle(0.0, 0.0, W, H)
    cd.Port((0.0, 0.0), (0.0, H), 1)
    cd.Port((W, 0.0), (W, H), 2)
    if block_eps is not None:
        cd.Paint(jshape.Rectangle(2.0, 0.0, 3.0, H), epsilon=block_eps)
    return jmesher.mesh_structured(cd, (0.0, 0.0), (W, 0.0), (0.0, H), h)


def _freq(k0, unit=1.0):
    return k0 * 299792458.0 / (2 * np.pi * unit)


EZ_CFG = jh.FemConfig(type="EZ", frequency=_freq(4.5))


@functools.lru_cache(maxsize=None)
def _ez_mesh():
    return _guide(block_eps=2.2 - 0.05j)


def _exy_case():
    """A rotated-free EXY guide with anisotropic sigmas and a finite depth
    (tests/test_anisotropy.py's tensor at 30 degrees, sigma_eps 2)."""
    c, s, se = np.cos(np.pi / 6), np.sin(np.pi / 6), 2.0
    cd = jshape.Rectangle(0.0, 0.0, 6.0, 1.0)
    cd.Port((0.0, 0.0), (0.0, 1.0), 1)
    cd.Port((6.0, 0.0), (6.0, 1.0), 2)
    cd.Paint(jshape.Rectangle(-10, -10, 10, 10), epsilon=1.5,
             sigma_xx=(1 / se - 1) * c ** 2 + 1, sigma_yy=(1 - 1 / se) * c ** 2 + 1 / se,
             sigma_xy=(1 / se - 1) * c * s)
    mesh = jmesher.mesh_structured(cd, (0.0, 0.0), (6.0, 0.0), (0.0, 1.0), 0.25)
    return mesh, jh.FemConfig(type="EXY", frequency=_freq(5.0), depth=4.0), {}


def _es_case():
    box = jshape.Rectangle(0, 0, 2, 1)
    box.Potential((0, 0), (2, 0), 0.0)
    box.Potential((0, 1), (2, 1), 1.0)
    box.Paint(jshape.Rectangle(0.5, 0, 1.5, 0.5), epsilon=3.0)
    return jmesher.mesh_shape(box, 0.15, max_iters=20), jh.FemConfig(type="ES"), {}


def _loaded_port_case():
    cd = jshape.Rectangle(0.0, 0.0, 5.0, 1.0)
    cd.Port((0.0, 0.0), (0.0, 1.0), 1)
    cd.Port((5.0, 0.0), (5.0, 1.0), 2)
    cd.Paint(jshape.Rectangle(-1, 0.0, 6, 0.4), epsilon=2.5)
    mesh = jmesher.mesh_structured(cd, (0.0, 0.0), (5.0, 0.0), (0.0, 1.0), 0.2,
                                   material_split=0.4)
    return mesh, jh.FemConfig(type="EZ", frequency=_freq(7.0)), {"num_modes": 2}


def _radiation_case():
    cd = jshape.Rectangle(0.0, 0.0, 2.0, 1.5)
    cd.ABC((2.0, 0.0), (2.0, 1.5))
    cfg = jh.FemConfig(type="EZ", frequency=_freq(5.0))
    cd.Robin((0.0, 1.5), (2.0, 1.5), jmetal.metal_wall_alpha(cfg, 1e3))
    mesh = jmesher.mesh_shape(cd, 0.15, max_iters=20)
    return mesh, cfg, {"point_source": (0.6, 0.7)}


CASES = {
    "ez_dense": lambda: (_ez_mesh(), EZ_CFG, {"solver": "auto"}),
    "ez_sparse": lambda: (_ez_mesh(), EZ_CFG, {"solver": "sparse"}),
    "ez_bicgstab": lambda: (_ez_mesh(), EZ_CFG, {"solver": "bicgstab"}),
    "ez_bcr": lambda: (_ez_mesh(), EZ_CFG, {"solver": "bcr"}),
    "exy_aniso_depth": _exy_case,
    "es_potential": _es_case,
    "ez_loaded_port_2modes": _loaded_port_case,
    "ez_point_source_abc_robin": _radiation_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_driven(case):
    mesh, cfg, kw = CASES[case]()
    want = jh.solve_driven(mesh, cfg, **kw)
    got = th.solve_driven(_port(mesh), _tcfg(cfg), device=CPU, **kw)
    # BiCGStab stops at |r| <= 1e-8 |b|: two runs of it differ by the rounding
    # of their iterations, amplified by the conditioning, not by 1e-10
    tol = 1e-6 if kw.get("solver") == "bicgstab" else TOL
    _close(want.field, got.field, tol, "field")
    _close(want.s_matrix, got.s_matrix, tol, "s_matrix")
    _close(want.s_power, got.s_power, tol, "s_power")
    assert want.port_numbers == got.port_numbers
    for p in want.s_params:
        _close(want.s_params[p], got.s_params[p], tol, f"S{p}")
        _close(want.port_power[p], got.port_power[p], tol, f"power {p}")
    if want.port_numbers:
        jr = jh.port_outgoing_rms(mesh, cfg, want.field)
        tr = th.port_outgoing_rms(_port(mesh), _tcfg(cfg), got.field)
        for p in jr:
            _close(jr[p], tr[p], tol, f"rms {p}")


def test_assembly():
    mesh, _, _ = _exy_case()
    pts, tri = mesh.points, mesh.triangles
    rng = np.random.default_rng(0)
    eps = rng.uniform(1, 3, mesh.num_triangles)
    sig = [rng.uniform(0.5, 1.5, mesh.num_triangles) for _ in range(3)]
    T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    for got, want in zip(th.element_matrices(T(pts), T(tri), T(eps), *map(T, sig)),
                         jh.element_matrices(jnp.asarray(pts), jnp.asarray(tri),
                                             jnp.asarray(eps), *map(jnp.asarray, sig))):
        _close(want, got)
    for got, want in zip(th.assemble_matrices(T(pts), tri, T(eps)),
                         jh.assemble_matrices(jnp.asarray(pts), tri, jnp.asarray(eps))):
        _close(want, got)
    edges = mesh.port_edges(1)
    scale = rng.normal(size=len(edges))
    _close(jh.edge_mass_vals(jnp.asarray(pts), edges, jnp.asarray(scale)),
           th.edge_mass_vals(T(pts), edges, T(scale)))
    _close(jh._boundary_mass(jnp.asarray(pts), edges, mesh.num_points),
           th._boundary_mass(T(pts), edges, mesh.num_points))
    for k2, mode in ((20.0, 1), (3.0, 1), (20.0, 2)):
        _close(jh.port_beta(k2, 1.0, mode), th.port_beta(k2, 1.0, mode, device=CPU))


def test_driven_fn_batched_k0():
    mesh = _ez_mesh()
    fn, _ = th.make_driven_fn(_port(mesh), _tcfg(EZ_CFG), solver="bcr")
    args = th.mesh_tensors(_port(mesh), device=CPU)
    k0s = torch.tensor([4.0, 4.5, 5.2], dtype=torch.float64)
    u, s = fn(*args, k0s)
    jfn, _ = jh.make_driven_fn(mesh, EZ_CFG, solver="bcr")
    jargs = (jnp.asarray(mesh.points), jnp.asarray(mesh.epsilon, jnp.complex128),
             jnp.asarray(mesh.sigma_xx), jnp.asarray(mesh.sigma_yy),
             jnp.asarray(mesh.sigma_xy), jnp.asarray(mesh.excitation, jnp.complex128))
    ju, js = jax.jit(jax.vmap(lambda k: jfn(*jargs, k)))(jnp.asarray(k0s.numpy()))
    _close(ju, u)
    _close(js, s)
    for i, k in enumerate(k0s):
        ui, si = fn(*args, k)
        _close(si.numpy(), s[i])


@pytest.mark.parametrize("solver", ["auto", "sparse", "bcr"])
def test_s21_gradient(solver):
    mesh = _ez_mesh()
    eps0 = np.real(np.asarray(mesh.epsilon)) + 0.3 * np.random.default_rng(1).uniform(
        size=mesh.num_triangles)
    jfn, _ = jh.make_driven_fn(mesh, EZ_CFG, solver=solver)
    rest = (jnp.asarray(mesh.sigma_xx), jnp.asarray(mesh.sigma_yy), jnp.asarray(mesh.sigma_xy),
            jnp.asarray(mesh.excitation, jnp.complex128), jnp.asarray(EZ_CFG.k0))

    def jloss(pts, eps):
        return jnp.abs(jfn(pts, eps, *rest)[1][1, 0]) ** 2

    gp, ge = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(mesh.points),
                                                       jnp.asarray(eps0))
    tfn, _ = th.make_driven_fn(_port(mesh), _tcfg(EZ_CFG), solver=solver)
    pts = torch.tensor(mesh.points, requires_grad=True)
    eps = torch.tensor(eps0, requires_grad=True)
    trest = [torch.tensor(np.asarray(x)) for x in rest]
    (tfn(pts, eps, *trest)[1][1, 0].abs() ** 2).backward()
    _close(gp, pts.grad, 1e-8, "d/d points")
    _close(ge, eps.grad, 1e-8, "d/d eps")


@functools.lru_cache(maxsize=None)
def _cavity():
    return jmesher.mesh_shape(jshape.Rectangle(0, 0, 2.0, 1.0), 0.12, seed=0)


@pytest.mark.parametrize("method", ["arpack", "shift_invert", "lobpcg"])
def test_solve_modes(method):
    mesh = _cavity()
    jv, jvec = jh.solve_modes(mesh, num_modes=4, method=method)
    tv, tvec = th.solve_modes(_port(mesh), num_modes=4, method=method, device=CPU)
    np.testing.assert_allclose(tv, jv, rtol=1e-8, atol=0)
    assert tvec.shape == np.asarray(jvec).shape


def test_schrodinger_and_unknown_method():
    mesh = _cavity()
    V = 3.0 + np.random.default_rng(2).uniform(size=mesh.num_triangles)
    jv, _ = jh.solve_modes(mesh, num_modes=3, potential=V)
    tv, _ = th.solve_modes(_port(mesh), num_modes=3, potential=V, device=CPU)
    np.testing.assert_allclose(tv, jv, rtol=1e-8, atol=0)
    with pytest.raises(ValueError, match="unknown method"):
        th.solve_modes(_port(mesh), num_modes=3, method="eigsh", device=CPU)


def test_fields_and_sweep(tmp_path):
    mesh = _ez_mesh()
    tm = _port(mesh)
    sol = th.solve_driven(tm, _tcfg(EZ_CFG), device=CPU)
    f = sol.field.numpy()
    probes = np.array([[0.5, 0.5], [2.5, 0.3], [5.9, 0.99], [7.0, 0.5]])
    ji, ti = jfields.TriangleIndex(mesh), tfields.TriangleIndex(tm)
    np.testing.assert_array_equal(jfields.get_field(mesh, f, probes, ji),
                                  tfields.get_field(tm, sol.field, probes, ti))
    np.testing.assert_array_equal(jfields.triangle_gradients(mesh, f),
                                  tfields.triangle_gradients(tm, sol.field))
    np.testing.assert_array_equal(jfields.get_field_gradient(mesh, f, probes),
                                  tfields.get_field_gradient(tm, sol.field, probes))
    np.testing.assert_array_equal(jfields.poynting(mesh, f, 4.5),
                                  tfields.poynting(tm, sol.field, 4.5))
    np.testing.assert_array_equal(jfields.mode_cutoff_frequencies([1.0, 9.0], 1e-3),
                                  tfields.mode_cutoff_frequencies([1.0, 9.0], 1e-3))
    freqs = [_freq(k) for k in (4.0, 4.6, 5.1)]
    jf, js = jfields.solve_sweep(mesh, EZ_CFG, freqs)
    tf, ts = tfields.solve_sweep(tm, _tcfg(EZ_CFG), freqs, device=CPU)
    _close(jf, tf)
    for p in js:
        _close(js[p], ts[p])
    times = np.linspace(0, 1e-9, 5)
    _close(jfields.wideband_pulse(jf, freqs, times), tfields.wideband_pulse(tf, freqs, times))
    jfields.export_solution(str(tmp_path / "j.mat"), mesh, f, k0=4.5)
    tfields.export_solution(str(tmp_path / "t.mat"), tm, sol.field, k0=4.5)
    import scipy.io

    a, b = scipy.io.loadmat(str(tmp_path / "j.mat")), scipy.io.loadmat(str(tmp_path / "t.mat"))
    for k in ("p", "t", "boundary_edges", "edge_kind", "edge_port", "epsilon", "field", "k0"):
        np.testing.assert_array_equal(a[k], b[k])


def test_sweep_numerical_ports():
    """A dielectric-loaded port re-plans at each frequency, as in the JAX
    package."""
    mesh, cfg, _ = _loaded_port_case()
    freqs = [_freq(6.5), _freq(7.0)]
    jf, js = jfields.solve_sweep(mesh, cfg, freqs)
    tf, ts = tfields.solve_sweep(_port(mesh), _tcfg(cfg), freqs, device=CPU)
    _close(jf, tf)
    for p in js:
        _close(js[p], ts[p])
