"""Port parity: the FEM tier's geometry stack of `eggshell_tpu_torch` (its
own copies of the JAX package's numpy modules, and `ops.geometry2d` on
tensors) against the JAX package's:

- meshes equal exactly (points, triangles, boundary edges, edge kinds,
  port numbers, values and Robin coefficients, materials) for a
  `Rectangle` with ports, a painted `Circle`, a `Polyline`, a union with a
  hole and `mesh_structured`, and `convert.mesh_from_numpy` of a JAX mesh;
- `ports.order_edge_chain`, `port_eps_profile`, `port_weight_profiles` and
  `transverse_modes`, `metal`, `antenna` and `utils.dxf` results equal;
- `shape.extract_polygons` (the port's marching squares, where the JAX
  package calls contourpy), `Select` and `shape_to_dxf` equal exactly;
- `ops.geometry2d` within 1e-12 (float64).
"""

import dataclasses

import numpy as np
import pytest
import torch

from eggshell_tpu.fem import antenna as jant
from eggshell_tpu.fem import mesher as jmesher
from eggshell_tpu.fem import metal as jmetal
from eggshell_tpu.fem import ports as jports
from eggshell_tpu.fem import shape as jshape
from eggshell_tpu.ops import geometry2d as jgeo
from eggshell_tpu.utils import dxf as jdxf
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.fem import antenna as tant
from eggshell_tpu_torch.fem import mesher as tmesher
from eggshell_tpu_torch.fem import metal as tmetal
from eggshell_tpu_torch.fem import ports as tports
from eggshell_tpu_torch.fem import shape as tshape
from eggshell_tpu_torch.ops import geometry2d as tgeo
from eggshell_tpu_torch.utils import dxf as tdxf
from torch_limits import time_limit  # noqa: F401


def _rect_ports(S):
    cd = S.Rectangle(0.0, 0.0, 2.0, 1.0)
    cd.Port((0.0, 0.0), (0.0, 1.0), 1)
    cd.Port((2.0, 0.0), (2.0, 1.0), 2)
    cd.Paint(S.Rectangle(0.8, 0.0, 1.2, 1.0), epsilon=2.5 - 0.1j)
    return S, cd, 0.15


def _circle(S):
    cd = S.Circle(0.0, 0.0, 1.0)
    th = np.linspace(0, 2 * np.pi, 33)
    for a, b in zip(th[:-1], th[1:]):       # the rim as ABC, chord by chord
        cd.ABC((float(np.cos(a)), float(np.sin(a))), (float(np.cos(b)), float(np.sin(b))),
               tol=0.05)
    cd.Paint(S.Circle(0.0, 0.0, 0.4), epsilon=4.0)
    return S, cd, 0.2


def _polyline(S):
    cd = S.Polyline([(0.0, 0.0), (1.0, 0.0), (1.5, 0.7)], 0.3)
    return S, cd, 0.08


def _csg(S):
    cd = S.Rectangle(0.0, 0.0, 2.0, 1.0) + S.Circle(2.0, 0.5, 0.5)
    cd = cd - S.Circle(0.7, 0.5, 0.2)
    cd.Robin((0.0, 0.0), (2.0, 0.0), 0.3 + 0.2j)
    return S, cd, 0.15


SHAPES = {"rect_ports": _rect_ports, "circle": _circle, "polyline": _polyline, "csg": _csg}


def _assert_mesh_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)


@pytest.fixture(scope="module")
def meshes():
    out = {}
    for name, build in SHAPES.items():
        _, jcd, h = build(jshape)
        _, tcd, _ = build(tshape)
        out[name] = (jmesher.mesh_shape(jcd, h, seed=0), tmesher.mesh_shape(tcd, h, seed=0))
    return out


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_mesh_shape_equal(meshes, name):
    jm, tm = meshes[name]
    assert tm.num_points > 20
    _assert_mesh_equal(jm, tm)


def test_mesh_structured_and_convert():
    W, H = 12.0, 3.0
    built = []
    for S, M in ((jshape, jmesher), (tshape, tmesher)):
        cd = S.Rectangle(-W / 2, -H / 2, W / 2, H / 2)
        cd.Port((-W / 2, -H / 2), (-W / 2, H / 2), 1)
        cd.Port((W / 2, -H / 2), (W / 2, H / 2), 2)
        cd.Paint(S.Rectangle(-W, 0.0, W, H), epsilon=2.2)
        built.append(M.mesh_structured(cd, (-W / 2, -H / 2), (W, 0), (0, H), 0.5,
                                       material_split=0.5))
    _assert_mesh_equal(*built)
    _assert_mesh_equal(built[0], convert.mesh_from_numpy(dataclasses.asdict(built[0])))


def test_ports_equal(meshes):
    jm, tm = meshes["rect_ports"]
    for p in (1, 2):
        jn = jports.order_edge_chain(jm.port_edges(p))
        tn = tports.order_edge_chain(tm.port_edges(p))
        np.testing.assert_array_equal(jn, tn)
        np.testing.assert_array_equal(jports.port_eps_profile(jm, p, jn),
                                      tports.port_eps_profile(tm, p, tn))
        W = [np.asarray(jm.sigma_xx, complex), np.asarray(jm.sigma_yy, complex),
             np.asarray(jm.sigma_xy, complex)]
        for x, y in zip(jports.port_weight_profiles(jm, jn, *W),
                        tports.port_weight_profiles(tm, tn, *W)):
            np.testing.assert_array_equal(x, y)
    t = np.linspace(0.0, 1.3, 17)
    eps = 1.0 + (t > 0.6) * 1.5
    for dirichlet in (True, False):
        a = jports.transverse_modes(t, eps, 40.0 + 0.5j, 3, dirichlet=dirichlet)
        b = tports.transverse_modes(t, eps, 40.0 + 0.5j, 3, dirichlet=dirichlet)
        np.testing.assert_array_equal(a.profiles, b.profiles)
        np.testing.assert_array_equal(a.beta2, b.beta2)
    np.testing.assert_array_equal(jports.analytic_profiles(t, 1.3, 3, True),
                                  tports.analytic_profiles(t, 1.3, 3, True))
    np.testing.assert_array_equal(jports.beta_from_beta2(np.array([4.0, -1.0 + 0.1j])),
                                  tports.beta_from_beta2(np.array([4.0, -1.0 + 0.1j])))


def test_metal_equal():
    from eggshell_tpu.fem.helmholtz import FemConfig

    for kind in ("EZ", "EXY"):
        cfg = FemConfig(type=kind, frequency=75e9, unit=1e-3, depth=1.5494)
        assert jmetal.metal_epsilon(cfg, 5.96e7) == tmetal.metal_epsilon(cfg, 5.96e7)
        assert jmetal.metal_wall_alpha(cfg, 5.96e7) == tmetal.metal_wall_alpha(cfg, 5.96e7)


def test_antenna_equal(meshes):
    jm, tm = meshes["circle"]
    assert (jm.edge_kind == 2).sum() > 20
    rng = np.random.default_rng(0)
    field = rng.normal(size=jm.num_points) + 1j * rng.normal(size=jm.num_points)
    angles = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    a = jant.antenna_pattern(jm, field, 6.0, angles)
    b = tant.antenna_pattern(tm, field, 6.0, angles)
    np.testing.assert_array_equal(a, b)
    assert jant.directivity(a) == tant.directivity(b)
    assert (jant.phase_center(jm, field, 6.0, angles, search_radius=0.3, grid=5)
            == tant.phase_center(tm, field, 6.0, angles, search_radius=0.3, grid=5))


def test_dxf_equal(tmp_path):
    pts = np.array([[np.cos(a), np.sin(a)] for a in np.linspace(0, 2, 12)])
    texts = []
    for mod in (jdxf, tdxf):
        w = mod.DxfWriter()
        w.add_line((0, 0), (1, 2))
        w.add_circle((0.5, 0.5), 0.25)
        w.add_polyline(pts, fit_arcs=True)
        path = tmp_path / f"{mod.__name__}.dxf"
        w.save(str(path))
        texts.append(path.read_text())
    assert texts[0] == texts[1]


_OUTLINES = {
    "rectangle": lambda S: S.Rectangle(0, 0, 2, 1),
    "square_ring": lambda S: S.Rectangle(0, 0, 3, 3) - S.Rectangle(1, 1, 2, 2),
    "circle_with_hole": lambda S: S.Circle(0, 0, 2) - S.Circle(0.3, 0, 0.5),
    "two_islands": lambda S: S.Rectangle(0, 0, 1, 1) + S.Rectangle(2, 0, 3, 1),
    "polygon": lambda S: S.Polygon([(0, 0), (3, 0.5), (2, 2), (0.5, 1.5)]),
    "wire_grid": lambda S: (S.Rectangle(0, 0, 10, 5) - S.Circle(5, 0.86, 0.1)
                            - S.Circle(5, 1.72, 0.1)),
}


@pytest.mark.parametrize("resolution", [32, 256, 512])
@pytest.mark.parametrize("name", sorted(_OUTLINES))
def test_extract_polygons_equal(name, resolution):
    want = jshape.extract_polygons(_OUTLINES[name](jshape), resolution)
    got = tshape.extract_polygons(_OUTLINES[name](tshape), resolution)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_select_and_shape_to_dxf_equal(tmp_path):
    """The WR-10 coupler's Select-addressed ports (examples/alma_coupler.py)
    and a ring's DXF export."""
    def coupler(S):
        cd = S.Rectangle(0, 0, 8, 1.27) + S.Rectangle(0, 1.875, 8, 3.145)
        cd = cd + S.Rectangle(2.0, 0.1, 2.332, 3.045)
        return cd

    for x, y in ((0, 0.635), (0, 2.51), (8, 0.635), (8, 2.51), (2.1, 1.5)):
        a, b = coupler(jshape).Select(x, y), coupler(tshape).Select(x, y)
        assert (a.p1, a.p2) == (b.p1, b.p2)
    texts = []
    for S in (jshape, tshape):
        path = tmp_path / f"{S.__name__}.dxf"
        assert S.shape_to_dxf(_OUTLINES["square_ring"](S), str(path)) == 2
        texts.append(path.read_text())
    assert texts[0] == texts[1]


def _rand(rng, *shape):
    return rng.normal(size=shape)


def test_geometry2d():
    rng = np.random.default_rng(3)
    p, a, b = _rand(rng, 50, 2), _rand(rng, 50, 2), _rand(rng, 50, 2)
    c = _rand(rng, 50, 2)
    verts = np.array([[0.0, 0.0], [2.0, 0.0], [2.5, 1.0], [1.0, 2.0], [-0.5, 1.0]])
    T = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    np.testing.assert_allclose(tgeo.point_segment_distance(T(p), T(a), T(b)).numpy(),
                               np.asarray(jgeo.point_segment_distance(p, a, b)),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tgeo.segments_intersect(T(p), T(a), T(b), T(c)).numpy(),
                                  np.asarray(jgeo.segments_intersect(p, a, b, c)))
    np.testing.assert_allclose(tgeo.polygon_area(T(verts)).numpy(),
                               np.asarray(jgeo.polygon_area(verts)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tgeo.polygon_centroid(T(verts)).numpy(),
                               np.asarray(jgeo.polygon_centroid(verts)), rtol=0, atol=1e-12)
    q = rng.uniform(-1, 3, size=(200, 2))
    np.testing.assert_array_equal(tgeo.point_in_polygon(T(q), T(verts)).numpy(),
                                  np.asarray(jgeo.point_in_polygon(q, verts)))
    batched = np.stack([verts, verts * 2.0])
    np.testing.assert_allclose(tgeo.polygon_area(T(batched)).numpy(),
                               np.asarray(jgeo.polygon_area(batched)), rtol=0, atol=1e-12)
