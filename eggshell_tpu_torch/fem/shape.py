"""2D CSG geometry — the rama Shape equivalent (rama/shape.h:26-90).

The reference builds polygon sets with Clipper boolean ops and carries
per-edge EdgeInfo (port numbers / absorbing boundaries) and per-piece
Material (complex epsilon).  This build represents a Shape as a signed-
distance CSG tree (exact SDFs for primitives, min/max combinators),
which the distmesh-style mesher consumes directly; boundary conditions
are painted onto boundary *segments* (Port/ABC) and materials onto
region predicates (Paint), then resolved per mesh edge / triangle.

API nouns follow the reference's Lua surface (rama/shape.h:31-44,
rama/user_script_util.lua:124-292): Rectangle, Circle, Polygon,
`a + b` (union), `a - b` (difference), `a & b` (intersection),
`shape.Port(p1, p2, n)`, `shape.ABC(p1, p2)`, `shape.Paint(region,
epsilon)`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

Array = np.ndarray


# ---------------------------------------------------------------------------
# Signed distance primitives (negative inside)


class _SDF:
    def __call__(self, pts: Array) -> Array:
        raise NotImplementedError


@dataclasses.dataclass
class _RectSDF(_SDF):
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    def __call__(self, pts):
        # exact box SDF
        cx = (self.xmin + self.xmax) / 2
        cy = (self.ymin + self.ymax) / 2
        hx = (self.xmax - self.xmin) / 2
        hy = (self.ymax - self.ymin) / 2
        qx = np.abs(pts[:, 0] - cx) - hx
        qy = np.abs(pts[:, 1] - cy) - hy
        outside = np.hypot(np.maximum(qx, 0), np.maximum(qy, 0))
        inside = np.minimum(np.maximum(qx, qy), 0)
        return outside + inside


@dataclasses.dataclass
class _CircleSDF(_SDF):
    cx: float
    cy: float
    r: float

    def __call__(self, pts):
        return np.hypot(pts[:, 0] - self.cx, pts[:, 1] - self.cy) - self.r


@dataclasses.dataclass
class _PolySDF(_SDF):
    verts: Array  # (n, 2) CCW

    def __call__(self, pts):
        v = self.verts
        n = len(v)
        d = np.full(len(pts), np.inf)
        sign = np.ones(len(pts))
        px, py = pts[:, 0], pts[:, 1]
        inside = np.zeros(len(pts), dtype=bool)
        for i in range(n):
            a = v[i]
            b = v[(i + 1) % n]
            e = b - a
            w = pts - a[None, :]
            t = np.clip((w @ e) / (e @ e), 0.0, 1.0)
            proj = a[None, :] + t[:, None] * e[None, :]
            d = np.minimum(d, np.hypot(px - proj[:, 0], py - proj[:, 1]))
            # even-odd crossing
            cond = (a[1] <= py) != (b[1] <= py)
            xi = a[0] + (py - a[1]) / (b[1] - a[1] + 1e-300) * (b[0] - a[0])
            inside ^= cond & (px < xi)
        return np.where(inside, -d, d)


@dataclasses.dataclass
class _UnionSDF(_SDF):
    a: _SDF
    b: _SDF

    def __call__(self, pts):
        return np.minimum(self.a(pts), self.b(pts))


@dataclasses.dataclass
class _IntersectSDF(_SDF):
    a: _SDF
    b: _SDF

    def __call__(self, pts):
        return np.maximum(self.a(pts), self.b(pts))


@dataclasses.dataclass
class _DiffSDF(_SDF):
    a: _SDF
    b: _SDF

    def __call__(self, pts):
        return np.maximum(self.a(pts), -self.b(pts))


@dataclasses.dataclass
class _PolylineSDF(_SDF):
    """Stroked open polyline: distance to the centerline chain minus the
    half-width — the analog of the reference's MakePolyline + Grow
    stroking used to lay out curved guides (rama/shape.h:26-44,
    examples/waveguide_bend.lua:33-43).  Exact SDF (capsule chain), so
    joints are automatically rounded like Clipper's round-join grow."""

    verts: Array        # (n, 2) open chain
    half_width: float

    def __call__(self, pts):
        v = self.verts
        d = np.full(len(pts), np.inf)
        for i in range(len(v) - 1):
            a, b = v[i], v[i + 1]
            e = b - a
            w = pts - a[None, :]
            t = np.clip((w @ e) / max(float(e @ e), 1e-300), 0.0, 1.0)
            proj = a[None, :] + t[:, None] * e[None, :]
            d = np.minimum(
                d, np.hypot(pts[:, 0] - proj[:, 0], pts[:, 1] - proj[:, 1])
            )
        return d - self.half_width


@dataclasses.dataclass
class _ScaleSDF(_SDF):
    """Anisotropically scaled shape (ref Shape:Scale, used by
    examples/waveguide_modes.lua for elliptic guides).  The returned
    value is a conservative distance bound (exact zero level set; the
    magnitude is scaled by min|s|), which is all the mesher needs."""

    a: _SDF
    sx: float
    sy: float

    def __call__(self, pts):
        q = np.stack([pts[:, 0] / self.sx, pts[:, 1] / self.sy], 1)
        return self.a(q) * min(abs(self.sx), abs(self.sy))


@dataclasses.dataclass
class _OffsetSDF(_SDF):
    """Minkowski grow (d > 0) / shrink (d < 0) by |d| — the analog of the
    reference's Clipper polygon offsetting (rama/shape.h:26-44 Offset,
    ClipperOffset paths).  Exact for primitive SDFs; a conservative bound
    near concave corners of CSG combinations (where min/max SDFs
    under-estimate distance)."""

    a: _SDF
    d: float

    def __call__(self, pts):
        return self.a(pts) - self.d


# ---------------------------------------------------------------------------
# Boundary painting + materials


@dataclasses.dataclass
class BoundarySegment:
    """A painted boundary segment: mesh boundary edges whose midpoints lie
    within `tol` of the segment get this attribute
    (EdgeInfo analog, ref rama/edge_type.h)."""

    p1: Tuple[float, float]
    p2: Tuple[float, float]
    kind: str   # "port" | "abc" | "potential" | "robin" | "pec" (default)
    port_number: int = 0
    tol: float = 1e-6
    value: float = 0.0   # fixed potential for kind == "potential"
    alpha: complex = 0.0  # Robin coefficient for kind == "robin"
                          # (dimensionless; the solver multiplies by the
                          # local k — ref rama/solver.cc:155-158)


@dataclasses.dataclass
class EdgeSelection:
    """A selected straight boundary piece, as returned by Shape.Select —
    the analog of the reference's Lua `shape:Select(x, y)` edge
    selections (rama/shape.h:26-44), accepted by Port/ABC/Robin/
    Potential in place of explicit endpoints."""

    p1: Tuple[float, float]
    p2: Tuple[float, float]


@dataclasses.dataclass
class MaterialRegion:
    """Painted material: triangles whose centroid is inside `region` get
    this (complex) epsilon (Material analog, ref rama/shape.h:64-90)."""

    region: "Shape"
    epsilon: complex = 1.0
    sigma_xx: float = 1.0   # anisotropic weights for TE/TM-style problems
    sigma_yy: float = 1.0
    sigma_xy: float = 0.0   # cross term (ref rama/shape.h:64-90 sigma_xy)
    excitation: complex = 0.0  # volume source density (ref Material excitation)


class Shape:
    """CSG shape with painted boundaries and materials."""

    def __init__(self, sdf: _SDF, fixed_points: Sequence = (),
                 bbox: Optional[Tuple[float, float, float, float]] = None):
        self.sdf = sdf
        self.fixed_points: List[Tuple[float, float]] = list(fixed_points)
        self.bbox = bbox  # (xmin, ymin, xmax, ymax)
        self.boundaries: List[BoundarySegment] = []
        self.materials: List[MaterialRegion] = []

    # ---- CSG (ref rama/shape.h operator+/-/& via Clipper) ----
    def __add__(self, other: "Shape") -> "Shape":
        s = Shape(
            _UnionSDF(self.sdf, other.sdf),
            self.fixed_points + other.fixed_points,
            _bbox_union(self.bbox, other.bbox),
        )
        s.boundaries = self.boundaries + other.boundaries
        s.materials = self.materials + other.materials
        return s

    def __sub__(self, other: "Shape") -> "Shape":
        s = Shape(
            _DiffSDF(self.sdf, other.sdf),
            self.fixed_points + other.fixed_points,
            self.bbox,
        )
        s.boundaries = self.boundaries + other.boundaries
        s.materials = self.materials
        return s

    def __and__(self, other: "Shape") -> "Shape":
        s = Shape(
            _IntersectSDF(self.sdf, other.sdf),
            self.fixed_points + other.fixed_points,
            _bbox_intersect(self.bbox, other.bbox),
        )
        s.boundaries = self.boundaries + other.boundaries
        s.materials = self.materials + other.materials
        return s

    # ---- painting ----
    def Port(self, p1, p2, port_number: Optional[int] = None,
             tol: float = 1e-6) -> "Shape":
        """Mark the boundary segment p1-p2 (or Port(selection, n)) as
        port `port_number` (ref rama/shape.h Port,
        user_script_util.lua:232-292)."""
        if isinstance(p1, EdgeSelection):
            p1, p2, port_number = p1.p1, p1.p2, int(p2)
        assert port_number is not None
        self.boundaries.append(
            BoundarySegment(tuple(p1), tuple(p2), "port", port_number, tol)
        )
        self.fixed_points += [tuple(p1), tuple(p2)]
        return self

    def ABC(self, p1, p2=None, tol: float = 1e-6) -> "Shape":
        """Absorbing (first-order Robin) boundary segment; also accepts
        ABC(selection)."""
        if isinstance(p1, EdgeSelection):
            p1, p2 = p1.p1, p1.p2
        self.boundaries.append(
            BoundarySegment(tuple(p1), tuple(p2), "abc", 0, tol)
        )
        self.fixed_points += [tuple(p1), tuple(p2)]
        return self

    def Robin(self, p1, p2, alpha: Optional[complex] = None,
              tol: float = 1e-6) -> "Shape":
        """Custom Robin boundary on the segment p1-p2 (or
        Robin(selection, alpha)):  du/dn + alpha * k_local * u = 0 with
        complex dimensionless `alpha` (the reference's port-callback
        boundary parameters, rama/solver.cc:155-158) — lossy conductor
        walls via fem.metal.metal_wall_alpha."""
        if isinstance(p1, EdgeSelection):
            p1, p2, alpha = p1.p1, p1.p2, complex(p2)
        assert alpha is not None
        self.boundaries.append(
            BoundarySegment(tuple(p1), tuple(p2), "robin", 0, tol,
                            alpha=complex(alpha))
        )
        self.fixed_points += [tuple(p1), tuple(p2)]
        return self

    def Potential(self, p1, p2, value: Optional[float] = None,
                  tol: float = 1e-6) -> "Shape":
        """Fix the boundary segment p1-p2 (or Potential(selection, v))
        at a given electrostatic potential (conductor at `value` volts —
        the ES problem type's boundary condition, ref rama/solver.h
        ELECTROSTATICS + capacitor_electrostatics.lua example)."""
        if isinstance(p1, EdgeSelection):
            p1, p2, value = p1.p1, p1.p2, float(p2)
        assert value is not None
        self.boundaries.append(
            BoundarySegment(tuple(p1), tuple(p2), "potential", 0, tol,
                            value=value)
        )
        self.fixed_points += [tuple(p1), tuple(p2)]
        return self

    # ---- derived shapes ----
    def Offset(self, distance: float) -> "Shape":
        """Grow (distance > 0) or shrink (< 0) the shape by |distance| —
        the reference's Clipper offsetting verb (rama/shape.h:26-44).
        Painted boundaries/materials do not carry over (the offset
        boundary is new geometry); the bbox is inflated accordingly."""
        b = self.bbox
        d = float(distance)
        bbox = None if b is None else (
            b[0] - max(d, 0), b[1] - max(d, 0),
            b[2] + max(d, 0), b[3] + max(d, 0),
        )
        return Shape(_OffsetSDF(self.sdf, d), [], bbox)

    def Scale(self, sx: float, sy: float = None) -> "Shape":
        """Scale the shape about the origin (ref Shape:Scale —
        examples/waveguide_modes.lua uses Circle():Scale(1, K) for
        elliptic guides).  Painted boundaries/materials do not carry
        over (they address old coordinates) — Scale BEFORE Paint/Port."""
        if self.boundaries or self.materials:
            raise ValueError(
                "Shape.Scale drops painted regions and port/boundary "
                "markings (they address pre-scale coordinates): apply "
                "Scale before Paint/Port/ABC."
            )
        sy = sx if sy is None else sy
        b = self.bbox
        bbox = None if b is None else tuple(sorted([b[0] * sx, b[2] * sx]) +
                                            sorted([b[1] * sy, b[3] * sy]))
        if bbox is not None:
            bbox = (bbox[0], bbox[2], bbox[1], bbox[3])
        fixed = [(x * sx, y * sy) for x, y in self.fixed_points]
        return Shape(_ScaleSDF(self.sdf, float(sx), float(sy)), fixed, bbox)

    def Paint(self, region: "Shape", epsilon: complex = 1.0,
              sigma_xx: float = 1.0, sigma_yy: float = 1.0,
              sigma_xy: float = 0.0, excitation: complex = 0.0) -> "Shape":
        """Paint a material onto a sub-region (ref __Paint__,
        rama/user_script_util.lua:124-230)."""
        self.materials.append(
            MaterialRegion(region, epsilon, sigma_xx, sigma_yy, sigma_xy,
                           excitation)
        )
        return self

    # ---- queries ----
    def distance(self, pts: Array) -> Array:
        return self.sdf(np.atleast_2d(np.asarray(pts, float)))

    def contains(self, pts: Array) -> Array:
        return self.distance(pts) < 0

    def polygons(self, resolution: int = 256,
                 simplify_tol: float = None) -> List[Array]:
        """Extract the boundary as closed polygons (the reference keeps
        shapes AS polygon sets via Clipper, rama/shape.h; here they are
        recovered from the SDF zero level set).  Returns a list of
        (n, 2) closed loops (last vertex != first; implicitly closed),
        collinear-simplified so straight sides come back as single
        segments."""
        return extract_polygons(self, resolution, simplify_tol)

    def Select(self, x: float, y: float,
               resolution: int = 256) -> EdgeSelection:
        """Select the maximal straight boundary piece nearest to (x, y)
        — the reference's `shape:Select(x, y)` verb (rama/shape.h:26-44),
        used to address ports/boundary paint without retyping
        coordinates.  Returns an EdgeSelection accepted by
        Port/ABC/Robin/Potential."""
        polys = self.polygons(resolution)
        best = None
        q = np.asarray([x, y], float)
        for poly in polys:
            n = len(poly)
            for i in range(n):
                a = poly[i]
                b = poly[(i + 1) % n]
                e = b - a
                L2 = float(e @ e)
                t = float(np.clip(((q - a) @ e) / max(L2, 1e-300), 0, 1))
                proj = a + t * e
                d = float(np.hypot(*(q - proj)))
                if best is None or d < best[0]:
                    best = (d, poly, i)
        if best is None:
            raise ValueError("shape has no extractable boundary")
        _, poly, i = best
        n = len(poly)

        def direction(j):
            e = poly[(j + 1) % n] - poly[j]
            return e / max(np.hypot(*e), 1e-300)

        d0 = direction(i)
        # walk backward/forward while collinear (straight polygon piece)
        j0 = i
        while True:
            jp = (j0 - 1) % n
            if jp == i or abs(np.cross(direction(jp), d0)) > 1e-6:
                break
            j0 = jp
        j1 = i
        while True:
            jn = (j1 + 1) % n
            if jn == j0 or abs(np.cross(direction(jn % n), d0)) > 1e-6:
                break
            j1 = jn
        p1 = tuple(poly[j0])
        p2 = tuple(poly[(j1 + 1) % n])
        return EdgeSelection(p1, p2)


def _bbox_union(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3]))


def _bbox_intersect(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return (max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3]))


def Rectangle(xmin: float, ymin: float, xmax: float, ymax: float) -> Shape:
    """Axis-aligned rectangle (ref Rectangle(),
    rama/user_script_util.lua / shape.cc)."""
    fixed = [(xmin, ymin), (xmax, ymin), (xmax, ymax), (xmin, ymax)]
    return Shape(
        _RectSDF(xmin, ymin, xmax, ymax), fixed, (xmin, ymin, xmax, ymax)
    )


def Circle(cx: float, cy: float, r: float, npoints: int = 0) -> Shape:
    """Circle; npoints is accepted for reference-API compatibility (the
    SDF is exact — the mesher resolves the boundary)."""
    return Shape(
        _CircleSDF(cx, cy, r), [], (cx - r, cy - r, cx + r, cy + r)
    )


def Polyline(vertices, width: float) -> Shape:
    """Stroke an open centerline into a guide of the given width — the
    reference's Shape():AddPoint(...):MakePolyline() followed by
    Grow(width/2) (rama/examples/waveguide_bend.lua:33-43).  Endpoints
    become flat-capped only after Ports trim them; the raw stroke has
    round caps (capsule chain), so feed lines should extend half a width
    past where a flat end is needed, or intersect with a Rectangle."""
    v = np.asarray(vertices, float)
    hw = float(width) / 2.0
    bbox = (v[:, 0].min() - hw, v[:, 1].min() - hw,
            v[:, 0].max() + hw, v[:, 1].max() + hw)
    return Shape(_PolylineSDF(v, hw), [], bbox)


def Polygon(vertices) -> Shape:
    v = np.asarray(vertices, float)
    bbox = (v[:, 0].min(), v[:, 1].min(), v[:, 0].max(), v[:, 1].max())
    return Shape(_PolySDF(v), [tuple(p) for p in v], bbox)


# ---------------------------------------------------------------------------
# Polygon extraction / export (ref rama keeps polygon sets natively via
# Clipper; here they are recovered from the SDF zero level set)


def _dp_open(pts: Array, tol: float, keep_mask: np.ndarray, off: int):
    """Douglas-Peucker on an open chain pts (marks kept indices in
    keep_mask at offset off); iterative stack, max-deviation guarantee."""
    stack = [(0, len(pts) - 1)]
    while stack:
        i, j = stack.pop()
        if j <= i + 1:
            continue
        a = pts[i]
        b = pts[j]
        e = b - a
        L = np.hypot(*e)
        seg = pts[i + 1:j]
        if L < 1e-300:
            d = np.hypot(seg[:, 0] - a[0], seg[:, 1] - a[1])
        else:
            d = np.abs(
                e[0] * (seg[:, 1] - a[1]) - e[1] * (seg[:, 0] - a[0])
            ) / L
        k = int(np.argmax(d))
        if d[k] > tol:
            m = i + 1 + k
            keep_mask[off + m] = True
            stack.append((i, m))
            stack.append((m, j))


def _simplify_collinear(poly: Array, tol: float) -> Array:
    """Simplify a closed ring with max-deviation tol (Douglas-Peucker):
    straight runs collapse to single segments; curves keep enough
    vertices that the polyline stays within tol of the samples."""
    poly = np.asarray(poly, float)
    n = len(poly)
    if n < 4:
        return poly
    # anchor the ring at two extreme points (guaranteed on the hull)
    i0 = int(np.argmin(poly[:, 0] + poly[:, 1]))
    rolled = np.roll(poly, -i0, axis=0)
    i1 = int(np.argmax(
        np.hypot(rolled[:, 0] - rolled[0, 0], rolled[:, 1] - rolled[0, 1])
    ))
    keep = np.zeros(n + 1, bool)
    keep[0] = keep[i1] = keep[n] = True     # n is the wrapped copy of 0
    closed = np.concatenate([rolled, rolled[:1]])
    _dp_open(closed[: i1 + 1], tol, keep, 0)
    _dp_open(closed[i1:], tol, keep, i1)
    return closed[:-1][keep[:-1]]


# Marching squares on a cell whose corners above the level are given by
# the bits BL 1, BR 2, TR 4, TL 8: the directed segments between the edge
# crossings B (bottom), R (right), T (top) and L (left), the side above
# the level on the left.  Saddles (5, 10) take the middle value's side:
# (segments when the middle is above, segments when it is below).
_SEGMENTS = {1: (("B", "L"),), 2: (("R", "B"),), 3: (("R", "L"),), 4: (("T", "R"),),
             6: (("T", "B"),), 7: (("T", "L"),), 8: (("L", "T"),), 9: (("B", "T"),),
             11: (("R", "T"),), 12: (("L", "R"),), 13: (("B", "R"),), 14: (("L", "B"),)}
_SADDLES = {5: ((("B", "R"), ("T", "L")), (("B", "L"), ("T", "R"))),
            10: ((("L", "B"), ("R", "T")), (("R", "B"), ("L", "T")))}


def zero_level_rings(X: Array, Y: Array, Z: Array) -> List[Array]:
    """The closed rings of Z's zero level set on the grid (X, Y) (a
    meshgrid, rows along y), by marching squares with linear
    interpolation along the cell edges: each ring (n, 2) without its
    closing point, the side where Z > 0 on its left (outer boundaries of
    the region Z <= 0 clockwise, holes counter-clockwise), the rings, their
    starting points and their rounding as contourpy's serial generator
    gives them (the JAX package's `extract_polygons` calls it).  A
    crossing lies on one edge of two cells, so every ring closes where
    Z > 0 all along the grid's rim."""
    ny, nx = Z.shape
    above = Z > 0
    nh = ny * (nx - 1)                       # crossing ids: horizontal edges, then vertical

    def h_id(j, i):
        return j * (nx - 1) + i

    def v_id(j, i):
        return nh + j * nx + i

    case = (above[:-1, :-1] * 1 + above[:-1, 1:] * 2 + above[1:, 1:] * 4
            + above[1:, :-1] * 8)
    middle = (Z[:-1, :-1] + Z[:-1, 1:] + Z[1:, 1:] + Z[1:, :-1]) > 0
    edge = {"B": lambda j, i: h_id(j, i), "T": lambda j, i: h_id(j + 1, i),
            "L": lambda j, i: v_id(j, i), "R": lambda j, i: v_id(j, i + 1)}
    nxt = np.full(nh + ny * nx, -1, np.int64)
    starts = []                              # (cell, start crossing) of every segment

    def emit(mask, segments):
        j, i = np.nonzero(mask)
        for a, b in segments:
            nxt[edge[a](j, i)] = edge[b](j, i)
            starts.append(np.stack([j * (nx - 1) + i, edge[a](j, i)], 1))

    for c, segments in _SEGMENTS.items():
        emit(case == c, segments)
    for c, (when_above, when_below) in _SADDLES.items():
        emit((case == c) & middle, when_above)
        emit((case == c) & ~middle, when_below)

    def point(k):
        if k < nh:
            j, i = divmod(k, nx - 1)
            j1, i1 = j, i + 1
        else:
            j, i = divmod(k - nh, nx)
            j1, i1 = j + 1, i
        if not above[j, i]:                  # contourpy's rounding: from the corner above
            j, i, j1, i1 = j1, i1, j, i
        f = Z[j1, i1] / (Z[j1, i1] - Z[j, i])
        return (X[j, i] * f + X[j1, i1] * (1.0 - f), Y[j, i] * f + Y[j1, i1] * (1.0 - f))

    # a ring starts at the first segment of the first cell, row by row,
    # that no ring has taken yet, as contourpy's traversal starts
    order = np.concatenate(starts) if starts else np.zeros((0, 2), np.int64)
    order = order[np.argsort(order[:, 0], kind="stable"), 1]
    rings, taken = [], np.zeros(len(nxt), bool)
    for start in order.tolist():
        if taken[start]:
            continue
        ring, k = [], start
        while not taken[k]:
            taken[k] = True
            ring.append(point(k))
            k = int(nxt[k])
        if k == start:
            rings.append(np.asarray(ring, float))
    return rings


def extract_polygons(shape: Shape, resolution: int = 256,
                     simplify_tol: float = None) -> List[Array]:
    """Trace the zero level set of the shape's SDF into closed polygons
    (marching squares over the padded bbox, `zero_level_rings`, where the
    JAX package calls contourpy, which the card's machine lacks), then
    collapse collinear vertices so straight sides come back as single
    edges.

    The reference's Shape IS a polygon set (Clipper paths,
    rama/shape.h); this is the export/Select-facing equivalent view of
    the SDF-CSG representation."""
    assert shape.bbox is not None, "shape must carry a bounding box"
    xmin, ymin, xmax, ymax = shape.bbox
    pad = 0.05 * max(xmax - xmin, ymax - ymin) + 1e-9
    xs = np.linspace(xmin - pad, xmax + pad, resolution)
    ys = np.linspace(ymin - pad, ymax + pad, resolution)
    X, Y = np.meshgrid(xs, ys)
    Z = shape.distance(np.stack([X.ravel(), Y.ravel()], 1)).reshape(X.shape)
    if simplify_tol is None:
        # half a grid cell: marching squares chamfers sharp corners at
        # sub-cell scale; this tolerance absorbs the chamfer so straight
        # sides meet in single vertices, while curves stay within half a
        # cell of the samples
        simplify_tol = 0.5 * max(xs[1] - xs[0], ys[1] - ys[0])
    polys = []
    for line in zero_level_rings(X, Y, Z):
        if len(line) < 3:
            continue
        poly = _simplify_collinear(line, simplify_tol)
        if len(poly) >= 3:
            polys.append(poly)
    return polys


def shape_to_dxf(shape: Shape, path: str, resolution: int = 512,
                 layer: str = "0") -> int:
    """Export the shape boundary as closed DXF polylines (the
    reference's CAD-exchange role, toolkit/dxf.h).  Returns the number
    of polylines written."""
    from eggshell_tpu_torch.utils.dxf import DxfWriter

    polys = extract_polygons(shape, resolution)
    w = DxfWriter()
    for poly in polys:
        w.add_polyline([tuple(p) for p in poly], closed=True, layer=layer)
    w.save(path)
    return len(polys)
