"""2D DXF (R12) export with arc fitting — toolkit/dxf.{h,cc} equivalent.

`DxfWriter` emits LINE / CIRCLE / ARC / POLYLINE entities; `fit_arc`
least-squares fits a circle to a point run (the reference's arc-fitting
pass converts dense polylines into arcs for CAD export).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


class DxfWriter:
    def __init__(self):
        self._ent: List[str] = []

    def _e(self, *pairs):
        for code, val in pairs:
            self._ent.append(str(code))
            self._ent.append(str(val))

    def add_line(self, p1, p2, layer: str = "0"):
        self._e((0, "LINE"), (8, layer),
                (10, p1[0]), (20, p1[1]), (11, p2[0]), (21, p2[1]))

    def add_circle(self, center, radius, layer: str = "0"):
        self._e((0, "CIRCLE"), (8, layer),
                (10, center[0]), (20, center[1]), (40, radius))

    def add_arc(self, center, radius, a0_deg, a1_deg, layer: str = "0"):
        self._e((0, "ARC"), (8, layer),
                (10, center[0]), (20, center[1]), (40, radius),
                (50, a0_deg), (51, a1_deg))

    def add_polyline(self, points: Sequence, closed: bool = False,
                     layer: str = "0", fit_arcs: bool = False,
                     arc_tol: float = 1e-4):
        pts = [tuple(p) for p in points]
        if fit_arcs:
            for seg in fit_polyline(np.asarray(pts, float), arc_tol):
                if seg[0] == "arc":
                    _, c, r, a0, a1 = seg
                    self.add_arc(c, r, math.degrees(a0), math.degrees(a1),
                                 layer)
                else:
                    _, p1, p2 = seg
                    self.add_line(p1, p2, layer)
            if closed:
                self.add_line(pts[-1], pts[0], layer)
            return
        self._e((0, "POLYLINE"), (8, layer), (66, 1), (70, 1 if closed else 0))
        for p in pts:
            self._e((0, "VERTEX"), (8, layer), (10, p[0]), (20, p[1]))
        self._e((0, "SEQEND"))

    def tostring(self) -> str:
        out = ["0", "SECTION", "2", "ENTITIES"]
        out += self._ent
        out += ["0", "ENDSEC", "0", "EOF"]
        return "\n".join(out) + "\n"

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.tostring())


def fit_arc(points: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Least-squares circle fit (Kasa).  Returns (center, radius,
    max_residual)."""
    p = np.asarray(points, float)
    x, y = p[:, 0], p[:, 1]
    A = np.stack([2 * x, 2 * y, np.ones_like(x)], axis=1)
    bb = x * x + y * y
    sol, *_ = np.linalg.lstsq(A, bb, rcond=None)
    cx, cy, c = sol
    r = math.sqrt(max(c + cx * cx + cy * cy, 0.0))
    resid = np.abs(np.hypot(x - cx, y - cy) - r).max()
    return np.array([cx, cy]), r, float(resid)


def fit_polyline(points: np.ndarray, tol: float = 1e-4) -> List:
    """Greedy decomposition of a polyline into arcs and line segments:
    grow a window while the circle fit residual stays below tol."""
    out = []
    n = len(points)
    i = 0
    while i < n - 1:
        # try to grow an arc from i
        j = i + 2
        best = None
        while j < n:
            c, r, resid = fit_arc(points[i : j + 1])
            if resid > tol:
                break
            best = (c, r, j)
            j += 1
        if best is not None and best[2] >= i + 3:
            c, r, j_end = best
            a0 = math.atan2(points[i][1] - c[1], points[i][0] - c[0])
            a1 = math.atan2(points[j_end][1] - c[1], points[j_end][0] - c[0])
            out.append(("arc", tuple(c), r, a0, a1))
            i = j_end
        else:
            out.append(("line", tuple(points[i]), tuple(points[i + 1])))
            i += 1
    return out
