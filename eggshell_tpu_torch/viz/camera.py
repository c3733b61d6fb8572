"""Quaternion camera + geometric object picking — the interactive-3D
tier of the reference viewer (ref toolkit/camera.h:16-28 quaternion
perspective/orthographic camera with pan/zoom/rotate; toolkit/
viewer.h:16-30 GLViewer mouse bindings; color_based_selection.h:18-24
object picking).

The reference picks objects by rendering color IDs to an off-screen GL
buffer and reading the pixel back.  There is no GL stack in a headless
deployment, so picking here is *geometric*: unproject the click to
a world-space ray and intersect it with every body's oriented box
(a vectorized slab test over the whole SoA state — the array-first
analog of a per-object ID render).  Same capability, exactly testable,
no GPU required.

All math is plain NumPy on host — the camera never touches device
arrays (the viewer pulls state to host once per frame anyway).

A copy of `eggshell_tpu.viz.camera` (NumPy).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else v


@dataclass
class Camera:
    """Orbit camera: a target point, a distance, and yaw/pitch angles
    (degrees, matching matplotlib's azim/elev so the viewer can keep a
    matplotlib Axes3D in sync).  Provides the reference camera's verbs
    (ref toolkit/camera.h:16-28): Orbit (Rotate), Pan, Zoom, and the
    projection/unprojection pair PixelToModelRay / ModelToPixel that
    picking and annotation need (ref gl_utils.h project/unproject).
    """

    target: np.ndarray = field(
        default_factory=lambda: np.zeros(3, dtype=float))
    distance: float = 5.0
    azim: float = -60.0          # yaw about +z, degrees
    elev: float = 20.0           # pitch above the xy-plane, degrees
    fov_deg: float = 40.0        # vertical field of view (perspective)
    ortho: bool = False          # orthographic mode (ref camera.h persp/ortho)

    # ---- pose -------------------------------------------------------
    def forward(self) -> np.ndarray:
        """Unit vector from the eye toward the target."""
        az = np.deg2rad(self.azim)
        el = np.deg2rad(self.elev)
        # eye sits at target + distance * (cos el cos az, cos el sin az, sin el)
        return -np.array([
            np.cos(el) * np.cos(az),
            np.cos(el) * np.sin(az),
            np.sin(el),
        ])

    def eye(self) -> np.ndarray:
        return self.target - self.distance * self.forward()

    def basis(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Right-handed (right, up, forward) camera frame."""
        f = self.forward()
        world_up = np.array([0.0, 0.0, 1.0])
        r = _normalize(np.cross(f, world_up))
        if np.linalg.norm(np.cross(f, world_up)) < 1e-9:   # looking straight down/up
            r = np.array([1.0, 0.0, 0.0])
        u = np.cross(r, f)
        return r, u, f

    # ---- the reference camera verbs ---------------------------------
    def orbit(self, dazim: float, delev: float) -> None:
        """Rotate the eye about the target (ref viewer.h rotate drag).
        Pitch is clamped just short of the poles so the up vector never
        degenerates."""
        self.azim = (self.azim + dazim + 180.0) % 360.0 - 180.0
        self.elev = float(np.clip(self.elev + delev, -89.0, 89.0))

    def pan(self, dx: float, dy: float) -> None:
        """Translate the target in the view plane by (dx, dy) world
        units along the camera's right/up axes (ref viewer.h pan drag)."""
        r, u, _ = self.basis()
        self.target = self.target + dx * r + dy * u

    def zoom(self, factor: float) -> None:
        """Scale the orbit distance; factor < 1 zooms in (ref viewer.h
        wheel zoom).  Distance is floored to keep the eye off the
        target."""
        self.distance = max(1e-3, self.distance * float(factor))

    # ---- projection / unprojection ----------------------------------
    def pixel_to_ray(self, x: float, y: float, width: int,
                     height: int) -> tuple[np.ndarray, np.ndarray]:
        """Unproject a pixel to a world-space ray (origin, unit dir).
        Pixel origin is the LOWER-left corner (matplotlib event.x/y
        convention).  Perspective: rays fan out from the eye;
        orthographic: parallel rays offset in the view plane."""
        r, u, f = self.basis()
        aspect = width / max(1, height)
        # normalized device coords in [-1, 1]
        ndc_x = 2.0 * x / max(1, width) - 1.0
        ndc_y = 2.0 * y / max(1, height) - 1.0
        half_h = np.tan(np.deg2rad(self.fov_deg) / 2.0)
        if self.ortho:
            # view-plane half-height at the target distance
            hh = self.distance * half_h
            origin = (self.eye() + ndc_x * aspect * hh * r
                      + ndc_y * hh * u)
            return origin, f.copy()
        d = _normalize(f + ndc_x * aspect * half_h * r
                       + ndc_y * half_h * u)
        return self.eye(), d

    def project(self, points: np.ndarray, width: int,
                height: int) -> np.ndarray:
        """World points (n, 3) -> pixel coords (n, 2), lower-left
        origin.  Points behind the eye get NaN."""
        pts = np.atleast_2d(points).astype(float)
        r, u, f = self.basis()
        rel = pts - self.eye()
        zc = rel @ f                       # depth along view axis
        xc = rel @ r
        yc = rel @ u
        aspect = width / max(1, height)
        half_h = np.tan(np.deg2rad(self.fov_deg) / 2.0)
        if self.ortho:
            hh = self.distance * half_h
            ndc_x = xc / (aspect * hh)
            ndc_y = yc / hh
            behind = np.zeros_like(zc, dtype=bool)
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                ndc_x = xc / (zc * aspect * half_h)
                ndc_y = yc / (zc * half_h)
            behind = zc <= 1e-9
        px = (ndc_x + 1.0) * 0.5 * width
        py = (ndc_y + 1.0) * 0.5 * height
        out = np.stack([px, py], axis=-1)
        out[behind] = np.nan
        return out


# ---- geometric picking (color_based_selection analog) ---------------

def ray_obb_distances(origin: np.ndarray, direction: np.ndarray,
                      p: np.ndarray, R: np.ndarray,
                      h: np.ndarray) -> np.ndarray:
    """Slab-test a single ray against n oriented boxes at once.

    origin/direction: (3,) world ray (direction need not be unit);
    p: (n, 3) box centers; R: (n, 3, 3) rotations (body->world columns
    convention, same as physics/scene.py); h: (n, 3) half extents.
    Returns (n,) entry distance t >= 0 for each hit, +inf for misses
    (a ray starting inside a box hits at t = 0).
    """
    p = np.atleast_2d(p)
    h = np.atleast_2d(h)
    n = p.shape[0]
    R = np.asarray(R).reshape(n, 3, 3)
    # transform the ray into each box frame: x_local = R^T (x - p)
    o_l = np.einsum("nij,nj->ni", R.transpose(0, 2, 1), origin[None] - p)
    d_l = np.einsum("nij,j->ni", R.transpose(0, 2, 1), direction)
    # slab test per axis, branchless over the batch
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d_l
        t1 = (-h - o_l) * inv
        t2 = (h - o_l) * inv
    lo = np.minimum(t1, t2)
    hi = np.maximum(t1, t2)
    # axes where the ray is parallel to the slab: inside iff |o| <= h
    par = np.abs(d_l) < 1e-12
    inside = np.abs(o_l) <= h
    lo = np.where(par, np.where(inside, -np.inf, np.inf), lo)
    hi = np.where(par, np.where(inside, np.inf, -np.inf), hi)
    t_near = lo.max(axis=1)
    t_far = hi.min(axis=1)
    hit = (t_near <= t_far) & (t_far >= 0.0)
    t = np.where(t_near >= 0.0, t_near, 0.0)    # inside the box -> t=0
    return np.where(hit, t, np.inf)


def pick_body(camera: Camera, x: float, y: float, width: int, height: int,
              p: np.ndarray, R: np.ndarray, h: np.ndarray) -> int:
    """Pick the body under pixel (x, y): nearest ray-box hit, or -1
    for a miss (ref color_based_selection.h:18-24 — same contract,
    geometric instead of a color-ID render)."""
    origin, direction = camera.pixel_to_ray(x, y, width, height)
    t = ray_obb_distances(origin, direction, p, R, h)
    i = int(np.argmin(t))
    return i if np.isfinite(t[i]) else -1
