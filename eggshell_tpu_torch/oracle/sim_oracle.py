"""Plain-NumPy re-derivation of the constraint stepper — trajectory oracle.

The port's own copy of `eggshell_tpu.oracle.sim_oracle`, kept equal to it
(tests/test_torch_direct.py).

Implements the reference's ODE-style step (eggshell/ensembles.cc:390-591)
with straightforward dense loops and float64, independently of the JAX
code paths: explicit per-constraint Jacobian assembly, JMJt formation,
conditional CFM, the Schur-complement mixed LCP (oracle solver), and the
midpoint position update.  Plays the role of the C++ reference in
trajectory-parity tests (BASELINE.md: control/state parity within 1e-3).

Contact geometry is supplied by the caller (typically from the
already-oracle-validated SAT narrowphase) as (b0, b1, position, normal,
depth) tuples with b0 = -1 for ground contacts.
"""

from __future__ import annotations

import numpy as np

from eggshell_tpu_torch.oracle import lcp_oracle

GRAVITY = np.array([0.0, 0.0, -9.8])


def _cross_mat(a):
    return np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]], dtype=float
    )


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _w_to_quat(w, dt):
    angle = np.linalg.norm(w) * dt
    if angle < 1e-300:
        return np.array([1.0, 0, 0, 0])
    axis = w / np.linalg.norm(w)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _align_to_z(normal):
    """Rotation with R @ n-hat = z (FromTwoVectors semantics)."""
    a = normal / np.linalg.norm(normal)
    b = np.array([0.0, 0.0, 1.0])
    w = 1.0 + a @ b
    if w < 1e-8:
        # antiparallel: rotate pi about x (x is orthogonal to z)
        q = np.array([0.0, 1.0, 0.0, 0.0])
    else:
        xyz = np.cross(a, b)
        q = np.concatenate([[w], xyz])
        q /= np.linalg.norm(q)
    return _quat_to_mat(q)


class OracleScene:
    """Mutable little world: arrays of body properties + joint list."""

    def __init__(self, p, v, q, w, mass, inertia_body, static, joints):
        self.p = np.array(p, float)
        self.v = np.array(v, float)
        self.q = np.array(q, float)
        self.w = np.array(w, float)
        self.mass = np.array(mass, float)
        self.I_b = np.array(inertia_body, float)
        self.static = np.array(static, bool)
        self.joints = list(joints)  # (b0, b1, c0, c1)
        self.n = len(self.p)

    def R(self, i):
        return _quat_to_mat(self.q[i])

    def M_inverse(self):
        n = self.n
        Minv = np.zeros((6 * n, 6 * n))
        for i in range(n):
            if self.static[i]:
                continue
            Minv[6 * i : 6 * i + 3, 6 * i : 6 * i + 3] = (
                np.eye(3) / self.mass[i]
            )
            R = self.R(i)
            Ig = R @ self.I_b[i] @ R.T
            Minv[6 * i + 3 : 6 * i + 6, 6 * i + 3 : 6 * i + 6] = np.linalg.inv(
                Ig
            )
        return Minv

    def external_force(self):
        F = np.zeros(6 * self.n)
        for i in range(self.n):
            F[6 * i : 6 * i + 3] = self.mass[i] * GRAVITY
            R = self.R(i)
            Ig = R @ self.I_b[i] @ R.T
            F[6 * i + 3 : 6 * i + 6] = -np.cross(self.w[i], Ig @ self.w[i])
        return F

    def velocities(self):
        u = np.zeros(6 * self.n)
        for i in range(self.n):
            u[6 * i : 6 * i + 3] = self.v[i]
            u[6 * i + 3 : 6 * i + 6] = self.w[i]
        return u


def assemble(scene: OracleScene, contacts, friction_bound=1.0):
    """J, err, is_eq, lo, hi for joints then contacts (BOX friction)."""
    rows = []
    errs = []
    eqs = []
    los = []
    his = []
    n = scene.n
    for (b0, b1, c0, c1) in scene.joints:
        J = np.zeros((3, 6 * n))
        R0 = scene.R(b0)
        J[:, 6 * b0 : 6 * b0 + 3] = np.eye(3)
        J[:, 6 * b0 + 3 : 6 * b0 + 6] = -_cross_mat(R0 @ c0)
        p0 = scene.p[b0] + R0 @ c0
        if b1 >= 0:
            R1 = scene.R(b1)
            J[:, 6 * b1 : 6 * b1 + 3] = -np.eye(3)
            J[:, 6 * b1 + 3 : 6 * b1 + 6] = _cross_mat(R1 @ c1)
            err = p0 - scene.p[b1] - R1 @ c1
        else:
            err = p0 - c1
        rows.append(J)
        errs.append(err)
        eqs += [True] * 3
        los += [0.0] * 3
        his += [0.0] * 3

    for (b0, b1, pos, normal, depth) in contacts:
        R = _align_to_z(np.asarray(normal, float))
        J = np.zeros((3, 6 * n))
        if b0 >= 0:
            J[:, 6 * b0 : 6 * b0 + 3] = -R
            J[:, 6 * b0 + 3 : 6 * b0 + 6] = R @ _cross_mat(
                np.asarray(pos) - scene.p[b0]
            )
        if b1 >= 0:
            J[:, 6 * b1 : 6 * b1 + 3] = R
            J[:, 6 * b1 + 3 : 6 * b1 + 6] = -R @ _cross_mat(
                np.asarray(pos) - scene.p[b1]
            )
        rows.append(J)
        errs.append(np.array([0.0, 0.0, -depth]))
        eqs += [False] * 3
        los += [-friction_bound, -friction_bound, 0.0]
        his += [friction_bound, friction_bound, np.inf]

    if not rows:
        return (
            np.zeros((0, 6 * n)),
            np.zeros(0),
            np.zeros(0, bool),
            np.zeros(0),
            np.zeros(0),
        )
    return (
        np.vstack(rows),
        np.concatenate(errs),
        np.array(eqs),
        np.array(los),
        np.array(his),
    )


def step_ode(
    scene: OracleScene,
    contacts,
    dt=1e-3,
    erp=0.2,
    cfm=0.01,
    conditional_cfm=True,
    good_condition_number=1e7,
    friction_bound=1.0,
):
    """One ODE-style step in place (ref ensembles.cc:563-591)."""
    J, err, is_eq, lo, hi = assemble(scene, contacts, friction_bound)
    Minv = scene.M_inverse()
    F = scene.external_force()
    u = scene.velocities()

    if J.shape[0] == 0:
        vdot = Minv @ F
    else:
        rhs = -erp / dt / dt * err - J @ (u / dt + Minv @ F)
        A = J @ Minv @ J.T
        if conditional_cfm:
            eigs = np.linalg.eigvalsh(A)
            bad = eigs[0] <= 0 or (
                eigs[-1] / max(eigs[0], 1e-300) > good_condition_number
            )
            if bad:
                A = A + cfm * np.eye(A.shape[0])
        else:
            A = A + cfm * np.eye(A.shape[0])
        lam, _, ok = lcp_oracle.mixed_constraints_solver(A, rhs, is_eq, lo, hi)
        vdot = Minv @ (F + J.T @ lam)

    u_new = u + dt * vdot
    for i in range(scene.n):
        v_mid = 0.5 * (u[6 * i : 6 * i + 3] + u_new[6 * i : 6 * i + 3])
        w_mid = 0.5 * (u[6 * i + 3 : 6 * i + 6] + u_new[6 * i + 3 : 6 * i + 6])
        scene.p[i] = scene.p[i] + dt * v_mid
        dq = _w_to_quat(w_mid, dt)
        q = _quat_mul(dq, scene.q[i])
        scene.q[i] = q / np.linalg.norm(q)
        scene.v[i] = u_new[6 * i : 6 * i + 3]
        scene.w[i] = u_new[6 * i + 3 : 6 * i + 6]
    return scene
