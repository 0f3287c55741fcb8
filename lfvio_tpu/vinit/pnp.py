"""Bearing-vector PnP (host, f64).

The reference uses an EPnP variant rewritten for unit bearings with a sign
channel so points on the negative half-plane resolve correctly
(/root/reference/vins_estimator/src/pnp_solver.cpp:246-254,306-440). Every
call site supplies a good initial pose (the neighboring frame), so the
batched build replaces EPnP's control-point algebra with a damped
Gauss-Newton on the tangent-plane bearing residual — simpler, uses the full
sphere natively, and converges in a handful of iterations from those inits.

Runs on host in float64: PnP only executes during (re-)initialization.
"""

from __future__ import annotations

import numpy as np


def _skew(v):
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )


def _exp_so3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3) + _skew(w)
    K = _skew(w / th)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _tangent_basis(a):
    tmp = np.array([0.0, 0.0, 1.0])
    if abs(a @ tmp) > 0.9999:
        tmp = np.array([1.0, 0.0, 0.0])
    b1 = tmp - a * (a @ tmp)
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(a, b1)
    return np.stack([b1, b2])


def pnp_bearing_gn(
    pts_world, bearings, R_init, t_init, n_iters: int = 10, huber: float = 0.01
):
    """Solve camera pose (R, t: X_cam = R X_world + t) from 3-D points and
    unit bearing observations.

    Args:
      pts_world: [N, 3]; bearings: [N, 3] unit vectors (any hemisphere).
      R_init, t_init: initial guess (world->camera).
    Returns (R, t, ok).
    """
    pts_world = np.asarray(pts_world, np.float64)
    b = np.asarray(bearings, np.float64)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    N = len(pts_world)
    if N < 4:
        return R_init, t_init, False
    R = R_init.copy()
    t = t_init.copy()
    tb = np.stack([_tangent_basis(bi) for bi in b])  # [N, 2, 3]

    lam = 1e-6
    prev_cost = np.inf
    for _ in range(n_iters):
        pc = pts_world @ R.T + t  # [N, 3]
        nrm = np.linalg.norm(pc, axis=-1, keepdims=True)
        nrm = np.maximum(nrm, 1e-12)
        u = pc / nrm
        r = np.einsum("nij,nj->ni", tb, u - b)  # [N, 2]

        # Robust weights (Huber on the 2-vector residual).
        rn = np.linalg.norm(r, axis=-1)
        w = np.where(rn <= huber, 1.0, huber / np.maximum(rn, 1e-12))

        # d u / d pc = (I - u u^T)/|pc| ; d pc/d[dtheta] = -[pc]_x ; d pc/dt = I
        J = np.zeros((N, 2, 6))
        for i in range(N):
            P = (np.eye(3) - np.outer(u[i], u[i])) / nrm[i]
            Jp = tb[i] @ P  # [2, 3]
            J[i, :, 0:3] = -Jp @ _skew(pc[i])
            J[i, :, 3:6] = Jp
        Jw = J * w[:, None, None]
        rw = r * w[:, None]
        H = np.einsum("nri,nrj->ij", Jw, Jw)
        g = np.einsum("nri,nr->i", Jw, rw)
        cost = float(np.sum(rw * rw))
        step = np.linalg.solve(H + lam * np.diag(np.maximum(np.diag(H), 1e-12)), -g)
        R_new = _exp_so3(step[0:3]) @ R
        t_new = t + step[3:6]
        # Simple accept/adapt.
        pc2 = pts_world @ R_new.T + t_new
        u2 = pc2 / np.maximum(np.linalg.norm(pc2, axis=-1, keepdims=True), 1e-12)
        r2 = np.einsum("nij,nj->ni", tb, u2 - b)
        rn2 = np.linalg.norm(r2, axis=-1)
        w2 = np.where(rn2 <= huber, 1.0, huber / np.maximum(rn2, 1e-12))
        cost2 = float(np.sum((r2 * w2[:, None]) ** 2))
        if cost2 < cost:
            R, t = R_new, t_new
            lam = max(lam * 0.3, 1e-9)
            if abs(prev_cost - cost2) < 1e-14:
                break
            prev_cost = cost2
        else:
            lam = min(lam * 10.0, 1e3)

    # Sanity: a majority of points should project near their bearings.
    pc = pts_world @ R.T + t
    u = pc / np.maximum(np.linalg.norm(pc, axis=-1, keepdims=True), 1e-12)
    ang = np.linalg.norm(u - b, axis=-1)
    ok = bool(np.isfinite(ang).all() and (np.median(ang) < 0.05))
    return R, t, ok
