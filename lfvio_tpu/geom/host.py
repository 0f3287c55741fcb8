"""Pure-numpy mirrors of the geometry core for *host* code paths.

The estimator driver, feature bookkeeping, and initialization run on the
host between jitted device steps. Calling the jnp-based helpers there would
dispatch a device op per quaternion multiply; these numpy twins keep host
math on the host. Semantics are
identical to geom.rotations (same wxyz convention); parity is tested.
"""

from __future__ import annotations

import numpy as np


def quat_mul(q, p):
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return np.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - 2 * (yy + zz)
    m[..., 0, 1] = 2 * (xy - wz)
    m[..., 0, 2] = 2 * (xz + wy)
    m[..., 1, 0] = 2 * (xy + wz)
    m[..., 1, 1] = 1 - 2 * (xx + zz)
    m[..., 1, 2] = 2 * (yz - wx)
    m[..., 2, 0] = 2 * (xz - wy)
    m[..., 2, 1] = 2 * (yz + wx)
    m[..., 2, 2] = 1 - 2 * (xx + yy)
    return m


def mat_to_quat(R):
    """Single rotation matrix -> wxyz quaternion with w >= 0."""
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([
            0.25 * s,
            (R[2, 1] - R[1, 2]) / s,
            (R[0, 2] - R[2, 0]) / s,
            (R[1, 0] - R[0, 1]) / s,
        ])
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        q = np.array([
            (R[2, 1] - R[1, 2]) / s,
            0.25 * s,
            (R[0, 1] + R[1, 0]) / s,
            (R[0, 2] + R[2, 0]) / s,
        ])
    elif m11 >= m22:
        s = np.sqrt(1.0 - m00 + m11 - m22) * 2
        q = np.array([
            (R[0, 2] - R[2, 0]) / s,
            (R[0, 1] + R[1, 0]) / s,
            0.25 * s,
            (R[1, 2] + R[2, 1]) / s,
        ])
    else:
        s = np.sqrt(1.0 - m00 - m11 + m22) * 2
        q = np.array([
            (R[1, 0] - R[0, 1]) / s,
            (R[0, 2] + R[2, 0]) / s,
            (R[1, 2] + R[2, 1]) / s,
            0.25 * s,
        ])
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def so3_exp(theta):
    sq = float(np.dot(theta, theta))
    if sq < 1e-16:
        k = 0.5 - sq / 48.0
        w = 1.0 - sq / 8.0
    else:
        a = np.sqrt(sq)
        k = np.sin(0.5 * a) / a
        w = np.cos(0.5 * a)
    return np.concatenate([[w], k * np.asarray(theta)])


def so3_log(q):
    q = q if q[0] >= 0 else -q
    vn = np.linalg.norm(q[1:4])
    if vn < 1e-12:
        return 2.0 * q[1:4]
    angle = 2.0 * np.arctan2(vn, q[0])
    return q[1:4] * (angle / vn)


def quat_box_minus(q, q0):
    d = quat_mul(quat_conj(q0), q)
    if d[..., 0] < 0:
        d = -d
    return 2.0 * d[..., 1:4]


def R_to_ypr_deg(R):
    n = R[:, 0]
    o = R[:, 1]
    a = R[:, 2]
    y = np.arctan2(n[1], n[0])
    p = np.arctan2(-n[2], n[0] * np.cos(y) + n[1] * np.sin(y))
    r = np.arctan2(
        a[0] * np.sin(y) - a[1] * np.cos(y), -o[0] * np.sin(y) + o[1] * np.cos(y)
    )
    return np.degrees(np.array([y, p, r]))


def ypr_deg_to_R(ypr):
    y, p, r = np.radians(np.asarray(ypr, np.float64))
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def g2R(g):
    ng1 = np.asarray(g) / np.linalg.norm(g)
    ng2 = np.array([0.0, 0.0, 1.0])
    c = np.cross(ng1, ng2)
    d = float(ng1 @ ng2)
    if d < -1 + 1e-8:
        R0 = np.diag([1.0, -1.0, -1.0])
    else:
        K = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]])
        R0 = np.eye(3) + K + K @ K / (1.0 + d)
    yaw = R_to_ypr_deg(R0)[0]
    return ypr_deg_to_R([-yaw, 0.0, 0.0]) @ R0
