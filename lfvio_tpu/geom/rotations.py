"""SO(3) / quaternion math core (pure JAX, batched, dtype-agnostic).

Mirrors the conventions of the reference's math utilities
(/root/reference/vins_estimator/src/utility/utility.h:15-141, utility.cpp:3-12)
so that downstream factor/initializer semantics agree:

  * Hamilton quaternions, stored as ``[w, x, y, z]`` arrays (Eigen's
    constructor order; note Eigen *stores* xyzw but we never expose storage).
  * ``quat_from_small_angle(theta)`` is the first-order exponential
    ``[1, theta/2]`` ("deltaQ").
  * Euler helpers use the yaw-pitch-roll (ZYX) convention in degrees, as the
    reference does for its yaw-gauge fixing.

All functions broadcast over leading batch dimensions and preserve input
dtype, so the same code runs f32 on the accelerator and f64 in CPU tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix. Batched over leading dims."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
        ],
        axis=-2,
    )


def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_mul(q, p):
    """Hamilton product q ⊗ p, both [..., 4] wxyz."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return jnp.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q (R(q) @ v)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_from_small_angle(theta):
    """First-order quaternion exp: [1, theta/2] (reference 'deltaQ').

    Not normalized, matching the reference's use inside midpoint integration
    (normalization happens once per propagate step).
    """
    half = 0.5 * theta
    one = jnp.ones_like(theta[..., 0:1])
    return jnp.concatenate([one, half], axis=-1)


def quat_to_mat(q):
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def mat_to_quat(R):
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] wxyz (w>=0).

    Branch-free Shepperd-style extraction: compute all four candidate
    quaternions and select the best-conditioned one, so it vmaps/jits cleanly.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates (unnormalized), each valid when its pivot is largest.
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    idx = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4(cand), 4(wxyz)]
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, axis=-1), axis=-2)[
        ..., 0, :
    ]
    q = quat_normalize(q)
    return quat_positify(q)


def quat_positify(q):
    """Flip sign so w >= 0 (canonical double-cover representative)."""
    return jnp.where(q[..., 0:1] >= 0, q, -q)


def quat_left(q):
    """4x4 left-multiplication matrix: quat_mul(q, p) == quat_left(q) @ p."""
    w = q[..., 0]
    v = q[..., 1:4]
    top = jnp.concatenate([w[..., None], -v], axis=-1)[..., None, :]
    bottom_left = v[..., :, None]
    bottom_right = w[..., None, None] * jnp.eye(3, dtype=q.dtype) + skew(v)
    bottom = jnp.concatenate([bottom_left, bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def quat_right(p):
    """4x4 right-multiplication matrix: quat_mul(q, p) == quat_right(p) @ q."""
    w = p[..., 0]
    v = p[..., 1:4]
    top = jnp.concatenate([w[..., None], -v], axis=-1)[..., None, :]
    bottom_left = v[..., :, None]
    bottom_right = w[..., None, None] * jnp.eye(3, dtype=p.dtype) - skew(v)
    bottom = jnp.concatenate([bottom_left, bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def quat_box_minus(q, q0):
    """Tangent-space difference 2*vec(q0^{-1} ⊗ q) with sign fix (w>=0).

    Matches the marginalization prior's quaternion Δx
    (/root/reference/vins_estimator/src/factor/marginalization_factor.cpp:347-353).
    """
    d = quat_mul(quat_conj(q0), q)
    d = quat_positify(d)
    return 2.0 * d[..., 1:4]


def so3_exp(theta):
    """Exact SO(3) exponential map: axis-angle [...,3] -> quaternion wxyz.

    Autodiff-safe at theta=0: the norm is guarded *inside* the branch (the
    double-where pattern) and the small branch uses the Taylor series, so
    forward/reverse derivatives are exact at the origin — the solver
    linearizes through this at delta=0 every iteration.
    """
    sq = jnp.sum(theta * theta, axis=-1, keepdims=True)
    small = sq < 1e-16
    safe_sq = jnp.where(small, 1.0, sq)
    angle = jnp.sqrt(safe_sq)
    k = jnp.where(small, 0.5 - sq / 48.0, jnp.sin(0.5 * angle) / angle)
    w = jnp.where(small, 1.0 - sq / 8.0, jnp.cos(0.5 * angle))
    return jnp.concatenate([w, k * theta], axis=-1)


def so3_log(q):
    """SO(3) log map: unit quaternion wxyz -> axis-angle [...,3].

    Autodiff-safe at the identity (same guard pattern as so3_exp)."""
    q = quat_positify(q)
    w = jnp.clip(q[..., 0:1], -1.0, 1.0)
    sq = jnp.sum(q[..., 1:4] * q[..., 1:4], axis=-1, keepdims=True)
    small = sq < 1e-16
    vnorm = jnp.sqrt(jnp.where(small, 1.0, sq))
    angle = 2.0 * jnp.arctan2(vnorm, w)
    # Near identity: angle/vnorm -> 2/w - 2*vnorm^2/(3 w^3) ~ 2 + O(sq).
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-6), angle / vnorm)
    return scale * q[..., 1:4]


def R_to_ypr_deg(R):
    """Rotation matrix -> [yaw, pitch, roll] in degrees (reference R2ypr)."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = jnp.arctan2(n[..., 1], n[..., 0])
    p = jnp.arctan2(-n[..., 2], n[..., 0] * jnp.cos(y) + n[..., 1] * jnp.sin(y))
    r = jnp.arctan2(
        a[..., 0] * jnp.sin(y) - a[..., 1] * jnp.cos(y),
        -o[..., 0] * jnp.sin(y) + o[..., 1] * jnp.cos(y),
    )
    return jnp.stack([y, p, r], axis=-1) * (180.0 / jnp.pi)


def ypr_deg_to_R(ypr):
    """[yaw, pitch, roll] degrees -> rotation matrix (Rz @ Ry @ Rx)."""
    rad = ypr * (jnp.pi / 180.0)
    y, p, r = rad[..., 0], rad[..., 1], rad[..., 2]
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(r), jnp.sin(r)
    one = jnp.ones_like(y)
    zero = jnp.zeros_like(y)
    Rz = jnp.stack(
        [
            jnp.stack([cy, -sy, zero], axis=-1),
            jnp.stack([sy, cy, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    Ry = jnp.stack(
        [
            jnp.stack([cp, zero, sp], axis=-1),
            jnp.stack([zero, one, zero], axis=-1),
            jnp.stack([-sp, zero, cp], axis=-1),
        ],
        axis=-2,
    )
    Rx = jnp.stack(
        [
            jnp.stack([one, zero, zero], axis=-1),
            jnp.stack([zero, cr, -sr], axis=-1),
            jnp.stack([zero, sr, cr], axis=-1),
        ],
        axis=-2,
    )
    return Rz @ Ry @ Rx


def quat_from_two_vectors(a, b):
    """Shortest-arc quaternion rotating unit vector a onto unit vector b."""
    c = jnp.cross(a, b)
    d = jnp.sum(a * b, axis=-1, keepdims=True)
    w = 1.0 + d
    # Degenerate antiparallel case: pick an arbitrary orthogonal axis.
    ortho = jnp.where(
        jnp.abs(a[..., 0:1]) < 0.9,
        jnp.cross(a, jnp.array([1.0, 0.0, 0.0], dtype=a.dtype)),
        jnp.cross(a, jnp.array([0.0, 1.0, 0.0], dtype=a.dtype)),
    )
    anti = w < 1e-8
    q = jnp.where(
        anti,
        jnp.concatenate([jnp.zeros_like(w), ortho], axis=-1),
        jnp.concatenate([w, c], axis=-1),
    )
    return quat_normalize(q)


def g2R(g):
    """World-aligning rotation: maps measured gravity direction to +z with the
    yaw component removed (reference Utility::g2R, utility.cpp:3-12)."""
    ng1 = g / jnp.linalg.norm(g, axis=-1, keepdims=True)
    ng2 = jnp.array([0.0, 0.0, 1.0], dtype=g.dtype)
    R0 = quat_to_mat(quat_from_two_vectors(ng1, jnp.broadcast_to(ng2, ng1.shape)))
    yaw = R_to_ypr_deg(R0)[..., 0]
    zero = jnp.zeros_like(yaw)
    return ypr_deg_to_R(jnp.stack([-yaw, zero, zero], axis=-1)) @ R0


def tangent_basis(a):
    """2x3 orthonormal basis of the tangent plane at unit bearing(s) a.

    Reference convention (projection_factor.cpp:8-18): seed with +z (or +x if
    a == +z), b1 = normalize(seed - a<a,seed>), b2 = a x b1. Rows stacked as
    [..., 2, 3].
    """
    zaxis = jnp.array([0.0, 0.0, 1.0], dtype=a.dtype)
    xaxis = jnp.array([1.0, 0.0, 0.0], dtype=a.dtype)
    is_z = jnp.all(jnp.abs(a - zaxis) < 1e-12, axis=-1, keepdims=True)
    tmp = jnp.where(is_z, xaxis, zaxis)
    b1 = tmp - a * jnp.sum(a * tmp, axis=-1, keepdims=True)
    b1 = b1 / jnp.linalg.norm(b1, axis=-1, keepdims=True)
    b2 = jnp.cross(a, b1)
    return jnp.stack([b1, b2], axis=-2)
