"""IMU midpoint preintegration with first-order bias Jacobians and noise
covariance propagation.

Semantics follow the reference's IntegrationBase
(/root/reference/vins_estimator/src/factor/integration_base.h:54-186):
midpoint integration of (Δp, Δq, Δv) between two camera frames, a 15×15
Jacobian w.r.t. [p, θ, v, ba, bg] propagated as J ← F·J, and covariance
P ← F·P·Fᵀ + V·N·Vᵀ with an 18×18 diagonal input noise.

Differences from the reference:
  * One ``jax.lax.scan`` over a fixed-size padded sample buffer replaces the
    per-sample ``push_back``/``propagate`` calls; padding samples use dt=0,
    which is an exact no-op of the recursion (F=I, V=0).
  * ``repropagate`` (integration_base.h:38-52) is just calling
    ``preintegrate`` again with new biases over the same buffer — the
    functional formulation makes re-integration free of mutable state.
  * Everything is batched: vmap over the 10 window intervals integrates all
    preintegrations in parallel.

State ordering: O_P=0, O_R=3, O_V=6, O_BA=9, O_BG=12 (parameters.h).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..geom import (
    quat_identity,
    quat_mul,
    quat_conj,
    quat_normalize,
    quat_rotate,
    quat_from_small_angle,
    quat_to_mat,
    skew,
)

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_pytree_node(
        cls,
        lambda c: ([getattr(c, n) for n in fields], None),
        lambda aux, ch: cls(*ch),
    )
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class ImuNoise:
    """Continuous-ish noise densities (config acc_n/gyr_n/acc_w/gyr_w)."""

    acc_n: Any
    gyr_n: Any
    acc_w: Any
    gyr_w: Any

    def noise_matrix(self, dtype):
        d = jnp.concatenate(
            [
                jnp.full((3,), self.acc_n**2, dtype=dtype),
                jnp.full((3,), self.gyr_n**2, dtype=dtype),
                jnp.full((3,), self.acc_n**2, dtype=dtype),
                jnp.full((3,), self.gyr_n**2, dtype=dtype),
                jnp.full((3,), self.acc_w**2, dtype=dtype),
                jnp.full((3,), self.gyr_w**2, dtype=dtype),
            ]
        )
        return jnp.diag(d)


@_register
@dataclasses.dataclass(frozen=True)
class Preintegration:
    """Result of integrating one inter-frame IMU interval."""

    delta_p: Any  # [3]
    delta_q: Any  # [4] wxyz
    delta_v: Any  # [3]
    jacobian: Any  # [15, 15] d(delta)/d[p,θ,v,ba,bg] at linearization biases
    covariance: Any  # [15, 15]
    sum_dt: Any  # scalar
    linearized_ba: Any  # [3]
    linearized_bg: Any  # [3]


def _midpoint_step(carry, inp, noise_mat):
    """One midpoint step of the delta-state + Jacobian + covariance recursion
    (integration_base.h:54-158). carry acc/gyr hold the previous sample."""
    (dp, dq, dv, jac, cov, sum_dt, acc_0, gyr_0, ba, bg) = carry
    dt, acc_1, gyr_1 = inp
    dtype = dp.dtype

    un_acc_0 = quat_rotate(dq, acc_0 - ba)
    un_gyr = 0.5 * (gyr_0 + gyr_1) - bg
    dq_new = quat_mul(dq, quat_from_small_angle(un_gyr * dt))
    un_acc_1 = quat_rotate(dq_new, acc_1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    dp_new = dp + dv * dt + 0.5 * un_acc * dt * dt
    dv_new = dv + un_acc * dt

    R0 = quat_to_mat(dq)
    R1 = quat_to_mat(dq_new)
    Rw = skew(un_gyr)
    Ra0 = skew(acc_0 - ba)
    Ra1 = skew(acc_1 - ba)
    I3 = jnp.eye(3, dtype=dtype)
    dt2 = dt * dt

    F = jnp.zeros((15, 15), dtype=dtype)
    F = F.at[0:3, 0:3].set(I3)
    F = F.at[0:3, 3:6].set(
        -0.25 * R0 @ Ra0 * dt2 - 0.25 * R1 @ Ra1 @ (I3 - Rw * dt) * dt2
    )
    F = F.at[0:3, 6:9].set(I3 * dt)
    F = F.at[0:3, 9:12].set(-0.25 * (R0 + R1) * dt2)
    F = F.at[0:3, 12:15].set(0.25 * R1 @ Ra1 * dt2 * dt)
    F = F.at[3:6, 3:6].set(I3 - Rw * dt)
    F = F.at[3:6, 12:15].set(-I3 * dt)
    F = F.at[6:9, 3:6].set(
        -0.5 * R0 @ Ra0 * dt - 0.5 * R1 @ Ra1 @ (I3 - Rw * dt) * dt
    )
    F = F.at[6:9, 6:9].set(I3)
    F = F.at[6:9, 9:12].set(-0.5 * (R0 + R1) * dt)
    F = F.at[6:9, 12:15].set(0.5 * R1 @ Ra1 * dt * dt)
    F = F.at[9:12, 9:12].set(I3)
    F = F.at[12:15, 12:15].set(I3)

    V = jnp.zeros((15, 18), dtype=dtype)
    v03 = -0.125 * R1 @ Ra1 * dt2 * dt  # 0.25 * (-R1 Ra1) dt^2 * 0.5 dt
    V = V.at[0:3, 0:3].set(0.25 * R0 * dt2)
    V = V.at[0:3, 3:6].set(v03)
    V = V.at[0:3, 6:9].set(0.25 * R1 * dt2)
    V = V.at[0:3, 9:12].set(v03)
    V = V.at[3:6, 3:6].set(0.5 * I3 * dt)
    V = V.at[3:6, 9:12].set(0.5 * I3 * dt)
    v63 = -0.25 * R1 @ Ra1 * dt * dt
    V = V.at[6:9, 0:3].set(0.5 * R0 * dt)
    V = V.at[6:9, 3:6].set(v63)
    V = V.at[6:9, 6:9].set(0.5 * R1 * dt)
    V = V.at[6:9, 9:12].set(v63)
    V = V.at[9:12, 12:15].set(I3 * dt)
    V = V.at[12:15, 15:18].set(I3 * dt)

    jac_new = F @ jac
    cov_new = F @ cov @ F.T + V @ noise_mat @ V.T

    carry_new = (
        dp_new,
        quat_normalize(dq_new),
        dv_new,
        jac_new,
        cov_new,
        sum_dt + dt,
        acc_1,
        gyr_1,
        ba,
        bg,
    )
    return carry_new, None


def preintegrate(dts, accs, gyrs, acc0, gyr0, ba, bg, noise: ImuNoise):
    """Integrate a (padded) buffer of IMU samples into a Preintegration.

    Args:
      dts: [N] sample spacings; pad unused tail with 0 (exact no-op).
      accs, gyrs: [N, 3] samples at the *end* of each dt.
      acc0, gyr0: [3] sample at the interval start (linearized_acc/gyr).
      ba, bg: [3] linearization biases.
    """
    dtype = accs.dtype
    init = (
        jnp.zeros(3, dtype),
        quat_identity(dtype),
        jnp.zeros(3, dtype),
        jnp.eye(15, dtype=dtype),
        jnp.zeros((15, 15), dtype=dtype),
        jnp.zeros((), dtype),
        acc0,
        gyr0,
        ba,
        bg,
    )
    noise_mat = noise.noise_matrix(dtype)
    step = lambda c, x: _midpoint_step(c, x, noise_mat)
    (dp, dq, dv, jac, cov, sum_dt, *_), _ = jax.lax.scan(
        step, init, (dts, accs, gyrs)
    )
    return Preintegration(dp, dq, dv, jac, cov, sum_dt, ba, bg)


def _midpoint_FV(R0, R1, un_gyr, acc0_c, acc1_c, dt, dtype):
    """Batched construction of the midpoint transition F [N,15,15] and noise
    input V [N,15,18] (integration_base.h:78-131), given the prefix rotations.
    All inputs carry a leading batch axis N."""
    N = dt.shape[0]
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (N, 3, 3))
    Z3 = jnp.zeros((N, 3, 3), dtype)
    dt_ = dt[:, None, None]
    dt2 = dt_ * dt_
    Rw = skew(un_gyr)
    Ra0 = skew(acc0_c)
    Ra1 = skew(acc1_c)
    A = I3 - Rw * dt_  # F[3:6, 3:6]
    R1Ra1 = R1 @ Ra1
    R0Ra0 = R0 @ Ra0

    F_pth = -0.25 * R0Ra0 * dt2 - 0.25 * (R1Ra1 @ A) * dt2
    F_vth = -0.5 * R0Ra0 * dt_ - 0.5 * (R1Ra1 @ A) * dt_

    def rows(blocks):
        return jnp.concatenate(blocks, axis=2)

    F = jnp.concatenate(
        [
            rows([I3, F_pth, I3 * dt_, -0.25 * (R0 + R1) * dt2, 0.25 * R1Ra1 * dt2 * dt_]),
            rows([Z3, A, Z3, Z3, -I3 * dt_]),
            rows([Z3, F_vth, I3, -0.5 * (R0 + R1) * dt_, 0.5 * R1Ra1 * dt_ * dt_]),
            rows([Z3, Z3, Z3, I3, Z3]),
            rows([Z3, Z3, Z3, Z3, I3]),
        ],
        axis=1,
    )
    v03 = -0.125 * R1Ra1 * dt2 * dt_
    v63 = -0.25 * R1Ra1 * dt_ * dt_
    V = jnp.concatenate(
        [
            rows([0.25 * R0 * dt2, v03, 0.25 * R1 * dt2, v03, Z3, Z3]),
            rows([Z3, 0.5 * I3 * dt_, Z3, 0.5 * I3 * dt_, Z3, Z3]),
            rows([0.5 * R0 * dt_, v63, 0.5 * R1 * dt_, v63, Z3, Z3]),
            rows([Z3, Z3, Z3, Z3, I3 * dt_, Z3]),
            rows([Z3, Z3, Z3, Z3, Z3, I3 * dt_]),
        ],
        axis=1,
    )
    return F, V


def preintegrate_parallel(dts, accs, gyrs, acc0, gyr0, ba, bg, noise: ImuNoise):
    """Depth-parallel preintegration: identical semantics to ``preintegrate``
    but O(log N) sequential depth instead of the 256-step ``lax.scan``.

    Restructuring of integration_base.h's inherently sequential
    push_back/propagate recursion:

      1. The per-step local rotations r_k = exp((½(ω_{k-1}+ω_k) − bg)·dt)
         depend only on the inputs, so the orientation chain
         Δq_k = r_1 ⊗ … ⊗ r_k is a ``lax.associative_scan`` of quaternion
         products.
      2. With all prefix rotations known, the midpoint accelerations are
         closed-form and (Δv, Δp) become cumulative sums.
      3. J_N = F_N···F_1 and P_N = Σ (F_N···F_{k+1}) Q_k (·)ᵀ are one
         associative reduction over pairs (F, Q) with the combiner
         (F_b, Q_b)∘(F_a, Q_a) = (F_b F_a, F_b Q_a F_bᵀ + Q_b) — batched
         15×15 matmuls at log₂ N depth.

    Zero-padded samples (dt = 0) remain an exact no-op (F = I, Q = 0,
    r = identity). Numerics differ from the sequential path only by the
    per-step quaternion renormalization (≤1e-6 relative); parity is tested
    in tests/test_imu.py.
    """
    dtype = accs.dtype
    n = dts.shape[0]

    prev_accs = jnp.concatenate([acc0[None], accs[:-1]], axis=0)
    prev_gyrs = jnp.concatenate([gyr0[None], gyrs[:-1]], axis=0)
    un_gyr = 0.5 * (prev_gyrs + gyrs) - bg[None]  # [N, 3]
    r_local = quat_from_small_angle(un_gyr * dts[:, None])  # [N, 4]

    # 1. Orientation prefix chain.
    dq_prefix = jax.lax.associative_scan(quat_mul, r_local, axis=0)
    dq_prefix = quat_normalize(dq_prefix)  # [N, 4]: Δq after step k
    dq_prev = jnp.concatenate(
        [quat_identity(dtype)[None], dq_prefix[:-1]], axis=0
    )
    R0 = quat_to_mat(dq_prev)  # [N, 3, 3]
    R1 = quat_to_mat(dq_prefix)

    # 2. Midpoint accelerations → Δv, Δp by cumulative sums.
    acc0_c = prev_accs - ba[None]
    acc1_c = accs - ba[None]
    un_acc = 0.5 * (
        jnp.einsum("nij,nj->ni", R0, acc0_c)
        + jnp.einsum("nij,nj->ni", R1, acc1_c)
    )
    dvs = un_acc * dts[:, None]
    dv_prefix = jnp.cumsum(dvs, axis=0)
    dv_prev = jnp.concatenate([jnp.zeros((1, 3), dtype), dv_prefix[:-1]], axis=0)
    dp_steps = dv_prev * dts[:, None] + 0.5 * un_acc * dts[:, None] ** 2
    delta_p = jnp.sum(dp_steps, axis=0)
    delta_v = dv_prefix[-1]
    delta_q = dq_prefix[-1]
    sum_dt = jnp.sum(dts)

    # 3. Jacobian + covariance as one associative (F, Q) reduction.
    F, V = _midpoint_FV(R0, R1, un_gyr, acc0_c, acc1_c, dts, dtype)
    noise_mat = noise.noise_matrix(dtype)
    Q = jnp.einsum("nij,jk,nlk->nil", V, noise_mat, V)

    def combine(a, b):
        Fa, Qa = a
        Fb, Qb = b
        return Fb @ Fa, Fb @ Qa @ jnp.swapaxes(Fb, -1, -2) + Qb

    Ftot, Qtot = jax.tree_util.tree_map(
        lambda x: x[-1], jax.lax.associative_scan(combine, (F, Q), axis=0)
    )
    return Preintegration(delta_p, delta_q, delta_v, Ftot, Qtot, sum_dt, ba, bg)


def bias_corrected_delta(pre: Preintegration, ba_new, bg_new):
    """First-order-corrected (Δp, Δq, Δv) at updated biases
    (integration_base.h:160-175)."""
    dba = ba_new - pre.linearized_ba
    dbg = bg_new - pre.linearized_bg
    dp = (
        pre.delta_p
        + pre.jacobian[O_P : O_P + 3, O_BA : O_BA + 3] @ dba
        + pre.jacobian[O_P : O_P + 3, O_BG : O_BG + 3] @ dbg
    )
    dv = (
        pre.delta_v
        + pre.jacobian[O_V : O_V + 3, O_BA : O_BA + 3] @ dba
        + pre.jacobian[O_V : O_V + 3, O_BG : O_BG + 3] @ dbg
    )
    dq = quat_mul(
        pre.delta_q,
        quat_from_small_angle(pre.jacobian[O_R : O_R + 3, O_BG : O_BG + 3] @ dbg),
    )
    return dp, quat_normalize(dq), dv


def imu_residual(pre: Preintegration, p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j, gravity):
    """15-dim preintegration residual (integration_base.h:160-186).

    gravity is the world gravity vector (typically [0, 0, 9.81])."""
    dp, dq, dv = bias_corrected_delta(pre, ba_i, bg_i)
    qi_inv = quat_conj(q_i)
    r_p = (
        quat_rotate(qi_inv, 0.5 * gravity * pre.sum_dt**2 + p_j - p_i - v_i * pre.sum_dt)
        - dp
    )
    r_q = 2.0 * quat_mul(quat_conj(dq), quat_mul(qi_inv, q_j))[..., 1:4]
    r_v = quat_rotate(qi_inv, gravity * pre.sum_dt + v_j - v_i) - dv
    return jnp.concatenate([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], axis=-1)


def whiten_covariance(cov, valid):
    """Batched whitening of preintegration covariances — device, f32-safe.

    Computes S with SᵀS = cov⁻¹ via a diagonally-scaled Cholesky: cov =
    D·C·D with D = diag(√diag cov); S = chol(C)⁻¹·D⁻¹. Scaling keeps the
    Cholesky operating on a unit-diagonal correlation matrix, so f32 handles
    the ~1e7 dynamic range of raw covariances (reference whitens in f64 via
    LLT of cov⁻¹, imu_factor.h:64-66 — equivalent cost up to an orthogonal
    rotation of the residual).

    Args: cov [..., 15, 15], valid [...] bool.
    Returns (sqrt_info [..., 15, 15], ok [...] bool) — zeroed/False where the
    factorization failed or the interval was invalid.
    """
    dtype = cov.dtype
    n = cov.shape[-1]
    eye = jnp.eye(n, dtype=dtype)
    cov = 0.5 * (cov + jnp.swapaxes(cov, -1, -2))
    d = jnp.sqrt(jnp.clip(jnp.diagonal(cov, axis1=-2, axis2=-1), 1e-24, None))
    dinv = 1.0 / d
    corr = cov * dinv[..., :, None] * dinv[..., None, :] + 1e-6 * eye
    corr = jnp.where(valid[..., None, None], corr, eye)
    L = jnp.linalg.cholesky(corr)
    Linv = jax.scipy.linalg.solve_triangular(L, jnp.broadcast_to(eye, L.shape), lower=True)
    S = Linv * dinv[..., None, :]
    ok = valid & jnp.isfinite(S).all(axis=(-2, -1))
    S = jnp.where(ok[..., None, None], S, 0.0)
    return S, ok


def propagate_state_midpoint(p, q, v, acc_0, gyr_0, acc_1, gyr_1, dt, ba, bg, gravity):
    """World-frame midpoint propagation of (p, q, v) through one IMU sample —
    the high-rate prediction path and window-state update
    (estimator.cpp:109-116, estimator_node.cpp:41-77)."""
    un_acc_0 = quat_rotate(q, acc_0 - ba) - gravity
    un_gyr = 0.5 * (gyr_0 + gyr_1) - bg
    q_new = quat_normalize(quat_mul(q, quat_from_small_angle(un_gyr * dt)))
    un_acc_1 = quat_rotate(q_new, acc_1 - ba) - gravity
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    p_new = p + dt * v + 0.5 * dt * dt * un_acc
    v_new = v + dt * un_acc
    return p_new, q_new, v_new
