"""Residual functions for the sliding-window bundle adjustment.

Semantics match the reference factors:
  * unit-sphere projection factor with time-offset correction
    (projection_factor.cpp:21-55, projection_td_factor.cpp:36-77): the
    residual is the 2-D tangent-plane component of the bearing error at the
    measured bearing, scaled by sqrt_info = FOCAL_LENGTH/1.5.
  * IMU preintegration factor (imu_factor.h:40-66): 15-dim residual whitened
    by the inverse-covariance square root.
  * marginalization prior (marginalization_factor.cpp:333-381).

Jacobians are NOT hand-coded: the solver linearizes these residuals with
per-factor forward-mode autodiff on the tangent-space perturbation (see
solver.py), which XLA fuses into the same batched computation the analytic
Jacobians in the reference express by hand.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geom import (
    quat_rotate,
    quat_conj,
    quat_mul,
    tangent_basis,
    so3_exp,
    quat_box_minus,
)
from ..imu import imu_residual as _imu_residual_single
from ..imu.preintegration import Preintegration
from .state import (
    WindowState,
    FeatureGrid,
    PriorFactor,
    pose_off,
    sb_off,
    ex_off,
    td_off,
    pose_dim,
    ex_2d,
)


def projection_residual_single(
    p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j, inv_dep, td,
    pts_i, pts_j, vel_i, vel_j, td_obs_i, td_obs_j, tangent_b,
    sqrt_info,
):
    """One unit-sphere + td projection residual (2-dim).

    ``td_obs`` carries the measurement-time constant ``td_meas - TR/ROW*row``
    so the correction is ``pts - (td - td_obs)*vel`` (projection_td_factor
    .cpp:53-56 folds the rolling-shutter row term the same way; we keep the
    row sign convention by precomputing it into td_obs).

    (tic_i, qic_i) is the extrinsic of the ANCHOR observation's camera and
    (tic_j, qic_j) the observing camera's — identical for a mono rig; a
    multi-camera rig (dual-PAL) may observe one landmark from different
    cameras (the reference's per-observation camera id,
    estimator_node.cpp:292-312).
    """
    pts_i_td = pts_i - (td - td_obs_i) * vel_i
    pts_j_td = pts_j - (td - td_obs_j) * vel_j
    safe_dep = jnp.where(jnp.abs(inv_dep) < 1e-8, 1e-8, inv_dep)
    pts_cam_i = pts_i_td / safe_dep
    pts_imu_i = quat_rotate(qic_i, pts_cam_i) + tic_i
    pts_w = quat_rotate(q_i, pts_imu_i) + p_i
    pts_imu_j = quat_rotate(quat_conj(q_j), pts_w - p_j)
    pts_cam_j = quat_rotate(quat_conj(qic_j), pts_imu_j - tic_j)
    n = jnp.linalg.norm(pts_cam_j)
    safe_n = jnp.maximum(n, 1e-12)
    err = pts_cam_j / safe_n - pts_j_td / jnp.maximum(
        jnp.linalg.norm(pts_j_td), 1e-12
    )
    return sqrt_info * (tangent_b @ err)


def projection_residuals_grid(
    state: WindowState, grid: FeatureGrid, sqrt_info, mask=None
):
    """All projection residuals over the dense [F, W+1] observation grid.

    Returns (residuals [F, W+1, 2], valid mask [F, W+1]). Invalid entries are
    zeroed. The anchor observation (j == anchor) contributes nothing.
    """
    dtype = state.p.dtype
    F, W1 = grid.valid.shape
    onehot = grid.anchor_onehot(dtype)  # [F, W+1]

    # Gather anchor quantities per feature slot via one-hot contraction (no
    # dynamic gathers).
    p_i = onehot @ state.p  # [F, 3]
    q_i = onehot @ state.q  # [F, 4] (exact: one-hot row selects a quat)
    pts_i = jnp.einsum("fw,fwc->fc", onehot, grid.bearing)
    vel_i = jnp.einsum("fw,fwc->fc", onehot, grid.velocity)
    td_obs_i = jnp.einsum("fw,fw->f", onehot, grid.td_obs)

    # Per-observation camera extrinsics (mono: broadcast of the single one).
    tics, qics = ex_2d(state.tic, state.qic)
    oh_cam = grid.cam_onehot(tics.shape[0], dtype)  # [F, W+1, C]
    tic_j = jnp.einsum("fwc,cd->fwd", oh_cam, tics)  # [F, W+1, 3]
    qic_j = jnp.einsum("fwc,cd->fwd", oh_cam, qics)  # [F, W+1, 4]
    tic_i = jnp.einsum("fw,fwd->fd", onehot, tic_j)  # anchor obs camera
    qic_i = jnp.einsum("fw,fwd->fd", onehot, qic_j)

    tb = tangent_basis(grid.bearing)  # [F, W+1, 2, 3] at measured pts_j

    def per_obs(p_i, q_i, pts_i, vel_i, td_obs_i, tic_i, qic_i,
                p_j, q_j, pts_j, vel_j, td_obs_j, tic_j, qic_j, tb_j, inv_dep):
        return projection_residual_single(
            p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j, inv_dep, state.td,
            pts_i, pts_j, vel_i, vel_j, td_obs_i, td_obs_j, tb_j, sqrt_info,
        )

    # vmap over frames (j) then features (f).
    f_over_frames = jax.vmap(
        per_obs,
        in_axes=(None, None, None, None, None, None, None,
                 0, 0, 0, 0, 0, 0, 0, 0, None),
    )
    f_over_feats = jax.vmap(
        f_over_frames,
        in_axes=(0, 0, 0, 0, 0, 0, 0, None, None, 0, 0, 0, 0, 0, 0, 0),
    )
    res = f_over_feats(
        p_i, q_i, pts_i, vel_i, td_obs_i, tic_i, qic_i,
        state.p, state.q, grid.bearing, grid.velocity, grid.td_obs,
        tic_j, qic_j, tb,
        state.inv_depth,
    )  # [F, W+1, 2]

    frame_idx = jnp.arange(W1)[None, :]
    not_anchor = frame_idx != grid.anchor[:, None]
    valid = grid.valid & not_anchor & grid.used[:, None]
    if mask is not None:
        valid = valid & mask
    return jnp.where(valid[..., None], res, 0.0), valid


def cauchy_corrector(res, valid, c=1.0):
    """Ceres robust-loss corrector for CauchyLoss(c), rescaling 2-dim residual
    blocks (marginalization_factor.cpp:37-68 applies the same formula).

    Returns per-block scale factors (applied to residual and, by linearity of
    the subsequent autodiff, to the Jacobian — the reference's full corrector
    also subtracts an alpha term along the residual direction; we use the
    common sqrt(rho') approximation which keeps H PSD, as Ceres does for
    Gauss-Newton with loss functions).
    """
    sq_norm = jnp.sum(res * res, axis=-1, keepdims=True)  # [..., 1]
    c2 = c * c
    rho_p = 1.0 / (1.0 + sq_norm / c2)
    return jnp.sqrt(rho_p)


def imu_residuals_window(state: WindowState, pre: Preintegration, sqrt_info, gravity, valid):
    """IMU residuals for all W window intervals, whitened.

    Args:
      pre: vmapped Preintegration with leading axis W (interval i -> i+1).
      sqrt_info: [W, 15, 15] whitening matrices (cov^-1 = LLᵀ, sqrt_info=Lᵀ).
      valid: [W] bool (False for sum_dt > 10 or not-yet-filled frames,
             estimator.cpp:717-721).
    Returns [W, 15] residuals (zeroed where invalid).
    """
    W = sqrt_info.shape[0]

    def per_interval(pre_k, si, p0, q0, v0, ba0, bg0, p1, q1, v1, ba1, bg1):
        r = _imu_residual_single(
            pre_k, p0, q0, v0, ba0, bg0, p1, q1, v1, ba1, bg1, gravity
        )
        return si @ r

    res = jax.vmap(per_interval)(
        pre, sqrt_info,
        state.p[:-1], state.q[:-1], state.v[:-1], state.ba[:-1], state.bg[:-1],
        state.p[1:], state.q[1:], state.v[1:], state.ba[1:], state.bg[1:],
    )
    return jnp.where(valid[:, None], res, 0.0)


def state_box_minus(state: WindowState, prior: PriorFactor):
    """Full-layout tangent difference x ⊟ x0 (quaternion-aware, matching
    marginalization_factor.cpp:341-353)."""
    n_frames = state.p.shape[0]
    tics, qics = ex_2d(state.tic, state.qic)
    x0_tics, x0_qics = ex_2d(prior.x0_tic, prior.x0_qic)
    C = tics.shape[0]
    D = pose_dim(n_frames, C)
    dx = jnp.zeros((D,), state.p.dtype)
    dp = state.p - prior.x0_p  # [W+1, 3]
    dth = quat_box_minus(state.q, prior.x0_q)  # [W+1, 3]
    pose_part = jnp.concatenate([dp, dth], axis=-1).reshape(-1)  # [6*(W+1)]
    sb_part = jnp.concatenate(
        [state.v - prior.x0_v, state.ba - prior.x0_ba, state.bg - prior.x0_bg],
        axis=-1,
    ).reshape(-1)  # [9*(W+1)]
    dex = jnp.concatenate(
        [tics - x0_tics, quat_box_minus(qics, x0_qics)], axis=-1
    ).reshape(-1)  # [6*C], camera-major
    dx = dx.at[: 6 * n_frames].set(pose_part)
    dx = dx.at[6 * n_frames : 15 * n_frames].set(sb_part)
    dx = dx.at[15 * n_frames : 15 * n_frames + 6 * C].set(dex)
    dx = dx.at[-1].set(state.td - prior.x0_td)
    return dx


def prior_residual(state: WindowState, prior: PriorFactor):
    """r = r0 + J (x ⊟ x0); zero when no prior exists yet."""
    dx = state_box_minus(state, prior)
    r = prior.r0 + prior.J @ dx
    return jnp.where(prior.valid, r, jnp.zeros_like(r))
