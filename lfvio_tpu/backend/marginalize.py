"""Two-mode Schur-complement marginalization producing a square-root prior.

Mirrors MarginalizationInfo::marginalize
(/root/reference/vins_estimator/src/factor/marginalization_factor.cpp:174-297):

  * MARGIN_OLD — collect {old prior, IMU(0,1), projection factors anchored at
    frame 0}, Gauss-Newton assemble H,b, Schur-eliminate {pose0, speedbias0,
    anchored inverse depths}, then recover the square-root prior
    J = S^{1/2} Vᵀ, r = S^{-1/2} Vᵀ b via eigendecomposition with the
    reference's eps=1e-8 pseudo-inverse.
  * MARGIN_SECOND_NEW — only the old prior participates; drop pose[W-1]
    (the discarded second-newest frame).

Differences from the reference: static full-layout shapes (dropped blocks
become zero columns, no index bookkeeping); the depth block is eliminated
analytically (it is diagonal) before the small dense elimination; the whole
routine is one jittable function. The estimator runs the QR variants below
(``marginalize_old_qr`` / ``marginalize_second_new_qr``) as its own jitted
program on the default device, in the solver's dtype; the eigh variants
here are the f64 reference the tests compare against.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .state import (
    WindowState,
    FeatureGrid,
    PriorFactor,
    SolverConfig,
    pose_dim,
    pose_off,
    sb_off,
    n_cams_of,
)
from .solver import (
    assemble_normal_equations,
    linearize_proj_rows,
    linearize_imu_rows,
)
from .factors import prior_residual, state_box_minus

EPS = 1e-8  # reference eigenvalue threshold (marginalization_factor.h eps)


def _eliminate_indices(H, b, drop_idx):
    """Schur-eliminate the STATICALLY-indexed rows/cols drop_idx (a Python
    tuple) via an eigendecomposition pseudo-inverse of the mm block
    (reference marginalization_factor.cpp:266-281). Output keeps the full
    static shape with eliminated rows/cols zeroed.

    The drop sets here are compile-time constants (pose0+speedbias0, or
    pose[W-1]), so the mm block is extracted by static slicing — no masking
    shims whose spurious eigenvalues could degenerate with the real spectrum.
    """
    import numpy as onp

    D = H.shape[0]
    idx = onp.asarray(drop_idx, onp.int64)
    keep_mask = onp.ones(D, bool)
    keep_mask[idx] = False
    keep_v = jnp.asarray(~keep_mask, H.dtype)  # 1 on dropped
    keep_r = jnp.asarray(keep_mask, H.dtype)  # 1 on kept

    Amm = H[jnp.ix_(idx, idx)]
    Amm = 0.5 * (Amm + Amm.T)
    w, V = jnp.linalg.eigh(Amm)
    # Relative eigenvalue threshold: with sqrt_info^2 scales the spectrum
    # spans ~[0, 1e7]; an absolute eps would keep numerically-noisy near-null
    # directions whose pseudo-inverse injects junk into the prior.
    thr = jnp.maximum(jnp.max(jnp.abs(w)) * 1e-12, EPS)
    inv_w = jnp.where(w > thr, 1.0 / jnp.maximum(w, thr), 0.0)
    Amm_inv = (V * inv_w[None, :]) @ V.T

    Hm = H[:, idx]  # [D, m]
    bm = b[idx]
    H_new = H - Hm @ Amm_inv @ Hm.T
    b_new = b - Hm @ (Amm_inv @ bm)
    # Zero the eliminated rows/cols exactly.
    H_new = H_new * keep_r[:, None] * keep_r[None, :]
    b_new = b_new * keep_r
    return H_new, b_new


def _sqrt_factorize(H, b):
    """H = Jᵀ J, b = Jᵀ r recovery (marginalization_factor.cpp:283-291)."""
    Hs = 0.5 * (H + H.T)
    w, V = jnp.linalg.eigh(Hs)
    thr = jnp.maximum(jnp.max(w) * 1e-10, EPS)
    S = jnp.where(w > thr, w, 0.0)
    S_inv = jnp.where(w > thr, 1.0 / jnp.maximum(w, thr), 0.0)
    J = jnp.sqrt(S)[:, None] * V.T
    r = (jnp.sqrt(S_inv)[:, None] * V.T) @ b
    return J, r


def _drop_idx_old(n_frames: int):
    """Static dropped indices for MARGIN_OLD: pose0 (6) + speedbias0 (9)."""
    return tuple(range(pose_off(0), pose_off(0) + 6)) + tuple(
        range(sb_off(0, n_frames), sb_off(0, n_frames) + 9)
    )


def _shift_prior_blocks(J, r, n_frames: int):
    """Re-index prior columns for the window slide: new slot k = old slot k+1
    for both pose and speed-bias blocks; the refreshed last slot gets zero
    columns (it is a brand-new frame with no prior information)."""
    D = J.shape[1]  # 15*n_frames + 6*n_cams + 1 (n_cams-agnostic)
    perm = []
    for k in range(n_frames - 1):
        perm.extend(range(pose_off(k + 1), pose_off(k + 1) + 6))
    perm.extend([pose_off(0) + i for i in range(6)])  # dead cols (will be zero)
    for k in range(n_frames - 1):
        perm.extend(range(sb_off(k + 1, n_frames), sb_off(k + 1, n_frames) + 9))
    perm.extend([sb_off(0, n_frames) + i for i in range(9)])
    perm.extend(range(15 * n_frames, D))  # ex + td unchanged
    perm = jnp.asarray(perm)
    J_shift = J[:, perm]
    # Zero the refreshed slot explicitly (its source cols were the dropped
    # frame-0 blocks, eliminated to zero already — this is belt & braces).
    J_shift = J_shift.at[:, pose_off(n_frames - 1) : pose_off(n_frames - 1) + 6].set(0.0)
    J_shift = J_shift.at[
        :, sb_off(n_frames - 1, n_frames) : sb_off(n_frames - 1, n_frames) + 9
    ].set(0.0)
    return J_shift, r


def _shift_state_snapshot(state: WindowState):
    """Snapshot x0 with frame blocks shifted down by one (slide-old)."""
    roll = lambda a: jnp.concatenate([a[1:], a[-1:]], axis=0)
    return WindowState(
        p=roll(state.p), q=roll(state.q), v=roll(state.v),
        ba=roll(state.ba), bg=roll(state.bg),
        tic=state.tic, qic=state.qic, td=state.td,
        inv_depth=state.inv_depth,
    )


def marginalize_old(
    state: WindowState,
    grid: FeatureGrid,
    pre0,
    sqrt_info_imu0,
    imu0_valid,
    prior: PriorFactor,
    gravity,
    cfg: SolverConfig,
):
    """MARGIN_OLD: marginalize frame 0 and its anchored landmarks; return the
    new PriorFactor already re-indexed for the slid window."""
    n_frames = state.p.shape[0]
    dtype = state.p.dtype

    # Restrict projection factors to features anchored at frame 0 by shrinking
    # the 'used' mask; reuse the solver's assembly.
    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    # Single-interval IMU factor: mask all but interval 0.
    imu_valid = jnp.zeros_like(imu0_valid).at[0].set(imu0_valid[0])

    H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
        state, grid0, pre0, sqrt_info_imu0, imu_valid, prior, gravity, cfg
    )

    # Eliminate the anchored inverse depths analytically (diagonal block).
    drop_f = grid0.used & (H_ll > EPS)
    inv_Hll = jnp.where(drop_f, 1.0 / jnp.maximum(H_ll, EPS), 0.0)
    H_pp = H_pp - (H_pl * inv_Hll[None, :]) @ H_pl.T
    b_p = b_p - H_pl @ (inv_Hll * b_l)

    # Eliminate pose0 + speedbias0.
    H_new, b_new = _eliminate_indices(H_pp, b_p, _drop_idx_old(n_frames))
    J, r = _sqrt_factorize(H_new, b_new)
    J, r = _shift_prior_blocks(J, r, n_frames)
    x0 = _shift_state_snapshot(state)
    return PriorFactor.from_state(J, r, x0)


# --------------------------------------------------------------------------
# Square-root (QR) marginalization — the production path.
#
# The eigh-based functions above mirror the reference's H-space Schur
# elimination; they are precision-hungry because forming H = JᵀJ squares the
# condition number (needs f64). The QR formulation below works directly on
# the stacked whitened Jacobian rows: column-order the system
# [dropped | kept | r], take the R factor of a Householder QR, and the rows
# below the dropped block ARE the marginal square-root prior on the kept
# variables — no eigendecomposition, no H, f32-safe (κ(A) = √κ(H)). The
# elimination is exact even when the dropped block is rank-deficient (the
# gauge directions): QR never divides by a pivot.
# --------------------------------------------------------------------------


def _keep_drop_indices(n_frames: int, D: int):
    """Static (numpy) kept/dropped column indices for MARGIN_OLD."""
    import numpy as onp

    drop = onp.asarray(_drop_idx_old(n_frames), onp.int64)
    keep_mask = onp.ones(D, bool)
    keep_mask[drop] = False
    keep = onp.nonzero(keep_mask)[0]
    return drop, keep


def marginalize_old_qr(
    state: WindowState,
    grid: FeatureGrid,
    pre0,
    sqrt_info_imu0,
    imu0_valid,
    prior: PriorFactor,
    gravity,
    cfg: SolverConfig,
):
    """MARGIN_OLD via QR on stacked whitened rows (f32-safe device path).

    Same factor set as marginalize_old: old prior + IMU(0,1) + projection
    factors anchored at frame 0; drops {pose0, speedbias0, anchored inverse
    depths}; returns the new PriorFactor re-indexed for the slid window.
    """
    n_frames = state.p.shape[0]
    dtype = state.p.dtype
    F, W1 = grid.valid.shape
    D = pose_dim(n_frames, n_cams_of(state))

    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))
    imu_valid = jnp.zeros_like(imu0_valid).at[0].set(imu0_valid[0])

    res_w, Jfull, J_lam, _, _ = linearize_proj_rows(state, grid0, cfg)
    imu_res, Jimu, _ = linearize_imu_rows(
        state, pre0, sqrt_info_imu0, imu_valid, gravity
    )
    rp = prior_residual(state, prior)
    Jp = jnp.where(prior.valid, prior.J, jnp.zeros_like(prior.J))

    R1 = F * W1 * 2
    W = W1 - 1
    # Depth columns: row (f, j, a) touches depth col f only.
    eyeF = jnp.eye(F, dtype=dtype)
    dep_rows = jnp.einsum("fja,fg->fjag", J_lam, eyeF).reshape(R1, F)

    A_pose = jnp.concatenate(
        [Jfull.reshape(R1, D), Jimu, Jp], axis=0
    )  # [R, D]
    A_dep = jnp.concatenate(
        [dep_rows, jnp.zeros((W * 15 + D, F), dtype)], axis=0
    )  # [R, F]
    r = jnp.concatenate(
        [res_w.reshape(R1), imu_res.reshape(W * 15), rp]
    )  # [R]

    drop, keep = _keep_drop_indices(n_frames, D)
    A = jnp.concatenate(
        [A_pose[:, drop], A_dep, A_pose[:, keep], r[:, None]], axis=1
    )  # [R, 15 + F + K + 1]
    m = len(drop) + F
    K = len(keep)
    Rfac = jnp.linalg.qr(A, mode="r")
    Jk = Rfac[m : m + K, m : m + K]
    rk = Rfac[m : m + K, m + K]

    ok = jnp.isfinite(Jk).all() & jnp.isfinite(rk).all()
    Jk = jnp.where(ok, Jk, 0.0)
    rk = jnp.where(ok, rk, 0.0)

    J = jnp.zeros((D, D), dtype).at[jnp.ix_(jnp.asarray(keep), jnp.asarray(keep))].set(Jk)
    r0 = jnp.zeros((D,), dtype).at[jnp.asarray(keep)].set(rk)
    J, r0 = _shift_prior_blocks(J, r0, n_frames)
    x0 = _shift_state_snapshot(state)
    new_prior = PriorFactor.from_state(J, r0, x0)
    return dataclasses.replace(new_prior, valid=ok)


def marginalize_second_new_qr(state: WindowState, prior: PriorFactor, cfg: SolverConfig):
    """MARGIN_SECOND_NEW via QR: the prior is the only participating factor
    (estimator.cpp:949-1005); drop pose[W-1] and re-index for the
    merge-second-newest slide. Output .valid is False when the input prior
    carries no information."""
    import numpy as onp

    n_frames = prior.x0_p.shape[0]
    D = prior.J.shape[0]  # n_cams-agnostic
    dtype = prior.J.dtype

    rp = prior_residual(state, prior)
    J0 = jnp.where(prior.valid, prior.J, jnp.zeros_like(prior.J))

    drop = onp.arange(pose_off(n_frames - 2), pose_off(n_frames - 2) + 6)
    keep_mask = onp.ones(D, bool)
    keep_mask[drop] = False
    keep = onp.nonzero(keep_mask)[0]
    K = len(keep)

    A = jnp.concatenate([J0[:, drop], J0[:, keep], rp[:, None]], axis=1)
    Rfac = jnp.linalg.qr(A, mode="r")
    Jk = Rfac[6 : 6 + K, 6 : 6 + K]
    rk = Rfac[6 : 6 + K, 6 + K]
    ok = prior.valid & jnp.isfinite(Jk).all() & jnp.isfinite(rk).all()
    Jk = jnp.where(ok, Jk, 0.0)
    rk = jnp.where(ok, rk, 0.0)

    J = jnp.zeros((D, D), dtype).at[jnp.ix_(jnp.asarray(keep), jnp.asarray(keep))].set(Jk)
    r0 = jnp.zeros((D,), dtype).at[jnp.asarray(keep)].set(rk)

    # Slide: slots 0..W-2 unchanged; slot W-1 takes slot W's columns.
    perm = []
    for k in range(n_frames):
        src = k if k < n_frames - 2 else n_frames - 1  # W-1 <- W, W <- W (dead)
        perm.extend(range(pose_off(src), pose_off(src) + 6))
    for k in range(n_frames):
        src = k if k < n_frames - 2 else n_frames - 1
        perm.extend(range(sb_off(src, n_frames), sb_off(src, n_frames) + 9))
    perm.extend(range(15 * n_frames, D))
    perm = jnp.asarray(perm)
    J = J[:, perm]
    J = J.at[:, pose_off(n_frames - 1) : pose_off(n_frames - 1) + 6].set(0.0)
    J = J.at[
        :, sb_off(n_frames - 1, n_frames) : sb_off(n_frames - 1, n_frames) + 9
    ].set(0.0)

    def merge(a):
        return a.at[n_frames - 2].set(a[n_frames - 1])

    x0 = WindowState(
        p=merge(state.p), q=merge(state.q), v=merge(state.v),
        ba=merge(state.ba), bg=merge(state.bg),
        tic=state.tic, qic=state.qic, td=state.td,
        inv_depth=state.inv_depth,
    )
    new_prior = PriorFactor.from_state(J, r0, x0)
    return dataclasses.replace(new_prior, valid=ok)


def marginalize_second_new(state: WindowState, prior: PriorFactor, cfg: SolverConfig):
    """MARGIN_SECOND_NEW: drop pose[W-1] from the existing prior only
    (estimator.cpp:949-1005). Returns the new prior re-indexed for the
    'merge-second-newest' slide (slot W-1 <- slot W)."""
    n_frames = prior.x0_p.shape[0]
    D = prior.J.shape[0]  # n_cams-agnostic
    dtype = prior.J.dtype

    # Evaluate the prior at the current state and rebuild H, b.
    rp = prior_residual(state, prior)
    J0 = jnp.where(prior.valid, prior.J, jnp.zeros_like(prior.J))
    H = J0.T @ J0
    b = J0.T @ rp

    drop = tuple(range(pose_off(n_frames - 2), pose_off(n_frames - 2) + 6))
    H_new, b_new = _eliminate_indices(H, b, drop)
    J, r = _sqrt_factorize(H_new, b_new)

    # Slide: slots 0..W-2 unchanged; slot W-1 takes slot W's (empty) columns.
    pose_src = list(range(0, pose_off(n_frames - 2))) + list(
        range(pose_off(n_frames - 1), pose_off(n_frames - 1) + 6)
    ) + list(range(pose_off(n_frames - 1), pose_off(n_frames - 1) + 6))
    perm = []
    for k in range(n_frames):
        src = k if k < n_frames - 2 else n_frames - 1  # W-1 <- W, W <- W (dead)
        perm.extend(range(pose_off(src), pose_off(src) + 6))
    for k in range(n_frames):
        src = k if k < n_frames - 2 else n_frames - 1
        perm.extend(range(sb_off(src, n_frames), sb_off(src, n_frames) + 9))
    perm.extend(range(15 * n_frames, D))
    perm = jnp.asarray(perm)
    J = J[:, perm]
    J = J.at[:, pose_off(n_frames - 1) : pose_off(n_frames - 1) + 6].set(0.0)
    J = J.at[
        :, sb_off(n_frames - 1, n_frames) : sb_off(n_frames - 1, n_frames) + 9
    ].set(0.0)

    # x0: slot W-1 takes slot W's values (the surviving newest frame).
    def merge(a):
        return a.at[n_frames - 2].set(a[n_frames - 1])

    x0 = WindowState(
        p=merge(state.p), q=merge(state.q), v=merge(state.v),
        ba=merge(state.ba), bg=merge(state.bg),
        tic=state.tic, qic=state.qic, td=state.td,
        inv_depth=state.inv_depth,
    )
    return PriorFactor.from_state(J, r, x0)
