"""Sliding-window bundle-adjustment solver (dense Schur + Levenberg-Marquardt).

Replaces the reference's Ceres DENSE_SCHUR/DOGLEG solve
(estimator.cpp:810-825) with a batched, static-shape pipeline:

  1. Per-factor Jacobians by *forward-mode autodiff on the tangent
     perturbation*, vmapped over the dense [F, W+1] observation grid — the
     batched equivalent of ProjectionTdFactor::Evaluate's analytic Jacobians.
  2. Block assembly into dense normal equations via one-hot contractions
     (no scatters): H_pp [D,D], H_pl [D,F], diagonal H_ll [F], with
     D = 15*(W+1)+7 = 172 local dims.
  3. Schur elimination of the inverse-depth block (diagonal), one dense
     Cholesky solve of the 172×172 reduced system.
  4. Levenberg-Marquardt with accept/reject inside a lax.scan, capped at the
     reference's 8 iterations.

The 4-DoF gauge freedom (global yaw + position) is handled like the
reference: the prior pins what it can, LM damping bounds the null directions,
and the host applies the yaw-gauge fix after the solve (estimator.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geom import so3_exp, quat_mul, quat_normalize
from .state import (
    WindowState,
    FeatureGrid,
    PriorFactor,
    SolverConfig,
    pose_dim,
    ex_2d,
    n_cams_of,
)
from .factors import (
    projection_residual_single,
    imu_residuals_window,
    prior_residual,
    cauchy_corrector,
)
from ..geom import tangent_basis
from ..imu import imu_residual as _imu_residual_single


def apply_delta(state: WindowState, dx, dlam, cfg: SolverConfig):
    """Retract the full tangent step onto the state (right-multiplicative
    quaternion update, cf. PoseLocalParameterization::Plus)."""
    n_frames = state.p.shape[0]
    C = n_cams_of(state)
    pose_part = dx[: 6 * n_frames].reshape(n_frames, 6)
    sb_part = dx[6 * n_frames : 15 * n_frames].reshape(n_frames, 9)
    dex = dx[15 * n_frames : 15 * n_frames + 6 * C].reshape(C, 6)
    dtd = dx[-1]
    if cfg.estimate_extrinsic:
        tics, qics = ex_2d(state.tic, state.qic)
        new_tic = tics + dex[:, 0:3]
        new_qic = quat_normalize(quat_mul(qics, so3_exp(dex[:, 3:6])))
        if state.tic.ndim == 1:
            new_tic, new_qic = new_tic[0], new_qic[0]
    else:
        new_tic, new_qic = state.tic, state.qic
    return WindowState(
        p=state.p + pose_part[:, 0:3],
        q=quat_normalize(quat_mul(state.q, so3_exp(pose_part[:, 3:6]))),
        v=state.v + sb_part[:, 0:3],
        ba=state.ba + sb_part[:, 3:6],
        bg=state.bg + sb_part[:, 6:9],
        tic=new_tic,
        qic=new_qic,
        td=state.td + dtd if cfg.estimate_td else state.td,
        inv_depth=state.inv_depth + dlam,
    )


def _proj_local_residual(
    dlocal, p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j, inv_dep, td,
    pts_i, pts_j, vel_i, vel_j, td_obs_i, td_obs_j, tb, sqrt_info,
):
    """Projection residual as a function of the 26-dim local perturbation
    [δpose_i(6), δpose_j(6), δex_i(6), δex_j(6), δλ(1), δtd(1)].

    The anchor-side (ex_i) and observation-side (ex_j) extrinsics are
    perturbed SEPARATELY; when both observations come from the same camera
    the two Jacobian blocks are scattered into the same columns and add —
    exactly the chain-rule total derivative the mono formulation computed
    with one shared perturbation."""
    p_i2 = p_i + dlocal[0:3]
    q_i2 = quat_mul(q_i, so3_exp(dlocal[3:6]))
    p_j2 = p_j + dlocal[6:9]
    q_j2 = quat_mul(q_j, so3_exp(dlocal[9:12]))
    tic_i2 = tic_i + dlocal[12:15]
    qic_i2 = quat_mul(qic_i, so3_exp(dlocal[15:18]))
    tic_j2 = tic_j + dlocal[18:21]
    qic_j2 = quat_mul(qic_j, so3_exp(dlocal[21:24]))
    lam2 = inv_dep + dlocal[24]
    td2 = td + dlocal[25]
    return projection_residual_single(
        p_i2, q_i2, p_j2, q_j2, tic_i2, qic_i2, tic_j2, qic_j2, lam2, td2,
        pts_i, pts_j, vel_i, vel_j, td_obs_i, td_obs_j, tb, sqrt_info,
    )


def _imu_local_residual(dlocal, pre_k, si, p0, q0, v0, ba0, bg0, p1, q1, v1, ba1, bg1, gravity):
    """IMU residual as a function of the 30-dim local perturbation
    [δpose_i(6), δsb_i(9), δpose_j(6), δsb_j(9)]."""
    p0n = p0 + dlocal[0:3]
    q0n = quat_mul(q0, so3_exp(dlocal[3:6]))
    v0n = v0 + dlocal[6:9]
    ba0n = ba0 + dlocal[9:12]
    bg0n = bg0 + dlocal[12:15]
    p1n = p1 + dlocal[15:18]
    q1n = quat_mul(q1, so3_exp(dlocal[18:21]))
    v1n = v1 + dlocal[21:24]
    ba1n = ba1 + dlocal[24:27]
    bg1n = bg1 + dlocal[27:30]
    r = _imu_residual_single(
        pre_k, p0n, q0n, v0n, ba0n, bg0n, p1n, q1n, v1n, ba1n, bg1n, gravity
    )
    return si @ r


def linearize_projection(state: WindowState, grid: FeatureGrid, cfg: SolverConfig):
    """Residuals + per-factor Jacobians for the whole observation grid.

    Returns (res [F,W1,2], J26 [F,W1,2,26], valid [F,W1], w [F,W1,1]).
    """
    dtype = state.p.dtype
    F, W1 = grid.valid.shape
    onehot = grid.anchor_onehot(dtype)
    p_i = onehot @ state.p
    q_i = onehot @ state.q
    pts_i = jnp.einsum("fw,fwc->fc", onehot, grid.bearing)
    vel_i = jnp.einsum("fw,fwc->fc", onehot, grid.velocity)
    td_obs_i = jnp.einsum("fw,fw->f", onehot, grid.td_obs)
    tb = tangent_basis(grid.bearing)

    # Per-observation camera extrinsics (mono: broadcast of the single one).
    tics, qics = ex_2d(state.tic, state.qic)
    oh_cam = grid.cam_onehot(tics.shape[0], dtype)  # [F, W1, C]
    tic_j = jnp.einsum("fwc,cd->fwd", oh_cam, tics)
    qic_j = jnp.einsum("fwc,cd->fwd", oh_cam, qics)
    tic_i = jnp.einsum("fw,fwd->fd", onehot, tic_j)
    qic_i = jnp.einsum("fw,fwd->fd", onehot, qic_j)

    sqrt_info = jnp.asarray(cfg.proj_sqrt_info, dtype)
    zero26 = jnp.zeros((26,), dtype)

    def both(p_i, q_i, pts_i, vel_i, td_obs_i, tic_i, qic_i,
             p_j, q_j, pts_j, vel_j, td_obs_j, tic_j, qic_j, tb_j, lam):
        fn = lambda d: _proj_local_residual(
            d, p_i, q_i, p_j, q_j, tic_i, qic_i, tic_j, qic_j, lam, state.td,
            pts_i, pts_j, vel_i, vel_j, td_obs_i, td_obs_j, tb_j, sqrt_info,
        )
        return fn(zero26), jax.jacfwd(fn)(zero26)

    over_frames = jax.vmap(
        both,
        in_axes=(None, None, None, None, None, None, None,
                 0, 0, 0, 0, 0, 0, 0, 0, None),
    )
    over_feats = jax.vmap(
        over_frames,
        in_axes=(0, 0, 0, 0, 0, 0, 0, None, None, 0, 0, 0, 0, 0, 0, 0),
    )
    res, J26 = over_feats(
        p_i, q_i, pts_i, vel_i, td_obs_i, tic_i, qic_i,
        state.p, state.q, grid.bearing, grid.velocity, grid.td_obs,
        tic_j, qic_j, tb,
        state.inv_depth,
    )

    frame_idx = jnp.arange(W1)[None, :]
    valid = grid.valid & (frame_idx != grid.anchor[:, None]) & grid.used[:, None]
    res = jnp.where(valid[..., None], res, 0.0)
    J26 = jnp.where(valid[..., None, None], J26, 0.0)
    w = cauchy_corrector(res, valid, cfg.cauchy_c)  # [F,W1,1]
    return res, J26, valid, w


def linearize_proj_rows(state: WindowState, grid: FeatureGrid, cfg: SolverConfig):
    """Whitened, robust-weighted projection rows in the full local layout.

    Returns (res_w [F,W1,2], Jfull [F,W1,2,D], J_lam [F,W1,2], valid [F,W1],
    cost) where Jfull covers the D pose-layout columns and J_lam the
    per-feature inverse-depth column. Shared by the normal-equation assembly
    and the square-root (QR) marginalization.
    """
    dtype = state.p.dtype
    F, W1 = grid.valid.shape
    C = n_cams_of(state)
    D = pose_dim(W1, C)

    res, J26, valid, w = linearize_projection(state, grid, cfg)
    # Robust cost (Cauchy rho) before weighting.
    sq = jnp.sum(res * res, axis=-1)
    c2 = cfg.cauchy_c**2
    cost_proj = 0.5 * jnp.sum(jnp.where(valid, c2 * jnp.log1p(sq / c2), 0.0))
    # IRLS weighting.
    res_w = res * w
    J26 = J26 * w[..., None]

    J_pi = J26[..., 0:6]
    J_pj = J26[..., 6:12]
    J_exi = J26[..., 12:18]
    J_exj = J26[..., 18:24]
    J_lam = J26[..., 24]
    J_td = J26[..., 25]
    if not cfg.estimate_extrinsic:
        J_exi = jnp.zeros_like(J_exi)
        J_exj = jnp.zeros_like(J_exj)
    if not cfg.estimate_td:
        J_td = jnp.zeros_like(J_td)

    onehot = grid.anchor_onehot(dtype)  # [F, W1]
    eyeW = jnp.eye(W1, dtype=dtype)
    # Pose-block rows: [F, W1(obs), 2, W1(block), 6]
    Jpose = jnp.einsum("fjac,jk->fjakc", J_pj, eyeW) + jnp.einsum(
        "fjac,fk->fjakc", J_pi, onehot
    )
    Jpose = Jpose.reshape(F, W1, 2, 6 * W1)
    zeros_sb = jnp.zeros((F, W1, 2, 9 * W1), dtype)
    # Extrinsic columns: scatter anchor-side and obs-side blocks to their
    # cameras' column blocks (camera-major [C, 6] layout). Same-camera
    # observations add, reproducing the mono total derivative exactly.
    oh_cam = grid.cam_onehot(C, dtype)  # [F, W1, C]
    oh_cam_i = jnp.einsum("fw,fwc->fc", onehot, oh_cam)  # [F, C]
    Jex = jnp.einsum("fjac,fjC->fjaCc", J_exj, oh_cam) + jnp.einsum(
        "fjac,fC->fjaCc", J_exi, oh_cam_i
    )
    Jex = Jex.reshape(F, W1, 2, 6 * C)
    Jfull = jnp.concatenate(
        [Jpose, zeros_sb, Jex, J_td[..., None]], axis=-1
    )  # [F, W1, 2, D]
    return res_w, Jfull, J_lam, valid, cost_proj


def linearize_imu_rows(state: WindowState, pre, sqrt_info_imu, imu_valid, gravity):
    """Whitened IMU factor rows in the full local layout.

    Returns (imu_res [W,15], Jimu [W*15, D], cost)."""
    dtype = state.p.dtype
    W1 = state.p.shape[0]
    W = W1 - 1
    C = n_cams_of(state)
    D = pose_dim(W1, C)
    zero30 = jnp.zeros((30,), dtype)

    def imu_both(pre_k, si, p0, q0, v0, ba0, bg0, p1, q1, v1, ba1, bg1):
        fn = lambda d: _imu_local_residual(
            d, pre_k, si, p0, q0, v0, ba0, bg0, p1, q1, v1, ba1, bg1, gravity
        )
        return fn(zero30), jax.jacfwd(fn)(zero30)

    imu_res, imu_J30 = jax.vmap(imu_both)(
        pre, sqrt_info_imu,
        state.p[:-1], state.q[:-1], state.v[:-1], state.ba[:-1], state.bg[:-1],
        state.p[1:], state.q[1:], state.v[1:], state.ba[1:], state.bg[1:],
    )  # [W, 15], [W, 15, 30]
    imu_res = jnp.where(imu_valid[:, None], imu_res, 0.0)
    imu_J30 = jnp.where(imu_valid[:, None, None], imu_J30, 0.0)
    cost_imu = 0.5 * jnp.sum(imu_res * imu_res)

    eyeW = jnp.eye(W1, dtype=dtype)
    eye_i = eyeW[:W]  # interval w -> frame w
    eye_j = eyeW[1:]  # interval w -> frame w+1
    Jp = jnp.einsum("wrc,wk->wrkc", imu_J30[..., 0:6], eye_i) + jnp.einsum(
        "wrc,wk->wrkc", imu_J30[..., 15:21], eye_j
    )
    Jsb = jnp.einsum("wrc,wk->wrkc", imu_J30[..., 6:15], eye_i) + jnp.einsum(
        "wrc,wk->wrkc", imu_J30[..., 21:30], eye_j
    )
    Jimu = jnp.concatenate(
        [
            Jp.reshape(W, 15, 6 * W1),
            Jsb.reshape(W, 15, 9 * W1),
            jnp.zeros((W, 15, 6 * C + 1), dtype),
        ],
        axis=-1,
    ).reshape(W * 15, D)
    return imu_res, Jimu, cost_imu


def assemble_normal_equations(
    state, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg
):
    """Build (H_pp, H_pl, H_ll, b_p, b_l, cost) for the current linearization."""
    F, W1 = grid.valid.shape
    D = pose_dim(W1, n_cams_of(state))
    W = W1 - 1

    # ----- projection factors ------------------------------------------------
    res_w, Jfull, J_lam, valid, cost_proj = linearize_proj_rows(state, grid, cfg)

    R = F * W1 * 2
    Jmat = Jfull.reshape(R, D)
    rvec = res_w.reshape(R)
    H_pp = Jmat.T @ Jmat
    b_p = Jmat.T @ rvec
    H_pl = jnp.einsum("fjad,fja->df", Jfull, J_lam)  # [D, F]
    H_ll = jnp.einsum("fja,fja->f", J_lam, J_lam)  # [F]
    b_l = jnp.einsum("fja,fja->f", J_lam, res_w)  # [F]

    # ----- IMU factors -------------------------------------------------------
    imu_res, Jimu, cost_imu = linearize_imu_rows(
        state, pre, sqrt_info_imu, imu_valid, gravity
    )
    rimu = imu_res.reshape(W * 15)
    H_pp = H_pp + Jimu.T @ Jimu
    b_p = b_p + Jimu.T @ rimu

    # ----- marginalization prior --------------------------------------------
    rp = prior_residual(state, prior)
    Jp_prior = jnp.where(prior.valid, prior.J, jnp.zeros_like(prior.J))
    H_pp = H_pp + Jp_prior.T @ Jp_prior
    b_p = b_p + Jp_prior.T @ rp
    cost_prior = 0.5 * jnp.sum(rp * rp)

    cost = cost_proj + cost_imu + cost_prior
    return H_pp, H_pl, H_ll, b_p, b_l, cost


def total_cost(state, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg):
    """Robust total cost at a state (no Jacobians) — for LM accept/reject."""
    from .factors import projection_residuals_grid

    res, valid = projection_residuals_grid(
        state, grid, jnp.asarray(cfg.proj_sqrt_info, state.p.dtype)
    )
    sq = jnp.sum(res * res, axis=-1)
    c2 = cfg.cauchy_c**2
    cost_proj = 0.5 * jnp.sum(jnp.where(valid, c2 * jnp.log1p(sq / c2), 0.0))
    imu_res = imu_residuals_window(state, pre, sqrt_info_imu, gravity, imu_valid)
    rp = prior_residual(state, prior)
    return cost_proj + 0.5 * jnp.sum(imu_res * imu_res) + 0.5 * jnp.sum(rp * rp)


def _schur_solve(H_pp, H_pl, H_ll, b_p, b_l, lam, used, dtype):
    """Solve the damped system by eliminating the diagonal depth block."""
    D = H_pp.shape[0]
    # Depth slots without information must not move.
    H_ll_safe = jnp.where(used & (H_ll > 1e-12), H_ll, 1.0)
    b_l_safe = jnp.where(used & (H_ll > 1e-12), b_l, 0.0)
    H_pl_safe = jnp.where((used & (H_ll > 1e-12))[None, :], H_pl, 0.0)

    H_ll_d = H_ll_safe * (1.0 + lam)
    inv_Hll = 1.0 / H_ll_d
    H_red = H_pp - (H_pl_safe * inv_Hll[None, :]) @ H_pl_safe.T
    b_red = b_p - H_pl_safe @ (inv_Hll * b_l_safe)

    diag = jnp.clip(jnp.diag(H_pp), 1e-6, 1e32)
    H_damped = H_red + lam * jnp.diag(diag)
    # Gauss-Newton convention: step = -H^-1 b (residual gradient b = Jᵀr).
    L = jnp.linalg.cholesky(
        H_damped + 1e-10 * jnp.eye(D, dtype=dtype)
    )
    dx = -jax.scipy.linalg.cho_solve((L, True), b_red)
    dlam = -inv_Hll * (b_l_safe + H_pl_safe.T @ dx)
    return dx, dlam


def lm_loop(state, lin_fn, solve_fn, cost_fn, cfg: SolverConfig,
            max_iter_dyn=None, apply_fn=None):
    """Generic Levenberg-Marquardt accept/reject loop (shared by the
    single-chip and the feature-sharded solver so their iteration semantics
    stay bit-identical). Three hot-path properties:

      * Linearization REUSE: ``lin_fn`` (the expensive Jacobian assembly)
        runs only when the previous step was accepted; a rejected step
        re-solves the SAME normal equations with more damping (the
        reference's Ceres does exactly this across trust-region retries).
      * Cost-plateau EARLY EXIT: once an accepted step improves the cost by
        less than ``cfg.cost_tol`` (relative — Ceres function_tolerance),
        remaining scan iterations become no-ops via lax.cond, costing ~µs
        instead of a full linearize+solve.
      * DYNAMIC iteration budget: ``max_iter_dyn`` (a device scalar) caps
        the iterations at runtime without recompiling — the host derives it
        from the reference's wall-clock budget `max_solver_time`
        (estimator.cpp:810-825; ×0.8 when marginalizing old).
    """
    if apply_fn is None:
        apply_fn = apply_delta
    dtype = jax.tree_util.tree_leaves(state)[0].dtype
    limit = jnp.asarray(
        cfg.max_iterations if max_iter_dyn is None else max_iter_dyn,
        jnp.int32,
    )

    init_cost = cost_fn(state)
    init_cost = jnp.where(jnp.isfinite(init_cost), init_cost, jnp.inf)
    lam0 = jnp.asarray(cfg.init_lambda, dtype)
    lin0 = lin_fn(state, zeros_like=True)

    def step(carry, it):
        s, lam_damp, cost, lin, need_lin, done = carry
        done = done | (it >= limit)

        def work(_):
            lin_cur = jax.lax.cond(
                need_lin, lambda: lin_fn(s), lambda: lin
            )
            dx, dlam = solve_fn(lin_cur, lam_damp)
            # A non-finite step (singular damped system) must be rejected,
            # not propagated — NaNs would freeze the accept test forever.
            step_ok = jnp.isfinite(dx).all() & jnp.isfinite(dlam).all()
            dx_s = jnp.where(step_ok, dx, 0.0)
            dlam_s = jnp.where(step_ok, dlam, 0.0)
            s_new = apply_fn(s, dx_s, dlam_s, cfg)
            new_cost = cost_fn(s_new)
            new_cost = jnp.where(jnp.isfinite(new_cost), new_cost, jnp.inf)
            accept = step_ok & (new_cost < cost)
            rel_impr = (cost - new_cost) / jnp.maximum(cost, 1e-30)
            conv = accept & (rel_impr < cfg.cost_tol)
            s_next = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), s_new, s
            )
            lam_next = jnp.where(accept, lam_damp * 0.4, lam_damp * 8.0)
            lam_next = jnp.clip(lam_next, 1e-9, 1e6)
            cost_next = jnp.where(accept, new_cost, cost)
            return s_next, lam_next, cost_next, lin_cur, accept, conv

        def skip(_):
            return s, lam_damp, cost, lin, need_lin, done

        s2, lam2, cost2, lin2, need2, done2 = jax.lax.cond(
            done, skip, work, None
        )
        return (s2, lam2, cost2, lin2, need2, done2 | done), cost2

    carry0 = (state, lam0, init_cost, lin0,
              jnp.asarray(True), jnp.asarray(False))
    (state_out, _, final_cost, _, _, _), cost_hist = jax.lax.scan(
        step, carry0, jnp.arange(cfg.max_iterations)
    )
    return state_out, init_cost, final_cost, cost_hist


def lm_solve(
    state: WindowState,
    grid: FeatureGrid,
    pre,
    sqrt_info_imu,
    imu_valid,
    prior: PriorFactor,
    gravity,
    cfg: SolverConfig,
    max_iter_dyn=None,
):
    """Levenberg-Marquardt over the window, ≤ cfg.max_iterations iterations
    (reference: ceres DOGLEG with max 8 iterations and a wall budget,
    estimator.cpp:810-825 — the budget maps to max_iter_dyn, see lm_loop)."""
    dtype = state.p.dtype
    F, W1 = grid.valid.shape
    D = pose_dim(W1, n_cams_of(state))

    def lin_fn(s, zeros_like=False):
        if zeros_like:
            z = jnp.zeros
            return (z((D, D), dtype), z((D, F), dtype), z((F,), dtype),
                    z((D,), dtype), z((F,), dtype))
        H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
            s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg
        )
        return H_pp, H_pl, H_ll, b_p, b_l

    def solve_fn(lin, lam):
        H_pp, H_pl, H_ll, b_p, b_l = lin
        return _schur_solve(H_pp, H_pl, H_ll, b_p, b_l, lam, grid.used, dtype)

    def cost_fn(s):
        return total_cost(s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg)

    return lm_loop(state, lin_fn, solve_fn, cost_fn, cfg, max_iter_dyn)
