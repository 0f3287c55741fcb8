"""Relocalization factors inside the sliding-window BA.

Reference: Estimator::optimization appends relo projection factors with a
FREE loop-pose parameter block (estimator.cpp:777-808) — for every window
feature matched in the loop frame, a plain unit-sphere ProjectionFactor
between the feature's anchor frame and relo_Pose; after the solve the
jointly-refined relo_Pose yields relo_relative_t/q/yaw (double2vector,
estimator.cpp:605-624).

Design: the solve's local layout is extended by ONE 6-dim block (the
loop pose) to D+6; the relo rows are linearized with the same forward-mode
machinery as the window projection rows, and the augmented system runs
through the shared lm_loop. This is a SEPARATE jitted program from the
hot-path solve (it compiles/runs only while a loop match is active), so the
per-frame path pays nothing for the capability.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..geom import quat_mul, so3_exp, tangent_basis
from .state import (
    WindowState,
    FeatureGrid,
    PriorFactor,
    SolverConfig,
    pose_dim,
    ex_2d,
    n_cams_of,
)
from .factors import projection_residual_single, cauchy_corrector
from .solver import (
    assemble_normal_equations,
    total_cost,
    apply_delta,
    _schur_solve,
    lm_loop,
)


def _relo_local_residual(
    dlocal, p_i, q_i, relo_p, relo_q, tic_i, qic_i, tic0, qic0, lam,
    pts_i, b_loop, tb, sqrt_info,
):
    """Relo residual as a function of the 25-dim local perturbation
    [δpose_i(6), δrelo(6), δex_anchor(6), δex_cam0(6), δλ(1)]. The loop
    image is captured by the PRIMARY camera, so the loop-frame side uses
    camera 0's extrinsic (the reference relo factor passes para_Ex_Pose[0],
    estimator.cpp:799-806) while the anchor side uses the anchor
    observation's camera — on a multi-camera rig these differ. Both carry
    their own perturbation block; for mono rigs the two blocks scatter into
    the same layout columns and sum, which reproduces the reference's
    single shared-extrinsic Jacobian."""
    z = jnp.zeros((3,), dlocal.dtype)
    zero = jnp.zeros((), dlocal.dtype)
    p_i2 = p_i + dlocal[0:3]
    q_i2 = quat_mul(q_i, so3_exp(dlocal[3:6]))
    rp2 = relo_p + dlocal[6:9]
    rq2 = quat_mul(relo_q, so3_exp(dlocal[9:12]))
    tic2 = tic_i + dlocal[12:15]
    qic2 = quat_mul(qic_i, so3_exp(dlocal[15:18]))
    tic02 = tic0 + dlocal[18:21]
    qic02 = quat_mul(qic0, so3_exp(dlocal[21:24]))
    lam2 = lam + dlocal[24]
    return projection_residual_single(
        p_i2, q_i2, rp2, rq2, tic2, qic2, tic02, qic02, lam2, zero,
        pts_i, b_loop, z, z, zero, zero, tb, sqrt_info,
    )


def linearize_relo_rows(state, grid, relo_p, relo_q, relo_bearing, relo_mask,
                        cfg: SolverConfig):
    """Whitened, robust-weighted relo rows in the [D+6] augmented layout.

    Returns (res_w [F,2], Jfull [F,2,D+6], J_lam [F,2], valid [F], cost)."""
    dtype = state.p.dtype
    F, W1 = grid.valid.shape
    C = n_cams_of(state)
    D = pose_dim(W1, C)

    onehot = grid.anchor_onehot(dtype)
    p_i = onehot @ state.p
    q_i = onehot @ state.q
    pts_i = jnp.einsum("fw,fwc->fc", onehot, grid.bearing)
    tics, qics = ex_2d(state.tic, state.qic)
    oh_cam = grid.cam_onehot(C, dtype)
    oh_cam_i = jnp.einsum("fw,fwc->fc", onehot, oh_cam)  # [F, C]
    tic_i = oh_cam_i @ tics
    qic_i = oh_cam_i @ qics

    b_loop = relo_bearing / jnp.maximum(
        jnp.linalg.norm(relo_bearing, axis=-1, keepdims=True), 1e-12
    )
    tb = tangent_basis(b_loop)  # [F, 2, 3]
    sqrt_info = jnp.asarray(cfg.proj_sqrt_info, dtype)
    zero25 = jnp.zeros((25,), dtype)
    tic0, qic0 = tics[0], qics[0]  # loop image: primary camera

    def one(p_i, q_i, pts_i, tic_i, qic_i, b_r, tb_f, lam):
        fn = lambda d: _relo_local_residual(
            d, p_i, q_i, relo_p, relo_q, tic_i, qic_i, tic0, qic0, lam,
            pts_i, b_r, tb_f, sqrt_info,
        )
        return fn(zero25), jax.jacfwd(fn)(zero25)

    res, J25 = jax.vmap(one)(
        p_i, q_i, pts_i, tic_i, qic_i, b_loop, tb, state.inv_depth
    )  # [F, 2], [F, 2, 25]

    valid = relo_mask & grid.used
    res = jnp.where(valid[:, None], res, 0.0)
    J25 = jnp.where(valid[:, None, None], J25, 0.0)
    sq = jnp.sum(res * res, axis=-1)
    c2 = cfg.cauchy_c**2
    cost = 0.5 * jnp.sum(jnp.where(valid, c2 * jnp.log1p(sq / c2), 0.0))
    w = cauchy_corrector(res, valid, cfg.cauchy_c)
    res_w = res * w
    J25 = J25 * w[..., None]

    J_pi = J25[..., 0:6]
    J_relo = J25[..., 6:12]
    J_exi = J25[..., 12:18]
    J_ex0 = J25[..., 18:24]
    J_lam = J25[..., 24]
    if not cfg.estimate_extrinsic:
        J_exi = jnp.zeros_like(J_exi)
        J_ex0 = jnp.zeros_like(J_ex0)

    # Scatter into the augmented layout: the anchor-side block lands in the
    # anchor observation's camera columns, the loop-side block in camera
    # 0's; identical columns (mono, or anchor on cam 0) simply sum.
    oh_cam0 = jnp.zeros_like(oh_cam_i).at[:, 0].set(1.0)
    Jpose = jnp.einsum("fac,fk->fakc", J_pi, onehot).reshape(F, 2, 6 * W1)
    Jex = (
        jnp.einsum("fac,fC->faCc", J_exi, oh_cam_i)
        + jnp.einsum("fac,fC->faCc", J_ex0, oh_cam0)
    ).reshape(F, 2, 6 * C)
    zeros_sb = jnp.zeros((F, 2, 9 * W1), dtype)
    zeros_td = jnp.zeros((F, 2, 1), dtype)
    Jfull = jnp.concatenate(
        [Jpose, zeros_sb, Jex, zeros_td, J_relo], axis=-1
    )  # [F, 2, D+6]
    return res_w, Jfull, J_lam, valid, cost


def _relo_apply(rs, dx, dlam, cfg):
    state, relo_p, relo_q = rs
    D = dx.shape[0] - 6
    s_new = apply_delta(state, dx[:D], dlam, cfg)
    rp = relo_p + dx[D : D + 3]
    rq = quat_mul(relo_q, so3_exp(dx[D + 3 : D + 6]))
    rq = rq / jnp.linalg.norm(rq)
    return (s_new, rp, rq)


def lm_solve_relo(
    state: WindowState,
    grid: FeatureGrid,
    pre,
    sqrt_info_imu,
    imu_valid,
    prior: PriorFactor,
    gravity,
    cfg: SolverConfig,
    relo_p0, relo_q0, relo_bearing, relo_mask,
    max_iter_dyn=None,
):
    """LM over the window PLUS the free loop pose (augmented D+6 system).

    Returns (state_out, relo_p, relo_q, init_cost, final_cost)."""
    dtype = state.p.dtype
    F, W1 = grid.valid.shape
    C = n_cams_of(state)
    D = pose_dim(W1, C)
    D6 = D + 6

    def lin_fn(rs, zeros_like=False):
        if zeros_like:
            z = jnp.zeros
            return (z((D6, D6), dtype), z((D6, F), dtype), z((F,), dtype),
                    z((D6,), dtype), z((F,), dtype))
        s, rp, rq = rs
        H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
            s, grid, pre, sqrt_info_imu, imu_valid, prior, gravity, cfg
        )
        res_w, Jr, Jr_lam, valid, _ = linearize_relo_rows(
            s, grid, rp, rq, relo_bearing, relo_mask, cfg
        )
        R2 = F * 2
        Jr_mat = Jr.reshape(R2, D6)
        rvec = res_w.reshape(R2)
        H6 = jnp.zeros((D6, D6), dtype).at[:D, :D].set(H_pp)
        H6 = H6 + Jr_mat.T @ Jr_mat
        b6 = jnp.zeros((D6,), dtype).at[:D].set(b_p) + Jr_mat.T @ rvec
        H_pl6 = jnp.zeros((D6, F), dtype).at[:D, :].set(H_pl)
        H_pl6 = H_pl6 + jnp.einsum("fad,fa->df", Jr, Jr_lam)
        H_ll6 = H_ll + jnp.einsum("fa,fa->f", Jr_lam, Jr_lam)
        b_l6 = b_l + jnp.einsum("fa,fa->f", Jr_lam, res_w)
        return H6, H_pl6, H_ll6, b6, b_l6

    def solve_fn(lin, lam):
        H6, H_pl6, H_ll6, b6, b_l6 = lin
        return _schur_solve(H6, H_pl6, H_ll6, b6, b_l6, lam, grid.used, dtype)

    def cost_fn(rs):
        s, rp, rq = rs
        base = total_cost(s, grid, pre, sqrt_info_imu, imu_valid, prior,
                          gravity, cfg)
        _, _, _, _, relo_cost = linearize_relo_rows(
            s, grid, rp, rq, relo_bearing, relo_mask, cfg
        )
        return base + relo_cost

    rs0 = (state, jnp.asarray(relo_p0, dtype), jnp.asarray(relo_q0, dtype))
    (s_out, rp_out, rq_out), c0, c1, _ = lm_loop(
        rs0, lin_fn, solve_fn, cost_fn, cfg, max_iter_dyn,
        apply_fn=_relo_apply,
    )
    return s_out, rp_out, rq_out, c0, c1
