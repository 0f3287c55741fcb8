"""Keyframe-axis (trajectory-segment) sharded bundle adjustment.

The feature axis (dist/sharding.py) shards one window, whose replicated
per-iteration work bounds its strong scaling. The SECOND scaling axis shards
the TRAJECTORY: a 2-D mesh ``Mesh(devices.reshape(n_kf, n_f), ("kf", "f"))``
where each ``kf`` row
owns a contiguous keyframe SEGMENT — its own window of states, its own
landmark block (features anchored and observed inside the segment), its own
square-root prior — and only segment-BOUNDARY keyframes couple across rows.

Structure of the computation (SCALING.md §2; the reference's absent
pose-graph layer — mindvision.launch:21-27 commented out — replaced by
block-parallel BA):

  * Adjacent segments SHARE their boundary keyframe (last kf of segment s
    is the same physical keyframe as kf 0 of segment s+1); every IMU
    interval and every landmark observation lives in exactly one segment.
  * Each outer round, every segment solves its own windowed BA (the same
    shared ``lm_loop`` as the single-chip and feature-sharded solvers; the
    ``f`` axis shards each segment's landmarks exactly like
    dist/sharding.py — psum'd pose system over ``f``) with the two incoming
    boundary MESSAGES applied as absolute 15-dof Gaussian priors.
  * After each round, segments exchange updated messages with both
    neighbors over the ``kf`` axis (``ppermute``): mean = the sender's current estimate of the shared
    keyframe's (pose, velocity, bias); sqrt-information = the sender-side
    marginal from [its own factors + the message it received from its
    OTHER neighbor] — Gaussian belief propagation on the keyframe chain.
    Because a chain is a tree, BP converges to the exact joint marginals
    of the linearized problem (re-linearized every round); the echo-free
    message rule is what makes the fixed point the joint optimum rather
    than a finite-weight consensus compromise.
  * A few KB per boundary per round: latency-tolerant by construction, so
    the ``kf`` axis may also span hosts. On one all-to-all NVLink host the
    device order of the mesh does not matter; the axes follow the algorithm.

Consistency is tested against ONE monolithic lm_solve over the whole
trajectory (tests/test_kf_axis.py) — the segmented fixed point matches the
joint optimum to sub-centimeter on a multi-meter trajectory.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..backend.state import (
    WindowState, FeatureGrid, PriorFactor, SolverConfig, pose_dim, n_cams_of,
)
from ..backend.solver import (
    assemble_normal_equations, total_cost, lm_loop,
)
from ..backend.triangulate import triangulate_grid
from ..geom import quat_mul, quat_conj, so3_log
from ..imu import preintegrate_parallel, whiten_covariance


def make_kf_mesh(n_kf: int, n_f: int, devices=None):
    """2-D mesh: ``kf`` (trajectory segments) × ``f`` (feature shards)."""
    devices = devices if devices is not None else jax.devices()
    if len(devices) < n_kf * n_f:
        raise ValueError(
            f"need {n_kf * n_f} devices for a {n_kf}x{n_f} mesh, "
            f"have {len(devices)}"
        )
    return Mesh(
        np.array(devices[: n_kf * n_f]).reshape(n_kf, n_f), ("kf", "f")
    )


def _first15_selector(D, W1, dtype):
    """E [15, D]: rows selecting keyframe 0's (δp, δθ, δv, δba, δbg)."""
    E = np.zeros((15, D), np.float64)
    for k in range(6):
        E[k, k] = 1.0
    off = 6 * W1
    for k in range(9):
        E[6 + k, off + k] = 1.0
    return jnp.asarray(E, dtype)


def _last15_idx(D, W1):
    """Indices of the LAST keyframe's 15-dof block in the local layout."""
    W = W1 - 1
    return np.concatenate([
        np.arange(6 * W, 6 * W + 6),
        np.arange(6 * W1 + 9 * W, 6 * W1 + 9 * W + 9),
    ])


def _idx15(D, W1, first: bool):
    if first:
        return np.concatenate([np.arange(6), np.arange(6 * W1, 6 * W1 + 9)])
    return _last15_idx(D, W1)


def _kf15(state, j):
    """(p, q, v, ba, bg) of keyframe j as one tuple."""
    return (state.p[j], state.q[j], state.v[j], state.ba[j], state.bg[j])


def _res15(copy, z):
    """15-dof local difference copy ⊖ z between two keyframe summaries:
    [p − p_z, Log(q_z⁻¹ q), v − v_z, ba − ba_z, bg − bg_z]."""
    dth = so3_log(quat_mul(quat_conj(z[1]), copy[1]))
    return jnp.concatenate([
        copy[0] - z[0], dth, copy[2] - z[2], copy[3] - z[3], copy[4] - z[4],
    ])


def _boundary_residual(state, j, target):
    """Message residual of keyframe j against the neighbor's belief:
    x_j ⊖ μ_msg, whitened by the message's sqrt-information. Gaussian
    belief propagation on the segment chain — exact on trees."""
    return _res15(_kf15(state, j), target)


def _retract15(copy, dx):
    """Retract a 15-dof local correction onto a keyframe summary."""
    from ..geom import so3_exp

    p, q, v, ba, bg = copy
    q2 = quat_mul(q, so3_exp(dx[3:6]))
    q2 = q2 / jnp.linalg.norm(q2)
    return (p + dx[0:3], q2, v + dx[6:9], ba + dx[9:12], bg + dx[12:15])


def _marginal15(H_red, idx, dtype, eps=1e-9):
    """(sqrt, marg) of the 15×15 marginal information of the block `idx`
    inside the reduced (depth-eliminated) Hessian: Schur complement onto
    the block, then a symmetric eigen square-root (negative directions —
    far-from-convergence rounds — are clipped rather than NaN'd)."""
    D = H_red.shape[0]
    rest = jnp.asarray(
        np.setdiff1d(np.arange(D), idx), jnp.int32
    )
    idx = jnp.asarray(idx, jnp.int32)
    H_bb = H_red[jnp.ix_(idx, idx)]
    H_br = H_red[jnp.ix_(idx, rest)]
    H_rr = H_red[jnp.ix_(rest, rest)]
    n_r = H_rr.shape[0]
    H_rr = H_rr + eps * jnp.eye(n_r, dtype=dtype)
    sol = jnp.linalg.solve(H_rr, H_br.T)
    marg = H_bb - H_br @ sol
    marg = 0.5 * (marg + marg.T) + eps * jnp.eye(15, dtype=dtype)
    w, V = jnp.linalg.eigh(marg)
    # RELATIVE floor: an absolute eps floor leaves near-null directions at
    # ~eps, and the echo-correction solve dμ = marg⁻¹g then amplifies any
    # gradient component there by 1/eps — measured as a round-over-round
    # mean explosion. Flooring at a fraction of the largest eigenvalue
    # bounds the amplification instead.
    w = jnp.clip(w, jnp.maximum(eps, 1e-6 * jnp.max(w)), None)
    marg_pd = (V * w[None, :]) @ V.T
    sqrt_pd = (V * jnp.sqrt(w)[None, :]) @ V.T
    return sqrt_pd, marg_pd


def segmented_trajectory_solve(
    mesh: Mesh,
    states: WindowState,           # [S, W1, ...] batched over segments
    grids: FeatureGrid,            # [S, F, W1, ...]
    dts, accs, gyrs, a0, g0, imu_valid,   # [S, W, M(,3)] / [S, W]
    priors: PriorFactor,           # [S, ...] per-segment priors
    imu_noise,
    cfg: SolverConfig,
    g_norm: float = 9.81,
    n_outer: int = 4,
    boundary_weight: float = 1.0,
):
    """Solve S trajectory segments in parallel over the ``kf`` mesh axis
    (features sharded over ``f``), with bidirectional Gaussian-BP boundary
    message exchange between rounds (converges in ~O(S) rounds on the
    chain). boundary_weight scales the message sqrt-infos (1.0 = exact BP).
    Returns (states_out [S, ...], boundary_gap [S] — final ‖mismatch‖ of
    each shared keyframe pair, costs [S, 2] initial/final of the last
    round, history [S, 2, n_outer] — per-round (boundary gap,
    ‖echo-correction‖) for convergence diagnostics)."""
    S = mesh.shape["kf"]
    n_f = mesh.shape["f"]
    dtype = states.p.dtype
    F = grids.valid.shape[1]
    W1 = grids.valid.shape[2]
    C = n_cams_of(dataclasses.replace(states, tic=states.tic[0],
                                      qic=states.qic[0]))
    D = pose_dim(W1, C)
    gravity = jnp.asarray([0.0, 0.0, g_norm], dtype)
    E15 = _first15_selector(D, W1, dtype)
    idxF = _idx15(D, W1, first=True)
    idxL = _idx15(D, W1, first=False)
    EL = jnp.zeros((15, D), dtype).at[
        jnp.arange(15), jnp.asarray(idxL)
    ].set(1.0)
    inv_sqrt_nf = 1.0 / (n_f ** 0.5)

    state_specs = WindowState(
        p=P("kf"), q=P("kf"), v=P("kf"), ba=P("kf"), bg=P("kf"),
        tic=P("kf"), qic=P("kf"), td=P("kf"), inv_depth=P("kf", "f"),
    )
    grid_specs = FeatureGrid(
        bearing=P("kf", "f"), velocity=P("kf", "f"), td_obs=P("kf", "f"),
        valid=P("kf", "f"), anchor=P("kf", "f"), used=P("kf", "f"),
        cam=P("kf", "f") if grids.cam is not None else None,
    )
    prior_specs = jax.tree_util.tree_map(lambda _: P("kf"), priors)

    def sq0(t):
        return jax.tree_util.tree_map(lambda x: x[0], t)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(state_specs, grid_specs, P("kf"), P("kf"), P("kf"),
                  P("kf"), P("kf"), P("kf"), prior_specs),
        out_specs=(state_specs, P("kf"), P("kf"), P("kf")),
        check_vma=False,
    )
    def run(st_b, g_b, dts_b, accs_b, gyrs_b, a0_b, g0_b, iv_b, pr_b):
        st = sq0(st_b)
        g = sq0(g_b)
        pr = sq0(pr_b)
        dts_, accs_, gyrs_ = dts_b[0], accs_b[0], gyrs_b[0]
        a0_, g0_, iv_ = a0_b[0], g0_b[0], iv_b[0]
        kf_rank = jax.lax.axis_index("kf")

        pre = jax.vmap(
            lambda d, ac, gy, a_0, g_0, ba, bg: preintegrate_parallel(
                d, ac, gy, a_0, g_0, ba, bg, imu_noise
            )
        )(dts_, accs_, gyrs_, a0_, g0_, st.ba[:-1], st.bg[:-1])
        sqrt_info, imu_ok = whiten_covariance(pre.covariance, iv_)

        inv_d = triangulate_grid(st, g, jnp.zeros((g.valid.shape[0],), bool))
        st = dataclasses.replace(st, inv_depth=inv_d)

        # Replicated-factor scaling over the f axis (see dist/sharding.py):
        # IMU + prior + boundary factors touch only pose blocks; evaluated
        # on every f shard with 1/√n_f weights so the psum yields one copy.
        si_s = sqrt_info * inv_sqrt_nf
        pr_s = dataclasses.replace(
            pr, J=pr.J * inv_sqrt_nf, r0=pr.r0 * inv_sqrt_nf
        )

        def boundary_terms(s, bnd):
            """(H_add, b_add, cost) of the two incoming BP messages.
            bnd = (μ_first, W_first, w_first, μ_last, W_last, w_last):
            each message is an absolute 15-dof Gaussian on the shared
            boundary keyframe — mean = the neighbor's current estimate of
            it, sqrt-info = the neighbor's marginal EXCLUDING what it
            previously heard from this segment (no echo)."""
            zF, WFm, wF, zL, WLm, wL = bnd
            rF = _boundary_residual(s, 0, zF)
            rL = _boundary_residual(s, W1 - 1, zL)
            WF = (wF * inv_sqrt_nf) * WFm   # [15,15] sqrt-info
            WL = (wL * inv_sqrt_nf) * WLm
            JF = WF @ E15
            JL = WL @ EL
            rFw = WF @ rF
            rLw = WL @ rL
            H_add = JF.T @ JF + JL.T @ JL
            b_add = JF.T @ rFw + JL.T @ rLw
            cost = 0.5 * (jnp.sum(rFw * rFw) + jnp.sum(rLw * rLw))
            return H_add, b_add, cost

        def make_fns(bnd):
            def lin_fn(sc, zeros_like=False):
                if zeros_like:
                    z = jnp.zeros
                    return (z((D, D), dtype), z((D, F // n_f), dtype),
                            z((F // n_f,), dtype), z((D,), dtype),
                            z((F // n_f,), dtype))
                H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
                    sc, g, pre, si_s, imu_ok, pr_s, gravity, cfg
                )
                H_add, b_add, _ = boundary_terms(sc, bnd)
                H_pp = jax.lax.psum(H_pp + H_add, "f")
                b_p = jax.lax.psum(b_p + b_add, "f")
                return H_pp, H_pl, H_ll, b_p, b_l

            def solve_fn(lin, lam):
                H_pp, H_pl, H_ll, b_p, b_l = lin
                used_ok = g.used & (H_ll > 1e-12)
                H_ll_safe = jnp.where(used_ok, H_ll, 1.0)
                b_l_safe = jnp.where(used_ok, b_l, 0.0)
                H_pl_safe = jnp.where(used_ok[None, :], H_pl, 0.0)
                inv_Hll = 1.0 / (H_ll_safe * (1.0 + lam))
                Sm = jax.lax.psum(
                    (H_pl_safe * inv_Hll[None, :]) @ H_pl_safe.T, "f"
                )
                c = jax.lax.psum(H_pl_safe @ (inv_Hll * b_l_safe), "f")
                H_red = H_pp - Sm
                b_red = b_p - c
                diag = jnp.clip(jnp.diag(H_pp), 1e-6, 1e32)
                L = jnp.linalg.cholesky(
                    H_red + lam * jnp.diag(diag)
                    + 1e-10 * jnp.eye(D, dtype=dtype)
                )
                dx = -jax.scipy.linalg.cho_solve((L, True), b_red)
                dlam = -inv_Hll * (b_l_safe + H_pl_safe.T @ dx)
                return dx, dlam

            def cost_fn(sc):
                base = total_cost(
                    sc, g, pre, si_s, imu_ok, pr_s, gravity, cfg
                )
                _, _, bc = boundary_terms(sc, bnd)
                return jax.lax.psum(base + bc, "f")

            return lin_fn, solve_fn, cost_fn

        # Gaussian belief propagation on the segment chain: each round,
        # every segment solves its window with the two incoming boundary
        # messages as absolute Gaussian priors, then sends UPDATED messages
        # outward. A message to the RIGHT neighbor is the marginal of the
        # shared keyframe under [own factors + the message received from
        # the LEFT] — i.e. everything on the sender's side of the chain,
        # excluding only the echo of what the receiver itself contributed.
        # On a chain (a tree), BP converges to the exact joint marginals of
        # the linearized problem; re-linearizing each round makes it the
        # nonlinear block solver.
        eyeW = jnp.eye(15, dtype=dtype)
        # Cyclic permutations so every rank receives a well-formed message;
        # the wrap-around edges (rank S-1 -> 0 and 0 -> S-1) carry zero
        # weight (w_first_m / w_last_m), so the solve is an open chain.
        fwd = [(i, (i + 1) % S) for i in range(S)]
        bwd = [(i, (i - 1) % S) for i in range(S)]
        w_first_m = jnp.where(kf_rank > 0, boundary_weight, 0.0).astype(dtype)
        w_last_m = jnp.where(
            kf_rank < S - 1, boundary_weight, 0.0
        ).astype(dtype)

        def outer_round(carry, round_idx):
            st, bnd = carry
            zF, WFm, wF, zL, WLm, wL = bnd
            lin_fn, solve_fn, cost_fn = make_fns(bnd)
            st, c0_r, c1_r, _ = lm_loop(st, lin_fn, solve_fn, cost_fn, cfg)
            # Reduced own-factor Hessian at the solution (depth-eliminated).
            H_pp, H_pl, H_ll, b_p, b_l, _ = assemble_normal_equations(
                st, g, pre, si_s, imu_ok, pr_s, gravity, cfg
            )
            H_pp = jax.lax.psum(H_pp, "f")
            used_ok = g.used & (H_ll > 1e-12)
            H_pl_safe = jnp.where(used_ok[None, :], H_pl, 0.0)
            inv_Hll = jnp.where(
                used_ok, 1.0 / jnp.where(used_ok, H_ll, 1.0), 0.0
            )
            H_red = H_pp - jax.lax.psum(
                (H_pl_safe * inv_Hll[None, :]) @ H_pl_safe.T, "f"
            )
            # Outgoing message Hessians: own factors + the OPPOSITE side's
            # incoming message (boundary factors touch only pose/sb rows,
            # so they add directly to the reduced system).
            WF_in = (wF * jnp.ones((), dtype)) * WFm
            WL_in = (wL * jnp.ones((), dtype)) * WLm
            JF_in = WF_in @ E15
            JL_in = WL_in @ EL
            H_with_left = H_red + JF_in.T @ JF_in      # for the fwd message
            H_with_right = H_red + JL_in.T @ JL_in     # for the bwd message
            sq_msg_fwd, marg_fwd = _marginal15(H_with_left, idxL, dtype)
            sq_msg_bwd, marg_bwd = _marginal15(H_with_right, idxF, dtype)
            # Echo-free message MEANS: the solved state x* minimizes
            # own + left-msg + right-msg, but the fwd message must carry
            # the minimizer of [own + left] only. The right-message factor
            # acts exactly on the boundary block, so the first-order
            # correction reduces to the (positive-definite) marginal:
            # dμ = marg_[own+left]⁻¹ · ∇f_right(x*)|₁₅. Without it each
            # hop re-counts the receiver's own information in the mean and
            # the chain converges to a biased fixed point (measured ~3 cm
            # at 4 segments).
            rF_at = _boundary_residual(st, 0, zF)
            rL_at = _boundary_residual(st, W1 - 1, zL)
            gF15 = WF_in.T @ (WF_in @ rF_at)
            gL15 = WL_in.T @ (WL_in @ rL_at)

            def capped(dmu, cap=0.3):
                # Trust region on the extrapolation: the first-order
                # echo correction is only locally valid; an unbounded
                # step in a weakly-informed direction ping-pongs between
                # neighbors and diverges.
                n = jnp.linalg.norm(dmu)
                return dmu * jnp.minimum(1.0, cap / jnp.maximum(n, 1e-12))

            dmu_fwd = capped(jnp.linalg.solve(marg_fwd, gL15))
            dmu_bwd = capped(jnp.linalg.solve(marg_bwd, gF15))
            # Exchange means + sqrt-infos over the kf axis: a few KB per
            # boundary per round.
            my_first = _retract15(_kf15(st, 0), dmu_bwd)
            my_last = _retract15(_kf15(st, W1 - 1), dmu_fwd)
            recv_first = jax.tree_util.tree_map(   # prev rank's fwd message
                lambda x: jax.lax.ppermute(x, "kf", fwd),
                my_last + (sq_msg_fwd,),
            )
            recv_last = jax.tree_util.tree_map(    # next rank's bwd message
                lambda x: jax.lax.ppermute(x, "kf", bwd),
                my_first + (sq_msg_bwd,),
            )
            bnd_new = (
                recv_first[:5], recv_first[5] + 1e-4 * eyeW, w_first_m,
                recv_last[:5], recv_last[5] + 1e-4 * eyeW, w_last_m,
            )
            gap_r = jnp.where(
                w_last_m > 0,
                jnp.linalg.norm(my_last[0] - recv_last[0]), 0.0,
            )
            return (st, bnd_new), (c0_r, c1_r, gap_r,
                                   jnp.linalg.norm(dmu_fwd))

        bnd0 = (
            _kf15(st, 0), eyeW, jnp.zeros((), dtype),
            _kf15(st, W1 - 1), eyeW, jnp.zeros((), dtype),
        )
        (st, _), (c0_hist, c1_hist, gap_hist, dmu_hist) = jax.lax.scan(
            outer_round, (st, bnd0), jnp.arange(n_outer)
        )
        c0_last, c1_last = c0_hist[-1], c1_hist[-1]

        # Final boundary gap: ‖my last kf − received next-segment first kf‖
        # (position part), for convergence diagnostics.
        nxt_first = jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, "kf", bwd), (st.p[0],)
        )[0]
        gap = jnp.where(
            kf_rank < S - 1,
            jnp.linalg.norm(st.p[W1 - 1] - nxt_first),
            0.0,
        )
        st_out = jax.tree_util.tree_map(lambda x: x[None], st)
        return (st_out, gap[None], jnp.stack([c0_last, c1_last])[None],
                jnp.stack([gap_hist, dmu_hist])[None])

    return run(states, grids, dts, accs, gyrs, a0, g0, imu_valid, priors)
