"""Synthetic segmented-trajectory problems for the keyframe-axis solver.

Shared by tests/test_kf_axis.py (consistency vs a monolithic solve),
__graft_entry__.dryrun_multichip (2-D kf×f mesh dry run) and
chip_smoke.py --four. Exact measurements: smooth closed-form trajectory,
piecewise-constant world acceleration / body rate IMU between keyframes,
unit bearings of per-segment landmark blocks (tic=0, ric=I), optional
bearing noise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .. import geom
from ..backend.state import (
    WindowState, FeatureGrid, PriorFactor, pose_dim,
)

G_NORM = 9.81
FRAME_DT = 0.25
N_SAMP = 25  # IMU samples per keyframe interval (100 Hz)


def make_traj(K):
    """Keyframe states EXACTLY consistent with piecewise-constant world
    acceleration between keyframes: closed-form velocities, positions by
    exact trapezoid integration (p_{i+1} = p_i + ½(v_i+v_{i+1})·dt — the
    constant-acceleration update). A finite-difference v = gradient(p)
    instead leaves cm-level IMU/state inconsistency that shows up as
    irreducible disagreement between the duplicated boundary keyframes."""
    t = np.arange(K) * FRAME_DT
    v = np.stack([
        0.6 * np.cos(0.5 * t), 0.45 * np.cos(0.35 * t + 0.4),
        0.2 * np.cos(0.8 * t),
    ], -1)
    p = np.zeros((K, 3))
    for i in range(K - 1):
        p[i + 1] = p[i] + 0.5 * (v[i] + v[i + 1]) * FRAME_DT
    theta = np.stack([
        0.10 * np.sin(0.6 * t), 0.12 * np.sin(0.45 * t + 1.0),
        0.3 * np.sin(0.25 * t),
    ], -1)
    q = np.asarray(geom.so3_exp(jnp.asarray(theta)))
    return t, p, v, q


def make_imu_buffers(p, v, q):
    """Raw padded IMU sample buffers [K-1, M(,3)] exactly consistent with
    the trajectory (piecewise-constant world acceleration and body rate)."""
    K = len(p)
    W = K - 1
    M = N_SAMP
    Gv = np.array([0.0, 0.0, G_NORM])
    dts = np.zeros((W, M))
    accs = np.zeros((W, M, 3))
    gyrs = np.zeros((W, M, 3))
    a0 = np.zeros((W, 3))
    g0 = np.zeros((W, 3))
    for i in range(W):
        dt = FRAME_DT / N_SAMP
        a_w = (v[i + 1] - v[i]) / FRAME_DT
        dq = geom.quat_mul(
            geom.quat_conj(jnp.asarray(q[i])), jnp.asarray(q[i + 1])
        )
        omega = np.asarray(geom.so3_log(dq)) / FRAME_DT
        for k in range(N_SAMP + 1):
            s = k / N_SAMP
            qk = geom.quat_mul(
                jnp.asarray(q[i]),
                geom.so3_exp(jnp.asarray(omega * s * FRAME_DT)),
            )
            Rk = np.asarray(geom.quat_to_mat(qk))
            acc = Rk.T @ (a_w + Gv)
            if k == 0:
                a0[i] = acc
                g0[i] = omega
            else:
                dts[i, k - 1] = dt
                accs[i, k - 1] = acc
                gyrs[i, k - 1] = omega
    return dts, accs, gyrs, a0, g0


def seg_landmarks(p, s, Wseg, n_feat, seed=10):
    rng = np.random.default_rng(seed + s)
    mid = p[s * Wseg : s * Wseg + Wseg + 1].mean(0)
    dirs = rng.standard_normal((n_feat, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radius = rng.uniform(3.0, 7.0, (n_feat, 1))
    return mid + dirs * radius


def bearings_for(pts_w, p, q, noise=0.0, rng=None):
    """Unit bearings of pts_w from each keyframe (tic=0, ric=I)."""
    n_feat = len(pts_w)
    K = len(p)
    b = np.zeros((n_feat, K, 3))
    for j in range(K):
        Rj = np.asarray(geom.quat_to_mat(jnp.asarray(q[j])))
        x = (pts_w - p[j]) @ Rj
        bb = x / np.linalg.norm(x, axis=-1, keepdims=True)
        if noise > 0:
            bb = bb + rng.standard_normal(bb.shape) * noise
            bb /= np.linalg.norm(bb, axis=-1, keepdims=True)
        b[:, j] = bb
    return b


def anchor_prior(D, K_frames, anchors, x0_state, dtype=jnp.float64):
    """PriorFactor with diagonal 15-dof anchors {kf_index: weight}."""
    J = np.zeros((D, D))
    for j, w in anchors.items():
        for k in range(6):
            J[6 * j + k, 6 * j + k] = w
        off = 6 * K_frames + 9 * j
        for k in range(9):
            J[off + k, off + k] = w
    return PriorFactor.from_state(
        jnp.asarray(J, dtype), jnp.zeros((D,), dtype), x0_state
    )


def make_state(p, v, q, inv_depth, dtype=jnp.float64):
    K = len(p)
    return WindowState(
        p=jnp.asarray(p, dtype), q=jnp.asarray(q, dtype),
        v=jnp.asarray(v, dtype),
        ba=jnp.zeros((K, 3), dtype), bg=jnp.zeros((K, 3), dtype),
        tic=jnp.zeros((3,), dtype),
        qic=jnp.asarray([1.0, 0, 0, 0], dtype),
        td=jnp.zeros((), dtype),
        inv_depth=jnp.asarray(inv_depth, dtype),
    )


def build_grid(bear, valid, anchor, dtype=jnp.float64):
    n_feat, K = valid.shape
    return FeatureGrid(
        bearing=jnp.asarray(bear, dtype),
        velocity=jnp.zeros((n_feat, K, 3), dtype),
        td_obs=jnp.zeros((n_feat, K), dtype),
        valid=jnp.asarray(valid),
        anchor=jnp.asarray(anchor, jnp.int32),
        used=jnp.ones((n_feat,), bool),
    )


def make_segmented_problem(S, Wseg, Fseg, dtype=jnp.float64, noise=0.0,
                           perturb=0.04, seed=3):
    """Batched per-segment (states, grids, imu buffers, priors) for
    `segmented_trajectory_solve`, plus the underlying ground truth.

    Returns a dict with keys: states, grids, dts, accs, gyrs, a0, g0,
    imu_valid (all batched with leading S), priors, truth (t, p, v, q),
    seg_bear (list), p_init/v_init/q_init (global [K] arrays)."""
    K = S * Wseg + 1
    rng = np.random.default_rng(seed)
    t, p, v, q = make_traj(K)
    dts, accs, gyrs, a0, g0 = make_imu_buffers(p, v, q)
    seg_pts = [seg_landmarks(p, s, Wseg, Fseg) for s in range(S)]
    seg_bear = [
        bearings_for(seg_pts[s], p[s * Wseg : s * Wseg + Wseg + 1],
                     q[s * Wseg : s * Wseg + Wseg + 1], noise, rng)
        for s in range(S)
    ]
    p_init = p + rng.standard_normal(p.shape) * perturb
    p_init[0] = p[0]
    v_init = v + rng.standard_normal(v.shape) * perturb / 2
    q_init = np.asarray(geom.quat_mul(
        jnp.asarray(q),
        geom.so3_exp(jnp.asarray(rng.standard_normal((K, 3)) * 0.005)),
    ))

    W1 = Wseg + 1
    D_seg = pose_dim(W1, 1)
    states, grids, priors = [], [], []
    for s in range(S):
        fr = slice(s * Wseg, s * Wseg + Wseg + 1)
        states.append(make_state(
            p_init[fr], v_init[fr], q_init[fr], np.ones(Fseg), dtype
        ))
        grids.append(build_grid(
            seg_bear[s], np.ones((Fseg, W1), bool),
            np.zeros((Fseg,), np.int32), dtype
        ))
        w0 = 300.0 if s == 0 else 0.3
        tr = make_state(p[fr], v[fr], q[fr], np.ones(Fseg), dtype)
        priors.append(anchor_prior(D_seg, W1, {0: w0}, tr, dtype))
    batch = lambda xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    return dict(
        states=batch(states), grids=batch(grids), priors=batch(priors),
        dts=jnp.asarray(dts.reshape(S, Wseg, -1), dtype),
        accs=jnp.asarray(accs.reshape(S, Wseg, -1, 3), dtype),
        gyrs=jnp.asarray(gyrs.reshape(S, Wseg, -1, 3), dtype),
        a0=jnp.asarray(a0.reshape(S, Wseg, 3), dtype),
        g0=jnp.asarray(g0.reshape(S, Wseg, 3), dtype),
        imu_valid=jnp.ones((S, Wseg), bool),
        truth=(t, p, v, q), seg_bear=seg_bear,
        p_init=p_init, v_init=v_init, q_init=q_init,
    )
