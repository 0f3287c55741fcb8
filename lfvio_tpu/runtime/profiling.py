"""Stage-level device profiling for the VIO pipeline — the in-package
equivalent of the reference's TicToc timers + printStatistics
(reference vins_estimator/src/utility/visualization.cpp:65-104).

Methodology: per-call timing dispatches N calls back-to-back and blocks
ONCE at the end, so host↔device synchronization is paid once per stage;
when the program's output feeds its own input (chain_arg) the calls are
data-dependent and the average is device time. Compile time is reported
separately (the first call).

Run:  python -m lfvio_tpu.runtime.profiling [--slots 256] [--iters 8]
Prints the device line and a per-stage table (device ms, compile s). It
refuses to run on a non-GPU device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


def make_window_problem(n_feat=256, dtype=None, n_obs_frames=None, seed=0,
                        imu_samples=32, max_iterations=8,
                        estimate_td=True, estimate_extrinsic=True,
                        with_prior=True):
    """A full-scale, well-posed sliding-window BA problem.

    Production shape by default: 256 feature slots over the 11-frame window
    (the bench rig's configuration), every slot valid across the window,
    informative marginalization prior attached, td/extrinsic estimated.
    Returns (state, grid, raw-imu arrays, prior, gravity, cfg, noise).
    """
    import jax
    import jax.numpy as jnp
    from .. import geom
    from ..backend import WindowState, FeatureGrid, PriorFactor, SolverConfig
    from ..backend.state import NFRAMES, pose_dim
    from ..imu import ImuNoise

    dtype = dtype or jnp.float32
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1.0, NFRAMES)
    p = np.stack([t, 0.15 * np.sin(2 * t), 0.1 * t], -1)
    v = np.gradient(p, t, axis=0)
    theta = np.stack([0.08 * np.sin(3 * t), 0.1 * t, 0.15 * np.sin(2 * t)], -1)
    q = np.asarray(geom.so3_exp(jnp.asarray(theta)))
    dirs = rng.standard_normal((n_feat, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts_w = p.mean(0) + dirs * rng.uniform(3, 8, (n_feat, 1))

    bearings = np.zeros((n_feat, NFRAMES, 3))
    for j in range(NFRAMES):
        Rj = np.asarray(geom.quat_to_mat(jnp.asarray(q[j])))
        pc = (pts_w - p[j]) @ Rj
        bearings[:, j] = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    valid = np.ones((n_feat, NFRAMES), bool)
    if n_obs_frames is not None:
        # Realistic track-length distribution: each feature observed in a
        # contiguous run of n_obs_frames frames starting at its anchor.
        starts = rng.integers(0, NFRAMES - 2, n_feat)
        for f in range(n_feat):
            valid[f] = False
            valid[f, starts[f]: starts[f] + n_obs_frames] = True
        anchor = starts.astype(np.int32)
    else:
        anchor = np.zeros(n_feat, np.int32)
    grid = FeatureGrid(
        bearing=jnp.asarray(bearings, dtype),
        velocity=jnp.asarray(
            0.01 * rng.standard_normal((n_feat, NFRAMES, 3)), dtype),
        td_obs=jnp.zeros((n_feat, NFRAMES), dtype),
        valid=jnp.asarray(valid),
        anchor=jnp.asarray(anchor),
        used=jnp.ones((n_feat,), bool),
    )
    pc0 = np.einsum(
        "fc,fcd->fd",
        np.ones((n_feat, 1)) * 0 + (pts_w - p[anchor]),
        np.stack([np.asarray(geom.quat_to_mat(jnp.asarray(q[a]))) for a in anchor]),
    )
    inv_depth = 1.0 / np.linalg.norm(pc0, axis=-1)
    state = WindowState(
        p=jnp.asarray(p, dtype), q=jnp.asarray(q, dtype), v=jnp.asarray(v, dtype),
        ba=jnp.zeros((NFRAMES, 3), dtype), bg=jnp.zeros((NFRAMES, 3), dtype),
        tic=jnp.zeros(3, dtype), qic=jnp.asarray([1.0, 0, 0, 0], dtype),
        td=jnp.zeros((), dtype),
        inv_depth=jnp.asarray(inv_depth * rng.uniform(0.95, 1.05, n_feat), dtype),
    )

    W = NFRAMES - 1
    M = imu_samples
    G = np.array([0.0, 0.0, 9.81])
    dts = np.full((W, M), (t[1] - t[0]) / M)
    accs = np.zeros((W, M, 3))
    for i in range(W):
        a_w = (v[i + 1] - v[i]) / (t[i + 1] - t[i])
        Ri = np.asarray(geom.quat_to_mat(jnp.asarray(q[i])))
        accs[i] = np.tile(Ri.T @ (a_w + G), (M, 1))
    accs += 0.002 * rng.standard_normal(accs.shape)
    gyrs = 0.01 * rng.standard_normal((W, M, 3))
    a0, g0 = accs[:, 0].copy(), gyrs[:, 0].copy()
    imu_valid = np.ones(W, bool)

    D = pose_dim(NFRAMES)
    if with_prior:
        A = rng.standard_normal((D, D)) * 0.5
        J = np.linalg.cholesky(A @ A.T + 10.0 * np.eye(D)).T
        prior = PriorFactor.from_state(
            jnp.asarray(J, dtype), jnp.zeros((D,), dtype), state)
    else:
        prior = PriorFactor.empty(dtype)
    gravity = jnp.asarray(G, dtype)
    cfg = SolverConfig(
        max_iterations=max_iterations,
        estimate_td=estimate_td, estimate_extrinsic=estimate_extrinsic,
    )
    noise = ImuNoise(0.02, 0.01, 0.04, 0.001)
    return dict(
        state=state, grid=grid,
        dts=np.asarray(dts), accs=accs, gyrs=gyrs, a0=a0, g0=g0,
        imu_valid=imu_valid, prior=prior, gravity=gravity, cfg=cfg,
        noise=noise,
    )


@dataclasses.dataclass
class StageTime:
    name: str
    device_ms: float
    compile_s: float
    note: str = ""


def time_stage(name, fn, args, n=20, chain_arg=None, note=""):
    """Compile fn(*args), then average n back-to-back dispatches with one
    trailing block_until_ready. chain_arg=i makes call k+1 consume call k's
    output at position i (guaranteeing serialization by data dependency,
    robust to any dispatch pipelining)."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0

    args = list(args)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
        if chain_arg is not None:
            args[chain_arg] = out[0] if isinstance(out, tuple) else out
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    return StageTime(name, dt * 1e3, compile_s, note)


def profile_solve(n_slots=256, max_iterations=8, dtype=None, n=20):
    """Per-stage device timings of the estimator solve + marginalization
    programs at production shapes. Returns a list of StageTime."""
    import jax
    import jax.numpy as jnp
    from ..backend import lm_solve
    from ..backend.solver import (
        assemble_normal_equations, _schur_solve, total_cost,
        linearize_proj_rows, linearize_imu_rows,
    )
    from ..backend.marginalize import marginalize_old_qr, marginalize_second_new_qr
    from ..backend.triangulate import triangulate_grid
    from ..backend.gauge import yaw_gauge_fix
    from ..imu import preintegrate_parallel, whiten_covariance

    dtype = dtype or jnp.float32
    pb = make_window_problem(n_slots, dtype, max_iterations=max_iterations)
    state, grid, prior, gravity, cfg, noise = (
        pb["state"], pb["grid"], pb["prior"], pb["gravity"], pb["cfg"],
        pb["noise"],
    )
    dts = jnp.asarray(pb["dts"], dtype)
    accs = jnp.asarray(pb["accs"], dtype)
    gyrs = jnp.asarray(pb["gyrs"], dtype)
    a0 = jnp.asarray(pb["a0"], dtype)
    g0 = jnp.asarray(pb["g0"], dtype)
    imu_valid = jnp.asarray(pb["imu_valid"])

    results = []

    # --- preintegration + whitening --------------------------------------
    @jax.jit
    def f_pre(dts, accs, gyrs, a0, g0, ba, bg):
        pre = jax.vmap(
            lambda d, ac, gy, a_0, g_0, b_a, b_g: preintegrate_parallel(
                d, ac, gy, a_0, g_0, b_a, b_g, noise)
        )(dts, accs, gyrs, a0, g0, ba, bg)
        si, ok = whiten_covariance(pre.covariance, imu_valid)
        return pre, si, ok

    results.append(time_stage(
        "preintegrate+whiten (10x32 samples)", f_pre,
        (dts, accs, gyrs, a0, g0, state.ba[:-1], state.bg[:-1]), n=n))
    pre, sqrt_info, imu_ok = f_pre(dts, accs, gyrs, a0, g0,
                                   state.ba[:-1], state.bg[:-1])

    # --- triangulation ----------------------------------------------------
    f_tri = jax.jit(triangulate_grid)
    has_depth = jnp.zeros((n_slots,), bool)
    results.append(time_stage(
        f"triangulate_grid ({n_slots} slots)", f_tri,
        (state, grid, has_depth), n=n))

    # --- LM solve: total and per-piece ------------------------------------
    f_lm = jax.jit(lambda s: lm_solve(
        s, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg))
    results.append(time_stage(
        f"lm_solve total ({cfg.max_iterations} iters)", f_lm, (state,),
        n=max(n // 2, 5), chain_arg=0))

    f_asm = jax.jit(lambda s: assemble_normal_equations(
        s, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg))
    results.append(time_stage(
        "  assemble_normal_equations (1x)", f_asm, (state,), n=n))

    H_pp, H_pl, H_ll, b_p, b_l, _ = f_asm(state)
    lam = jnp.asarray(1e-4, dtype)
    f_schur = jax.jit(lambda H_pp, H_pl, H_ll, b_p, b_l: _schur_solve(
        H_pp, H_pl, H_ll, b_p, b_l, lam, grid.used, dtype))
    results.append(time_stage(
        "  schur_solve + cholesky (1x)", f_schur,
        (H_pp, H_pl, H_ll, b_p, b_l), n=n))

    f_cost = jax.jit(lambda s: total_cost(
        s, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg))
    results.append(time_stage("  total_cost (1x)", f_cost, (state,), n=n))

    f_gauge = jax.jit(lambda s: yaw_gauge_fix(s, state.p[0], state.q[0]))
    results.append(time_stage("yaw_gauge_fix", f_gauge, (state,), n=n))

    # --- marginalization ---------------------------------------------------
    f_mo = jax.jit(lambda s: marginalize_old_qr(
        s, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg))
    results.append(time_stage("marginalize_old_qr", f_mo, (state,), n=n))
    f_mn = jax.jit(lambda s: marginalize_second_new_qr(s, prior, cfg))
    results.append(time_stage("marginalize_second_new_qr", f_mn, (state,), n=n))

    return results


def profile_frontend(n=10, dtype=None):
    """Per-stage device timings of the tracker at the bench rig's scale."""
    import jax
    import jax.numpy as jnp
    from .synthetic import (
        MINDVISION_ANNULUS, MINDVISION_SIZE, SyntheticWorld,
        make_mindvision_pal_camera, _np_quat_to_mat,
    )
    from .tracker import FrontEnd

    dtype = dtype or jnp.float32
    H, W = MINDVISION_SIZE
    cam = make_mindvision_pal_camera(dtype)
    world = SyntheticWorld(camera=cam, width=W, height=H)
    fe = FrontEnd(
        cam, (H, W), max_cnt=200, min_dist=20, n_slots=256,
        annulus=MINDVISION_ANNULUS, equalize=True, dtype=dtype,
    )
    results = []
    p, q = world.pose(0.0)
    img0 = world._render_u8(
        jnp.asarray(_np_quat_to_mat(q), jnp.float32), jnp.asarray(p, jnp.float32))
    p, q = world.pose(1.0 / 15.0)
    img1 = world._render_u8(
        jnp.asarray(_np_quat_to_mat(q), jnp.float32), jnp.asarray(p, jnp.float32))
    fe.process_arrays(img0, 0.0)

    results.append(time_stage(
        "preprocess alone (CLAHE + pyramid)", fe._pre, (img1,), n=n))
    import jax.random as jrandom
    from ..frontend import pyramidal_lk

    pos = jnp.asarray(fe.pos, dtype)
    valid = jnp.asarray(fe.ids >= 0)
    f_lk = jax.jit(lambda a, b, p, v: pyramidal_lk(
        list(a), list(b), p, v, fe.n_levels, refine_win=fe.refine_win))
    results.append(time_stage(
        f"pyramidal LK alone ({fe.N} slots, {int(valid.sum())} valid)",
        f_lk, (fe.prev_pyr, fe._pre(img1), pos, valid), n=n))
    key = jrandom.PRNGKey(0)
    results.append(time_stage(
        "tracker fused step (pre+KLT+RANSAC+detect)",
        lambda *a: fe._step(*a, publish=True),
        (fe.prev_pyr, img1, pos, valid, key), n=n))
    return results


def print_table(results):
    w = max(len(r.name) for r in results) + 2
    print(f"{'stage':<{w}} {'device ms':>10} {'compile s':>10}  note")
    for r in results:
        print(f"{r.name:<{w}} {r.device_ms:>10.3f} {r.compile_s:>10.1f}  {r.note}")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--frontend", action="store_true",
                    help="also profile the image frontend (slow render)")
    args = ap.parse_args(argv)

    import jax

    from .device import device_line, require_gpu, setup_compile_cache

    require_gpu(jax.devices())
    setup_compile_cache()
    print(device_line(jax.devices()))
    results = profile_solve(args.slots, args.iters, n=args.n)
    if args.frontend:
        results += profile_frontend()
    print_table(results)


if __name__ == "__main__":
    main()
