"""Complete distributed VIO frame step: one jitted multi-chip program.

Composes the full per-frame estimator computation
(runtime/estimator.py:_solve_step_impl + the marginalization programs) over
a device mesh:

  * IMU preintegration + covariance whitening: REPLICATED (tiny; one copy of
    work per device beats idling n-1 devices while one integrates).
  * Multi-view triangulation: feature-sharded (embarrassingly parallel).
  * Sliding-window LM BA: feature-sharded normal equations, pose system
    psum'd over the mesh, redundant 172×172 solve (dist/sharding.py).
  * MARGIN_OLD marginalization: feature-sharded TSQR (dist/marginalize.py);
    MARGIN_SECOND_NEW touches only the (replicated) prior.

This is the program `chip_smoke.py --four` runs on a 4-card mesh against
the single-card solve. The reference has no distributed runtime (SURVEY
§2.5 north star).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..backend.state import WindowState, FeatureGrid, PriorFactor, SolverConfig
from ..backend.triangulate import triangulate_grid
from ..backend.marginalize import marginalize_second_new_qr
from ..backend.gauge import yaw_gauge_fix
from ..imu import preintegrate_parallel, whiten_covariance
from .sharding import lm_solve_sharded
from .marginalize import marginalize_old_qr_sharded


def triangulate_sharded(mesh: Mesh, state, grid, has_depth, axis: str = "f"):
    """Feature-sharded multi-view triangulation (window poses replicated)."""
    grid_specs = FeatureGrid(
        bearing=P(axis), velocity=P(axis), td_obs=P(axis),
        valid=P(axis), anchor=P(axis), used=P(axis),
        cam=P(axis) if grid.cam is not None else None,
    )
    state_specs = jax.tree_util.tree_map(lambda _: P(), state)
    state_specs = dataclasses.replace(state_specs, inv_depth=P(axis))

    @partial(
        shard_map, mesh=mesh,
        in_specs=(state_specs, grid_specs, P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def run(s, g, h):
        return triangulate_grid(s, g, h)

    return run(state, grid, has_depth)


def _frame_step_impl(
    mesh, state, grid, dts, accs, gyrs, a0, g0, imu_valid,
    prior, has_depth, origin_p0, origin_q0,
    imu_noise, cfg, g_norm, marg_old, axis,
):
    sd = state.p.dtype
    gravity = jnp.asarray([0.0, 0.0, g_norm], sd)

    pre = jax.vmap(
        lambda d, ac, gy, a_0, g_0, ba, bg: preintegrate_parallel(
            d, ac, gy, a_0, g_0, ba, bg, imu_noise
        )
    )(dts, accs, gyrs, a0, g0, state.ba[:-1], state.bg[:-1])
    sqrt_info, imu_ok = whiten_covariance(pre.covariance, imu_valid)

    inv_d = triangulate_sharded(mesh, state, grid, has_depth, axis)
    state = dataclasses.replace(state, inv_depth=inv_d)

    out, c0, c1 = lm_solve_sharded(
        mesh, state, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg, axis
    )
    out = yaw_gauge_fix(out, origin_p0, origin_q0)

    if marg_old:
        new_prior = marginalize_old_qr_sharded(
            mesh, out, grid, pre, sqrt_info, imu_ok, prior, gravity, cfg, axis
        )
    else:
        new_prior = marginalize_second_new_qr(out, prior, cfg)
    return out, new_prior, c0, c1


_JIT_CACHE: dict = {}


def vio_frame_step_sharded(
    mesh: Mesh,
    state: WindowState,
    grid: FeatureGrid,
    dts, accs, gyrs, a0, g0, imu_valid,
    prior: PriorFactor,
    has_depth,
    origin_p0, origin_q0,
    imu_noise,
    cfg: SolverConfig,
    g_norm: float = 9.81,
    marg_old: bool = True,
    axis: str = "f",
):
    """One full frame: preintegrate → triangulate → LM BA → gauge fix →
    marginalize, distributed over `mesh`. Returns (state_out, new_prior,
    cost0, cost1). `grid`, `has_depth` and `state.inv_depth` are sharded on
    the feature axis; everything else is replicated.

    The program is jitted ONCE per (mesh, cfg, noise, marg_old, g_norm)
    configuration and cached — repeat calls reuse the compiled executable
    (without this, every call re-traces its shard_maps)."""
    key = (mesh, imu_noise, cfg, float(g_norm), bool(marg_old), axis)
    step = _JIT_CACHE.get(key)
    if step is None:
        step = jax.jit(
            lambda st, g, d, ac, gy, a_0, g_0, iv, pr, hd, op, oq:
            _frame_step_impl(
                mesh, st, g, d, ac, gy, a_0, g_0, iv, pr, hd, op, oq,
                imu_noise, cfg, g_norm, marg_old, axis,
            )
        )
        _JIT_CACHE[key] = step
    return step(
        state, grid, dts, accs, gyrs, a0, g0, imu_valid,
        prior, has_depth, origin_p0, origin_q0,
    )
