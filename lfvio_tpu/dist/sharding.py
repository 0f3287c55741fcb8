"""Multi-chip distributed bundle adjustment via jax.sharding + shard_map.

The reference has no distributed runtime (SURVEY.md §2.5); this layer shards
the *feature slots* (landmarks + their observation grid) across cards. Each
device:

  1. linearizes its feature shard (projection residuals + Jacobians),
  2. assembles local partial normal equations,
  3. `psum`s the tiny pose-block system (H_pp [172², ~118 KB] + b_p) over the
     mesh — the only communication per LM iteration,
  4. solves the reduced 172×172 system redundantly (cheaper than sharding a
     matrix this small), and back-substitutes its local inverse depths.

IMU factors and the marginalization prior involve only pose blocks; they are
evaluated REPLICATED on every shard with their square-root weights scaled by
1/√n, so the psum reconstructs each exactly once ((J/√n)ᵀ(J/√n) summed over
n shards = JᵀJ). Replicating this tiny work keeps all devices busy — the
alternative (evaluate on shard 0, mask elsewhere) idles n-1 devices for that
portion of the program. The LM accept/reject loop runs in SPMD lockstep —
every device sees identical psum'd costs, so control flow never diverges.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..backend.state import (
    WindowState, FeatureGrid, PriorFactor, SolverConfig, pose_dim, n_cams_of,
)
from ..backend.solver import (
    assemble_normal_equations,
    apply_delta,
    total_cost,
    lm_loop,
)


def make_feature_mesh(devices=None, axis: str = "f"):
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.array(devices), (axis,))


def shard_grid(grid: FeatureGrid, mesh: Mesh, axis: str = "f"):
    """Place the observation grid with features sharded over the mesh."""
    spec = jax.sharding.NamedSharding(mesh, P(axis))
    return FeatureGrid(
        bearing=jax.device_put(grid.bearing, spec),
        velocity=jax.device_put(grid.velocity, spec),
        td_obs=jax.device_put(grid.td_obs, spec),
        valid=jax.device_put(grid.valid, spec),
        anchor=jax.device_put(grid.anchor, spec),
        used=jax.device_put(grid.used, spec),
        cam=jax.device_put(grid.cam, spec) if grid.cam is not None else None,
    )


def lm_solve_sharded(
    mesh: Mesh,
    state: WindowState,
    grid: FeatureGrid,
    pre,
    sqrt_info_imu,
    imu_valid,
    prior: PriorFactor,
    gravity,
    cfg: SolverConfig,
    axis: str = "f",
):
    """Feature-sharded LM solve. Identical math to backend.solver.lm_solve —
    validated against it in tests on a CPU device mesh.

    state/pre/prior are replicated; grid (and state.inv_depth) sharded on
    the feature axis.
    """
    n_dev = mesh.shape[axis]

    state_specs = WindowState(
        p=P(), q=P(), v=P(), ba=P(), bg=P(), tic=P(), qic=P(), td=P(),
        inv_depth=P(axis),
    )
    grid_specs = FeatureGrid(
        bearing=P(axis), velocity=P(axis), td_obs=P(axis),
        valid=P(axis), anchor=P(axis), used=P(axis),
        cam=P(axis) if grid.cam is not None else None,
    )
    prior_specs = jax.tree_util.tree_map(lambda _: P(), prior)

    inv_sqrt_n = 1.0 / (n_dev ** 0.5)

    def _scaled_shared(si_, pr_):
        """IMU sqrt-info and prior scaled by 1/√n: replicated evaluation on
        every shard psums back to exactly one copy of JᵀJ, Jᵀr and ½rᵀr."""
        si_s = si_ * inv_sqrt_n
        pr_s = PriorFactor(
            J=pr_.J * inv_sqrt_n, r0=pr_.r0 * inv_sqrt_n,
            x0_p=pr_.x0_p, x0_q=pr_.x0_q, x0_v=pr_.x0_v,
            x0_ba=pr_.x0_ba, x0_bg=pr_.x0_bg, x0_tic=pr_.x0_tic,
            x0_qic=pr_.x0_qic, x0_td=pr_.x0_td, valid=pr_.valid,
        )
        return si_s, pr_s

    def local_normal_eqs(s, g, pre_, si_, iv_, pr_):
        """Per-shard normal equations; pose part psum'd across shards."""
        si_s, pr_s = _scaled_shared(si_, pr_)
        H_pp, H_pl, H_ll, b_p, b_l, cost = assemble_normal_equations(
            s, g, pre_, si_s, iv_, pr_s, gravity, cfg
        )
        H_pp = jax.lax.psum(H_pp, axis)
        b_p = jax.lax.psum(b_p, axis)
        cost = jax.lax.psum(cost, axis)
        return H_pp, H_pl, H_ll, b_p, b_l, cost

    def local_cost(s, g, pre_, si_, iv_, pr_):
        si_s, pr_s = _scaled_shared(si_, pr_)
        return jax.lax.psum(
            total_cost(s, g, pre_, si_s, iv_, pr_s, gravity, cfg), axis
        )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(state_specs, grid_specs, jax.tree_util.tree_map(lambda _: P(), pre),
                  P(), P(), prior_specs),
        out_specs=(state_specs, P(), P()),
        check_vma=False,
    )
    def solve(s, g, pre_, si_, iv_, pr_):
        dtype = s.p.dtype
        F_local = g.valid.shape[0]
        D = pose_dim(g.valid.shape[1], n_cams_of(s))

        def lin_fn(sc, zeros_like=False):
            if zeros_like:
                z = jnp.zeros
                return (z((D, D), dtype), z((D, F_local), dtype),
                        z((F_local,), dtype), z((D,), dtype),
                        z((F_local,), dtype))
            H_pp, H_pl, H_ll, b_p, b_l, _ = local_normal_eqs(
                sc, g, pre_, si_, iv_, pr_
            )
            return H_pp, H_pl, H_ll, b_p, b_l

        def solve_fn(lin, lam):
            H_pp, H_pl, H_ll, b_p, b_l = lin
            # Schur contribution of the local depth shard must be psum'd.
            used_ok = g.used & (H_ll > 1e-12)
            H_ll_safe = jnp.where(used_ok, H_ll, 1.0)
            b_l_safe = jnp.where(used_ok, b_l, 0.0)
            H_pl_safe = jnp.where(used_ok[None, :], H_pl, 0.0)
            inv_Hll = 1.0 / (H_ll_safe * (1.0 + lam))
            S = jax.lax.psum((H_pl_safe * inv_Hll[None, :]) @ H_pl_safe.T, axis)
            c = jax.lax.psum(H_pl_safe @ (inv_Hll * b_l_safe), axis)
            H_red = H_pp - S
            b_red = b_p - c
            diag = jnp.clip(jnp.diag(H_pp), 1e-6, 1e32)
            L = jnp.linalg.cholesky(
                H_red + lam * jnp.diag(diag) + 1e-10 * jnp.eye(D, dtype=dtype)
            )
            dx = -jax.scipy.linalg.cho_solve((L, True), b_red)
            dlam = -inv_Hll * (b_l_safe + H_pl_safe.T @ dx)
            return dx, dlam

        def cost_fn(sc):
            return local_cost(sc, g, pre_, si_, iv_, pr_)

        # Shared loop with the single-chip solver: accept/reject runs in
        # SPMD lockstep (costs are psum'd, so every device branches the
        # same way in the lax.cond early-exit).
        s_out, c0, c1, _ = lm_loop(s, lin_fn, solve_fn, cost_fn, cfg)
        return s_out, c0, c1

    return solve(state, grid, pre, sqrt_info_imu, imu_valid, prior)
