"""Distributed square-root marginalization: feature-sharded TSQR.

The single-device path (backend/marginalize.py:marginalize_old_qr) stacks
all whitened factor rows and takes one tall-skinny QR. Distributed, the row
set splits naturally along the feature axis — each projection row touches
only its own feature's depth column — so the classic TSQR (tall-skinny QR)
factorization applies:

  stage 1 (local, no comms): each shard QRs its own projection rows with
    column order [local depths | dropped pose0/sb0 | kept | r] and keeps the
    R-factor rows BELOW its depth block — its depth-eliminated marginal
    contribution over the shared [dropped | kept | r] columns
    ([15+K+1] × [15+K+1], ~120 KB).
  stage 2 (one all_gather over the mesh): stack the n contribution blocks with
    the (tiny, replicated-once) IMU-interval-0 and prior rows, QR again,
    and read the rows below the dropped block — the marginal square-root
    prior on the kept variables.

Correctness: QR elimination composes — R([A1; A2]) equals R([R(A1); R(A2)])
up to row signs, and a square-root prior is sign-invariant (it enters the
solver only through JᵀJ and Jᵀr). Parity with the single-device path is
asserted in tests/test_dist.py on an 8-device CPU mesh.

The reference has no distributed runtime at all (SURVEY §2.5); its
marginalization is a 4-thread Hessian assembly
(marginalization_factor.cpp:232-261).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..backend.state import (
    WindowState,
    FeatureGrid,
    PriorFactor,
    SolverConfig,
    pose_dim,
    n_cams_of,
)
from ..backend.solver import linearize_proj_rows, linearize_imu_rows
from ..backend.factors import prior_residual
from ..backend.marginalize import (
    _keep_drop_indices,
    _shift_prior_blocks,
    _shift_state_snapshot,
)


def _marg_old_qr_local(state, grid, pre0, sqrt_info_imu0, imu_valid_masked,
                       prior, gravity, cfg, axis):
    """shard_map body: feature-local TSQR stage 1 + replicated stage 2."""
    dtype = state.p.dtype
    n_frames = state.p.shape[0]
    Floc, W1 = grid.valid.shape
    W = W1 - 1
    D = pose_dim(n_frames, n_cams_of(state))
    drop, keep = _keep_drop_indices(n_frames, D)
    K = len(keep)
    C = 15 + K + 1  # shared columns: dropped pose0/sb0 | kept | residual

    grid0 = grid.replace(used=grid.used & (grid.anchor == 0))

    # ---- stage 1: local projection rows, eliminate local depths ----------
    res_w, Jfull, J_lam, _, _ = linearize_proj_rows(state, grid0, cfg)
    R1 = Floc * W1 * 2
    eyeF = jnp.eye(Floc, dtype=dtype)
    dep_rows = jnp.einsum("fja,fg->fjag", J_lam, eyeF).reshape(R1, Floc)
    A_pose = Jfull.reshape(R1, D)
    A1 = jnp.concatenate(
        [dep_rows, A_pose[:, drop], A_pose[:, keep], res_w.reshape(R1)[:, None]],
        axis=1,
    )  # [R1, Floc + C]
    Rfac1 = jnp.linalg.qr(A1, mode="r")
    B_local = Rfac1[Floc:, Floc:]  # [C', C] rows below the depth block
    # Pad to a static [C, C] (qr's R has min(R1, Floc+C) rows).
    pad = C - B_local.shape[0]
    if pad > 0:
        B_local = jnp.concatenate(
            [B_local, jnp.zeros((pad, C), dtype)], axis=0
        )
    B_local = B_local[:C]

    # ---- stage 2: gather + tiny replicated rows + final QR ----------------
    B_all = jax.lax.all_gather(B_local, axis)  # [n, C, C]
    n_dev = B_all.shape[0]
    B_stack = B_all.reshape(n_dev * C, C)

    imu_res, Jimu, _ = linearize_imu_rows(
        state, pre0, sqrt_info_imu0, imu_valid_masked, gravity
    )
    rp = prior_residual(state, prior)
    Jp = jnp.where(prior.valid, prior.J, jnp.zeros_like(prior.J))
    extra_pose = jnp.concatenate([Jimu, Jp], axis=0)  # [W*15 + D, D]
    extra_r = jnp.concatenate([imu_res.reshape(W * 15), rp])
    A2_extra = jnp.concatenate(
        [extra_pose[:, drop], extra_pose[:, keep], extra_r[:, None]], axis=1
    )
    A2 = jnp.concatenate([B_stack, A2_extra], axis=0)
    Rfac2 = jnp.linalg.qr(A2, mode="r")
    Jk = Rfac2[15 : 15 + K, 15 : 15 + K]
    rk = Rfac2[15 : 15 + K, 15 + K]

    ok = jnp.isfinite(Jk).all() & jnp.isfinite(rk).all()
    Jk = jnp.where(ok, Jk, 0.0)
    rk = jnp.where(ok, rk, 0.0)
    J = jnp.zeros((D, D), dtype).at[
        jnp.ix_(jnp.asarray(keep), jnp.asarray(keep))
    ].set(Jk)
    r0 = jnp.zeros((D,), dtype).at[jnp.asarray(keep)].set(rk)
    J, r0 = _shift_prior_blocks(J, r0, n_frames)
    return J, r0, ok


def marginalize_old_qr_sharded(
    mesh: Mesh,
    state: WindowState,
    grid: FeatureGrid,
    pre0,
    sqrt_info_imu0,
    imu0_valid,
    prior: PriorFactor,
    gravity,
    cfg: SolverConfig,
    axis: str = "f",
):
    """Feature-sharded MARGIN_OLD marginalization (TSQR). Inputs/outputs
    match backend.marginalize.marginalize_old_qr; `grid` (and only it) is
    sharded on the feature axis."""
    imu_valid_masked = jnp.zeros_like(imu0_valid).at[0].set(imu0_valid[0])

    grid_specs = FeatureGrid(
        bearing=P(axis), velocity=P(axis), td_obs=P(axis),
        valid=P(axis), anchor=P(axis), used=P(axis),
        cam=P(axis) if grid.cam is not None else None,
    )
    state_specs = jax.tree_util.tree_map(lambda _: P(), state)
    # inv_depth may arrive feature-sharded from the sharded solve.
    state_specs = dataclasses.replace(state_specs, inv_depth=P(axis))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(state_specs, grid_specs,
                  jax.tree_util.tree_map(lambda _: P(), pre0), P(), P(),
                  jax.tree_util.tree_map(lambda _: P(), prior)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def run(s, g, pre_, si_, iv_, pr_):
        return _marg_old_qr_local(
            s, g, pre_, si_, iv_, pr_, gravity, cfg, axis
        )

    J, r0, ok = run(state, grid, pre0, sqrt_info_imu0, imu_valid_masked, prior)
    x0 = _shift_state_snapshot(state)
    new_prior = PriorFactor.from_state(J, r0, x0)
    return dataclasses.replace(new_prior, valid=ok)
