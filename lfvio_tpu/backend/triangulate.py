"""Batched multi-view triangulation of window features (device).

Equivalent of FeatureManager::triangulate
(/root/reference/vins_estimator/src/feature_manager.cpp:199-253): for each
feature, stack the two DLT rows per observing frame relative to the anchor
camera and take the null vector; depth is the *ray* depth
⟨X, bearing_anchor⟩ (valid on the negative half-plane).

Formulation: all F features solved simultaneously — masked rows
contribute nothing to AᵀA, and the null space comes from a batched 4×4
symmetric eigendecomposition instead of per-feature SVDs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geom import quat_to_mat, quat_rotate
from .state import WindowState, FeatureGrid, ex_2d

INIT_DEPTH = 5.0


def triangulate_grid(state: WindowState, grid: FeatureGrid, has_depth):
    """Returns inverse ray depths [F] for features without a valid depth;
    entries with has_depth keep state.inv_depth.

    Camera poses: p_c = p + R tic[c], R_c = R R_ic[c] per (frame, camera) —
    each observation uses its own camera's extrinsic (multi-camera rigs).
    """
    dtype = state.p.dtype
    F, W1 = grid.valid.shape

    tics, qics = ex_2d(state.tic, state.qic)
    C = tics.shape[0]
    Rw = quat_to_mat(state.q)  # [W+1, 3, 3] world<-imu
    Rics = quat_to_mat(qics)  # [C, 3, 3]
    t_wc = state.p[:, None, :] + jnp.einsum(
        "wij,cj->wci", Rw, tics
    )  # [W+1, C, 3]
    R_wc = jnp.einsum("wij,cjk->wcik", Rw, Rics)  # [W+1, C, 3, 3] world<-cam

    # Per-observation camera pose via the camera one-hot.
    oh_cam = grid.cam_onehot(C, dtype)  # [F, W+1, C]
    R_c = jnp.einsum("fwc,wcik->fwik", oh_cam, R_wc)  # [F, W+1, 3, 3]
    t_c = jnp.einsum("fwc,wci->fwi", oh_cam, t_wc)  # [F, W+1, 3]

    onehot = grid.anchor_onehot(dtype)
    R0 = jnp.einsum("fw,fwij->fij", onehot, R_c)  # anchor cam rotation
    t0 = jnp.einsum("fw,fwi->fi", onehot, t_c)

    # Relative projection per (f, j): X_cam_j = R_rel X_anchor + t_rel with
    # R_rel = R_cj^T R_0, t_rel = R_cj^T (t0 - t_cj).
    R_rel = jnp.einsum("fwji,fjk->fwik", R_c, R0)  # [F, W+1, 3, 3]
    t_rel = jnp.einsum("fwji,fwj->fwi", R_c, t0[:, None, :] - t_c)

    P = jnp.concatenate([R_rel, t_rel[..., None]], axis=-1)  # [F, W+1, 3, 4]
    f = grid.bearing / jnp.maximum(
        jnp.linalg.norm(grid.bearing, axis=-1, keepdims=True), 1e-12
    )
    row0 = f[..., 0:1] * P[..., 2, :] - f[..., 2:3] * P[..., 0, :]
    row1 = f[..., 1:2] * P[..., 2, :] - f[..., 2:3] * P[..., 1, :]
    rows = jnp.stack([row0, row1], axis=2)  # [F, W+1, 2, 4]
    w = grid.valid[..., None, None].astype(dtype)
    rows = rows * w
    AtA = jnp.einsum("fwra,fwrb->fab", rows, rows)  # [F, 4, 4]
    # Smallest eigenvector of AtA (add tiny ridge for masked/degenerate slots).
    ww, V = jnp.linalg.eigh(AtA + 1e-12 * jnp.eye(4, dtype=dtype))
    X = V[..., :, 0]
    denom = jnp.where(jnp.abs(X[..., 3]) < 1e-10, 1e-10, X[..., 3])
    Xp = X[..., :3] / denom[..., None]

    b0 = jnp.einsum("fw,fwc->fc", onehot, f)  # anchor bearing
    depth = jnp.sum(Xp * b0, axis=-1)  # ray depth (svd_method)
    depth = jnp.where(depth < 0.1, INIT_DEPTH, depth)
    n_obs = grid.valid.sum(-1)
    can = grid.used & (n_obs >= 2)
    inv_new = jnp.where(can, 1.0 / depth, 1.0 / INIT_DEPTH)
    return jnp.where(has_depth, state.inv_depth, inv_new)
