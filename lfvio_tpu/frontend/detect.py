"""Shi-Tomasi corner detection with annulus masking and spacing NMS.

Equivalent of the reference's detect path (feature_tracker.cpp:46-83,166):
cv::goodFeaturesToTrack(maxCorners, qualityLevel=0.01, minDistance=MIN_DIST,
mask) where mask = PAL annulus minus disks stamped around surviving tracks.

Formulation: dense min-eigenvalue response map via banded-matrix stencils,
masking via a dilated occupancy map (a square structuring element instead of
the reference's stamped circles, slightly stricter in the corners), 3×3
local-max NMS, then one exact top-k over the masked response.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def shi_tomasi_response(img, block_size: int = 3):
    """Min-eigenvalue corner response (cv::goodFeaturesToTrack's score).

    Stencils are banded-matrix products (see pyramid._banded): Sobel is
    separable smooth[1,2,1] ∘ diff[-1,0,1], the box sum is two 3-tap
    passes. All edge-replicated."""
    from .pyramid import _banded, _sep_mm

    H, W = img.shape
    sm = (1.0, 2.0, 1.0)
    df = (-1.0, 0.0, 1.0)
    bx = (1.0,) * block_size
    A_sm, B_sm = _banded(H, H, sm, 1), _banded(W, W, sm, 1)
    A_df, B_df = _banded(H, H, df, 1), _banded(W, W, df, 1)
    rb = block_size // 2
    A_bx, B_bx = _banded(H, H, bx, rb), _banded(W, W, bx, rb)

    gx = _sep_mm(img, A_sm, B_df) / 8.0
    gy = _sep_mm(img, A_df, B_sm) / 8.0

    def box3(x):
        return _sep_mm(x, A_bx, B_bx) / (block_size * block_size)

    Ixx = box3(gx * gx)
    Ixy = box3(gx * gy)
    Iyy = box3(gy * gy)
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    return 0.5 * (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0)))


def annulus_mask(shape, center_x, center_y, max_r, min_r, dtype=jnp.float32):
    """PAL annulus mask (reference setMask, feature_tracker.cpp:52-57)."""
    H, W = shape
    yy = jnp.arange(H, dtype=dtype)[:, None]
    xx = jnp.arange(W, dtype=dtype)[None, :]
    r2 = (xx - center_x) ** 2 + (yy - center_y) ** 2
    return (r2 <= max_r**2) & (r2 >= min_r**2)


def occupancy_dilated(shape, pts, valid, min_dist: int):
    """Boolean map that is True within a (2*min_dist+1) square around any
    valid point — the 'too close to an existing track' exclusion zone.

    Separable: excl[y, x] = Σ_n rows[n, y]·cols[n, x] > 0 with 0/1 operands,
    exact at any matrix-product precision (TF32 and bf16 hold 0/1, and the
    f32 sum counts points exactly). A window-max scan over the image gives
    the same map, but with a constant point set (the first frame) the
    compiler folds that scan pixel by pixel at compile time."""
    H, W = shape
    iy = jnp.clip(jnp.round(pts[:, 1]).astype(jnp.int32), 0, H - 1)
    ix = jnp.clip(jnp.round(pts[:, 0]).astype(jnp.int32), 0, W - 1)
    rows = (jnp.abs(jnp.arange(H)[None, :] - iy[:, None]) <= min_dist) \
        & valid[:, None]
    cols = jnp.abs(jnp.arange(W)[None, :] - ix[:, None]) <= min_dist
    hits = jnp.einsum(
        "ny,nx->yx", rows.astype(jnp.float32), cols.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    )
    return hits > 0.5


def top_k_exact(x, k: int):
    """``lax.top_k`` of a 1-D array — values descending, ties by lower
    index — as one stable sort. On the GPU, XLA's TopK (and approx_max_k,
    which lowers to the same exact top-k off the TPU) does not compile at a
    1.2 M-pixel response map: host memory runs away in the compiler. The
    sort compiles at once."""
    neg, idx = jax.lax.sort(
        (-x, jnp.arange(x.shape[0], dtype=jnp.int32)), num_keys=1,
        is_stable=True,
    )
    return -neg[:k], idx[:k]


def select_features(
    response,
    static_mask,
    existing_pts,
    existing_valid,
    n_new: int,
    min_dist: int,
    quality_level: float = 0.01,
):
    """Pick up to n_new corners: masked response, local-max NMS, top-k, then
    one greedy spacing pass among the selected (they may be within min_dist
    of each other; the reference's sequential stamping forbids that).

    Returns (pts [n_new, 2] float (x, y), ok [n_new] bool).
    """
    H, W = response.shape
    excl = occupancy_dilated((H, W), existing_pts, existing_valid, min_dist)
    resp = jnp.where(static_mask & ~excl, response, 0.0)
    # Kill the zero-padding convolution artifacts near the image border
    # (OpenCV's reflected borders have no such ridge).
    B = 5
    border = jnp.zeros((H, W), bool).at[B:-B, B:-B].set(True)
    resp = jnp.where(border, resp, 0.0)
    # quality gate relative to the max response (cv semantics)
    resp = jnp.where(resp >= quality_level * jnp.max(resp), resp, 0.0)
    # 3x3 local maxima
    local_max = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    resp = jnp.where(resp >= local_max, resp, 0.0)

    # Oversample candidates, then enforce min_dist among them. The greedy
    # stamping of the reference (strongest-first, suppress a disk) is a
    # sequential dependence (a length-800 lax.scan). Equivalent fixpoint
    # formulation, fully vectorized: a candidate survives iff no STRONGER
    # SURVIVOR lies within min_dist. The dependency
    # graph is a DAG in strength order, so iterating the suppression a fixed
    # few times resolves chains (depth doubles per sweep); real corner fields
    # settle in 2-3 sweeps.
    n_cand = min(4 * n_new, H * W)
    vals, idx = top_k_exact(resp.reshape(-1), n_cand)
    cy = (idx // W).astype(jnp.float32)
    cx = (idx % W).astype(jnp.float32)
    cand_ok = vals > 0.0

    md2 = jnp.asarray(float(min_dist * min_dist), response.dtype)
    d2 = (cx[:, None] - cx[None, :]) ** 2 + (cy[:, None] - cy[None, :]) ** 2
    # stronger[i, j]: candidate j outranks i (top_k order = strength order).
    stronger = jnp.tril(jnp.ones((n_cand, n_cand), bool), k=-1)
    clash = stronger & (d2 < md2) & cand_ok[None, :]

    def sweep(surv, _):
        return cand_ok & ~jnp.any(clash & surv[None, :], axis=1), None

    surv, _ = jax.lax.scan(sweep, cand_ok, None, length=6)
    # Cap at n_new strongest survivors.
    surv = surv & (jnp.cumsum(surv.astype(jnp.int32)) <= n_new)

    # Compact the selected candidates to the first n_new slots by sorting on
    # (-ok, candidate order): selected keep their strength ordering.
    order = jnp.argsort(~surv, stable=True)[:n_new]
    pts = jnp.stack([cx[order], cy[order]], axis=-1)
    ok = surv[order]
    pts = jnp.where(ok[:, None], pts, 0.0)
    return pts, ok
