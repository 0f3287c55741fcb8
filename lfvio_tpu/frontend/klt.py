"""Batched pyramidal Lucas-Kanade optical flow.

Replaces cv::calcOpticalFlowPyrLK (reference feature_tracker.cpp:127 —
41×41 window, 3 pyramid levels) with a fully batched JAX implementation:
all N feature tracks advance together through a fixed iteration schedule, so
the whole tracker is one XLA computation.

Design notes:
  * Patch extraction once per (feature, level): one vmapped dynamic_slice
    per patch — the only gathers in the tracker.
  * In-iteration bilinear resampling NEVER gathers: both axes are banded
    shift-matrix contractions (built from iota comparisons) batched over all
    N features — two batched matrix products per Gauss-Newton iteration
    for the whole feature set, instead of a per-feature loop.
  * Fixed iteration counts with convergence masking (no data-dependent
    control flow).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

WIN = 41  # correlation window (reference: cv::Size(41, 41))
HALF = WIN // 2
SEARCH_MARGIN = 6  # extra px the iterations may move within the cached patch
PATCH = WIN + 1 + 2 * SEARCH_MARGIN  # cached search-window side
N_ITERS = 20  # per level (cv default 30 w/ eps 0.01)
MIN_EIG_THR = 1e-4  # per-pixel-normalized min eigenvalue gate (cv: 1e-4)

TP = WIN + 4  # template patch side (gradient samples at ±1 stay in bounds)


def _extract_patches(img, topleft, size):
    """[N] integer-aligned patch extractions (one gather per feature)."""
    return jax.vmap(
        lambda tl: jax.lax.dynamic_slice(img, (tl[0], tl[1]), (size, size))
    )(topleft)


def _shift_rows(oy, rows, prows, dtype):
    """Banded y-shift matrices Sy [N, rows, prows]: (Sy @ P)[n, r, :]
    linearly interpolates patch n's rows at oy[n] + r."""
    iy = jnp.floor(oy).astype(jnp.int32)
    fy = (oy - iy.astype(dtype)).astype(dtype)[:, None, None]
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (1, rows, prows), 1)
    p_iota = jax.lax.broadcasted_iota(jnp.int32, (1, rows, prows), 2)
    tgt = iy[:, None, None] + r_iota
    lo = (p_iota == tgt).astype(dtype)
    hi = (p_iota == tgt + 1).astype(dtype)
    return lo * (1.0 - fy) + hi * fy


def _shift_cols(ox, cols, pcols, dtype):
    """Banded x-shift matrices Sx [N, pcols, cols]: (P @ Sx)[n, :, c]
    linearly interpolates patch n's columns at ox[n] + c."""
    ix = jnp.floor(ox).astype(jnp.int32)
    fx = (ox - ix.astype(dtype)).astype(dtype)[:, None, None]
    p_iota = jax.lax.broadcasted_iota(jnp.int32, (1, pcols, cols), 1)
    c_iota = jax.lax.broadcasted_iota(jnp.int32, (1, pcols, cols), 2)
    tgt = ix[:, None, None] + c_iota
    lo = (p_iota == tgt).astype(dtype)
    hi = (p_iota == tgt + 1).astype(dtype)
    return lo * (1.0 - fx) + hi * fx


def _sample_all(patches, oy, ox, rows, cols):
    """Bilinearly sample a rows×cols window from every patch [N, PR, PC] at
    per-feature fractional offsets (oy, ox) — two batched matmuls."""
    dtype = patches.dtype
    N, PR, PC = patches.shape
    Sy = _shift_rows(oy, rows, PR, dtype)
    Sx = _shift_cols(ox, cols, PC, dtype)
    yint = jax.lax.dot_general(
        Sy, patches, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [N, rows, PC]
    return jax.lax.dot_general(
        yint, Sx, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ).astype(dtype)  # [N, rows, cols]


PAD = HALF + SEARCH_MARGIN + 4  # edge-replication pad so windows never clip


def _track_level(img_prev, img_next, pos_prev_l, guess, valid,
                 win: int = WIN, n_iters: int = N_ITERS):
    """One pyramid level of LK for all features, fully batched.

    pos_prev_l: [N, 2] (x, y) feature positions in this level's coordinates.
    guess: [N, 2] current flow estimate at this level's scale.
    Returns (new_guess [N,2], ok [N]).

    Both level images are edge-padded by PAD so the 41-px window (huge
    relative to coarse levels) never clips — the same effect as OpenCV's
    border handling in calcOpticalFlowPyrLK.
    """
    half = win // 2
    tp = win + 4
    patch = win + 1 + 2 * SEARCH_MARGIN
    H0, W0 = img_prev.shape
    img_prev = jnp.pad(img_prev, PAD, mode="edge")
    img_next = jnp.pad(img_next, PAD, mode="edge")
    pos_prev_l = pos_prev_l + PAD
    H, W = img_prev.shape
    dtype = img_prev.dtype
    px, py = pos_prev_l[:, 0], pos_prev_l[:, 1]

    # --- template patches from prev image (fixed during iterations) --------
    tl_t = jnp.stack(
        [
            jnp.clip(jnp.floor(py) - half - 2, 0, H - tp),
            jnp.clip(jnp.floor(px) - half - 2, 0, W - tp),
        ],
        axis=1,
    ).astype(jnp.int32)
    tpatch = _extract_patches(img_prev, tl_t, tp)  # [N, tp, tp]
    off_ty = py - tl_t[:, 0].astype(dtype) - half
    off_tx = px - tl_t[:, 1].astype(dtype) - half
    # Template + central-difference gradients from ONE (win+2)² sample.
    T_ext = _sample_all(tpatch, off_ty - 1.0, off_tx - 1.0, win + 2, win + 2)
    T = T_ext[:, 1:-1, 1:-1]
    Tx = 0.5 * (T_ext[:, 1:-1, 2:] - T_ext[:, 1:-1, :-2])
    Ty = 0.5 * (T_ext[:, 2:, 1:-1] - T_ext[:, :-2, 1:-1])

    Gxx = jnp.sum(Tx * Tx, axis=(1, 2))
    Gxy = jnp.sum(Tx * Ty, axis=(1, 2))
    Gyy = jnp.sum(Ty * Ty, axis=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    tr = Gxx + Gyy
    min_eig = 0.5 * (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0)))
    good_G = min_eig / (win * win) > MIN_EIG_THR
    inv_det = jnp.where(det > 1e-12, 1.0 / jnp.maximum(det, 1e-12), 0.0)

    # --- search patches from next image around expected location -----------
    target = pos_prev_l + guess
    tl_s = jnp.stack(
        [
            jnp.clip(jnp.floor(target[:, 1]) - half - SEARCH_MARGIN, 0, H - patch),
            jnp.clip(jnp.floor(target[:, 0]) - half - SEARCH_MARGIN, 0, W - patch),
        ],
        axis=1,
    ).astype(jnp.int32)
    spatch = _extract_patches(img_next, tl_s, patch)  # [N, patch, patch]
    base_sy = tl_s[:, 0].astype(dtype)
    base_sx = tl_s[:, 1].astype(dtype)

    def body(carry):
        k, g, active = carry
        oy = jnp.clip(py + g[:, 1] - base_sy - half, 0.0, patch - win - 1.0)
        ox = jnp.clip(px + g[:, 0] - base_sx - half, 0.0, patch - win - 1.0)
        S = _sample_all(spatch, oy, ox, win, win)
        r = S - T
        bx = jnp.sum(Tx * r, axis=(1, 2))
        by = jnp.sum(Ty * r, axis=(1, 2))
        dx = jnp.clip(-(Gyy * bx - Gxy * by) * inv_det, -2.0, 2.0)
        dy = jnp.clip(-(Gxx * by - Gxy * bx) * inv_det, -2.0, 2.0)
        step = jnp.stack([dx, dy], axis=1)
        g_new = jnp.where(active[:, None], g + step, g)
        still = active & (dx * dx + dy * dy > 1e-4)  # cv eps 0.01^2
        return k + 1, g_new, still

    def cond(carry):
        # Early exit once EVERY track converged (cv's per-track eps exit,
        # done set-wide): typical frames converge in 5–8 of the 20
        # allowed iterations, and a masked iteration still costs the full
        # two batched matmuls — a data-dependent while_loop halves the
        # tracker's device time vs the fixed fori_loop.
        k, _, active = carry
        return (k < n_iters) & jnp.any(active)

    _, g_fin, _ = jax.lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), guess, good_G & valid)
    )

    # Border validity of the final position in REAL image coordinates.
    fx = px + g_fin[:, 0]
    fy = py + g_fin[:, 1]
    inb = (
        (fx >= PAD + 1.0)
        & (fx < PAD + W0 - 1.0)
        & (fy >= PAD + 1.0)
        & (fy < PAD + H0 - 1.0)
    )
    # Also require the sample window stayed inside the cached patch.
    off_ok = (
        (fy - base_sy - half >= 0.0)
        & (fy - base_sy - half <= patch - win - 1)
        & (fx - base_sx - half >= 0.0)
        & (fx - base_sx - half <= patch - win - 1)
    )
    return g_fin, valid & good_G & inb & off_ok


def pyramidal_lk(pyr_prev, pyr_next, pts_prev, valid, n_levels: int = 3,
                 refine_win: int = 0):
    """Track pts_prev ([N, 2] (x, y) full-res pixels) from pyr_prev to
    pyr_next. Returns (pts_next [N, 2], status [N] bool).

    pyr_*: lists of level images from gaussian_pyramid (len n_levels+1).

    refine_win > 0 runs one extra level-0 pass with that (smaller) window
    after the standard pyramid: the 41-px window averages the curved PAL
    flow field (a sub-pixel bias on short-focal rigs); a small final window
    re-centers on the feature itself. Refined positions are used only where
    the refinement stays within 1.5 px of the converged track (guards
    against small-window drift on weak texture).
    """
    N = pts_prev.shape[0]
    dtype = pyr_prev[0].dtype
    g = jnp.zeros((N, 2), dtype)
    ok = valid
    for l in range(n_levels, -1, -1):
        if min(pyr_prev[l].shape) >= 8:  # skip degenerate tiny levels
            scale = 2.0**l
            pos_l = pts_prev / scale
            g, ok_l = _track_level(pyr_prev[l], pyr_next[l], pos_l, g, ok)
            ok = ok & ok_l
        if l > 0:
            g = g * 2.0
    if refine_win:
        g_ref, ok_ref = _track_level(
            pyr_prev[0], pyr_next[0], pts_prev, g, ok,
            win=int(refine_win), n_iters=10,
        )
        close = jnp.sum((g_ref - g) ** 2, axis=-1) < 1.5**2
        use = ok_ref & close
        g = jnp.where(use[:, None], g_ref, g)
    pts_next = pts_prev + g
    return pts_next, ok
