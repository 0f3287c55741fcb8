"""CLAHE (contrast-limited adaptive histogram equalization) on device.

Equivalent of cv::createCLAHE(3.0, Size(8,8))->apply (reference
feature_tracker.cpp:101-107).

Formulation: no per-pixel gathers. Both the histogram and the LUT
application are one-hot contractions (matrix products), nibble-factorized
so the one-hot tensors stay small: a 256-bin index splits into hi/lo 16-way
one-hots, making every lookup an exact [16]×[16,16]×[16] bilinear form
instead of a gather. Selection by an exact 0/1 one-hot is bit-identical to
the gather it replaces. The gather form is kept as ``_clahe_gather``; which
of the two is faster on the GPU is open (ROADMAP S3).

The per-pixel bilinear blend over the 4 neighboring tile LUTs becomes a
static quadrant decomposition: every pixel in a given quadrant of a given
tile shares the SAME 4 corner tiles, so the corner LUT stack is a tiny
[g,g,2,2,4,256] tensor assembled with static indexing, and the per-pixel
work is a batched matmul over blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def clahe(img, clip_limit: float = 3.0, grid: int = 8, n_bins: int = 256):
    """img: [H, W] float in [0, 255]. Returns equalized image, same range.

    H and W must be divisible by grid (1280×960 / 8 = 160×120, true for the
    PAL rig; other rigs pad beforehand).
    """
    H, W = img.shape
    th, tw = H // grid, W // grid
    if n_bins != 256 or th % 2 or tw % 2:
        # Gather-based fallback for shapes the nibble/quadrant layout cannot
        # tile (odd tile sides or non-256 bins).
        return _clahe_gather(img, clip_limit, grid, n_bins)
    return _clahe_onehot(img, clip_limit, grid)


def _tile_luts(hist, clip_limit, npix, n_bins, dtype):
    """Per-tile LUT from per-tile histograms: clip + uniform redistribution
    (cv semantics: clipLimit scaled by tile size), cdf scaling."""
    clip = jnp.maximum(clip_limit * npix / n_bins, 1.0)
    excess = jnp.sum(jnp.maximum(hist - clip, 0.0), axis=-1, keepdims=True)
    hist = jnp.minimum(hist, clip) + excess / n_bins
    cdf = jnp.cumsum(hist, axis=-1)
    lut = (cdf - cdf[..., :1]) / jnp.maximum(npix - cdf[..., :1], 1.0) * 255.0
    return jnp.clip(lut, 0.0, 255.0)


def _tile_frac(n, t, grid, dtype):
    """Fractional part of the tile coordinate clip(i/t − 0.5, 0, grid−1) of
    pixels i < n, in exact integer arithmetic. The static quadrant layout
    fixes which two tiles each pixel blends, so the fraction must not cross
    an integer through rounding: computed as floor(i/t − 0.5) in floats, a
    compiler that divides by multiplying with 1/t can land just below a
    tile centre and blend the wrong pair (seen with jit in f64)."""
    num = jnp.clip(2 * jnp.arange(n) - t, 0, 2 * t * (grid - 1))  # 2t·coord
    return (num % (2 * t)).astype(dtype) / (2 * t)


def _clahe_onehot(img, clip_limit: float, grid: int):
    n_bins = 256
    H, W = img.shape
    dtype = img.dtype
    th, tw = H // grid, W // grid
    th2, tw2 = th // 2, tw // 2
    npix = th * tw
    p_blk = th2 * tw2

    vals = jnp.clip(img, 0.0, 255.0)
    bins = jnp.clip(
        (vals * (n_bins / 256.0)).astype(jnp.int32), 0, n_bins - 1
    )
    nib = jnp.arange(16, dtype=jnp.int32)

    # ---- per-tile histogram as a contraction: hist[t, hi, lo] = oh_hiᵀ·oh_lo.
    bins_t = bins.reshape(grid, th, grid, tw).transpose(0, 2, 1, 3).reshape(
        grid, grid, npix
    )
    # bf16 one-hots: 0/1 are exact in bf16 and the product accumulates in
    # f32, so the histogram is still exact — at half the memory traffic
    # (the one-hot tensors dominate this program's bytes).
    oh_hi_t = (bins_t[..., None] // 16 == nib).astype(jnp.bfloat16)
    oh_lo_t = (bins_t[..., None] % 16 == nib).astype(jnp.bfloat16)
    hist = jnp.einsum(
        "ijph,ijpl->ijhl", oh_hi_t, oh_lo_t,
        preferred_element_type=jnp.float32,
    ).astype(dtype).reshape(grid, grid, n_bins)
    lut = _tile_luts(hist, clip_limit, npix, n_bins, dtype)  # [g, g, 256]

    # ---- static corner-LUT stack per (tile, quadrant): pixels in quadrant
    # (qy, qx) of tile (i, j) all interpolate between tiles
    # (y0,x0),(y0,x1),(y1,x0),(y1,x1) with y0 = clip(i-1+qy, 0, g-1),
    # y1 = min(y0+1, g-1) — the cv bilinear scheme, resolved at trace time.
    q = jnp.arange(2)
    y0 = jnp.clip(jnp.arange(grid)[:, None] - 1 + q[None, :], 0, grid - 1)
    y1 = jnp.minimum(y0 + 1, grid - 1)  # [g, 2]
    ly0 = lut[y0]  # [g, 2, g, 256]
    ly1 = lut[y1]
    c00 = ly0[:, :, y0]  # [g, 2, g, 2, 256]
    c01 = ly0[:, :, y1]
    c10 = ly1[:, :, y0]
    c11 = ly1[:, :, y1]
    L = jnp.stack([c00, c01, c10, c11], axis=-2)  # [g,2,g,2,4,256]
    L = L.transpose(0, 2, 1, 3, 4, 5)  # [g,g,2,2,4,256]
    # nibble split, hi-major: [g,g,2,2,16hi,(4c·16lo)]
    L2 = L.reshape(grid, grid, 2, 2, 4, 16, 16)
    L2h = L2.transpose(0, 1, 2, 3, 5, 4, 6).reshape(
        grid, grid, 2, 2, 16, 4 * 16
    )

    # ---- pixels in block (tile × quadrant) layout.
    bins_q = bins.reshape(grid, 2, th2, grid, 2, tw2).transpose(
        0, 3, 1, 4, 2, 5
    ).reshape(grid, grid, 2, 2, p_blk)
    oh_hi_q = (bins_q[..., None] // 16 == nib).astype(dtype)  # [..,P,16]
    oh_lo_q = (bins_q[..., None] % 16 == nib).astype(dtype)

    # value under each corner LUT: exact one-hot bilinear form
    # V[.., p, c] = Σ_{h,l} oh_hi[p,h] · L[c,h,l] · oh_lo[p,l]
    # precision=HIGHEST on BOTH application contractions: a reduced-precision
    # dot (bf16 or TF32 operands) rounds the non-integer LUT side by up to
    # 0.5 intensity, which the KLT's sub-pixel sensitivity turns into
    # trajectory error. Only the histogram (exact 0/1 operands, f32
    # accumulation) rides bf16.
    hp = jax.lax.Precision.HIGHEST
    T = jnp.einsum("ijabph,ijabhm->ijabpm", oh_hi_q, L2h, precision=hp)
    T = T.reshape(grid, grid, 2, 2, p_blk, 4, 16)
    V = jnp.einsum(
        "ijabpcl,ijabpl->ijabpc", T, oh_lo_q, precision=hp
    )  # [..,P,4]

    # ---- bilinear weights (position-only, no gathers).
    fy = _tile_frac(H, th, grid, dtype).reshape(grid, 2, th2)
    fx = _tile_frac(W, tw, grid, dtype).reshape(grid, 2, tw2)
    fy_b = fy[:, None, :, None, :, None]  # [g,1,2,1,th2,1]
    fx_b = fx[None, :, None, :, None, :]  # [1,g,1,2,1,tw2]
    w = jnp.stack(
        [
            (1 - fy_b) * (1 - fx_b),
            (1 - fy_b) * fx_b,
            fy_b * (1 - fx_b),
            fy_b * fx_b,
        ],
        axis=-1,
    )  # [g,g,2,2,th2,tw2,4]
    w = jnp.broadcast_to(
        w, (grid, grid, 2, 2, th2, tw2, 4)
    ).reshape(grid, grid, 2, 2, p_blk, 4)

    out = jnp.sum(V * w, axis=-1)  # [g,g,2,2,P]
    out = out.reshape(grid, grid, 2, 2, th2, tw2).transpose(
        0, 2, 4, 1, 3, 5
    ).reshape(H, W)
    return out


def _clahe_gather(img, clip_limit: float, grid: int, n_bins: int):
    """Per-pixel LUT gather formulation — correct everywhere; used for
    shapes the one-hot path cannot tile."""
    H, W = img.shape
    dtype = img.dtype
    th, tw = H // grid, W // grid
    npix = th * tw

    vals = jnp.clip(img, 0.0, 255.0)
    tiles = vals.reshape(grid, th, grid, tw).transpose(0, 2, 1, 3).reshape(
        grid * grid, npix
    )

    # Histogram per tile, scatterless: counts[t, b] = #pixels < edge_b via a
    # fused compare+reduce.
    edges = jnp.arange(1, n_bins + 1, dtype=dtype) * (256.0 / n_bins)
    counts = jnp.sum(
        (tiles[:, None, :] < edges[None, :, None]).astype(dtype), axis=-1
    )
    hist = jnp.diff(
        jnp.concatenate([jnp.zeros((grid * grid, 1), dtype), counts], axis=1)
    )
    lut = _tile_luts(hist, clip_limit, npix, n_bins, dtype)
    lut = lut.reshape(grid, grid, n_bins)

    # Bilinear blend of the 4 neighboring tile LUTs per pixel.
    yy = jnp.arange(H, dtype=dtype)[:, None]
    xx = jnp.arange(W, dtype=dtype)[None, :]
    gy = jnp.clip(yy / th - 0.5, 0.0, grid - 1.0)
    gx = jnp.clip(xx / tw - 0.5, 0.0, grid - 1.0)
    y0 = jnp.floor(gy).astype(jnp.int32)
    x0 = jnp.floor(gx).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, grid - 1)
    x1 = jnp.minimum(x0 + 1, grid - 1)
    fy = gy - y0
    fx = gx - x0

    bin_idx = jnp.clip(
        (vals * (n_bins / 256.0)).astype(jnp.int32), 0, n_bins - 1
    )
    y0b = jnp.broadcast_to(y0, (H, W))
    x0b = jnp.broadcast_to(x0, (H, W))
    y1b = jnp.broadcast_to(y1, (H, W))
    x1b = jnp.broadcast_to(x1, (H, W))

    v00 = lut[y0b, x0b, bin_idx]
    v01 = lut[y0b, x1b, bin_idx]
    v10 = lut[y1b, x0b, bin_idx]
    v11 = lut[y1b, x1b, bin_idx]
    fyb = jnp.broadcast_to(fy, (H, W))
    fxb = jnp.broadcast_to(fx, (H, W))
    return (
        v00 * (1 - fyb) * (1 - fxb)
        + v01 * (1 - fyb) * fxb
        + v10 * fyb * (1 - fxb)
        + v11 * fyb * fxb
    )
