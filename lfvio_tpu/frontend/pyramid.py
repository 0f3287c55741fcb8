"""Image pyramid construction (device, shift-add formulation).

Equivalent of the pyramid OpenCV builds inside calcOpticalFlowPyrLK
(reference call: feature_tracker.cpp:127, 3 levels): 5×5 Gaussian smoothing
followed by 2× decimation.

Separable stencils are expressed as products with banded filter matrices
(``_banded``), not single-channel convolutions; whether a separable
convolution or shifted-add form is faster on the GPU is open (ROADMAP S3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# OpenCV pyrDown 5-tap kernel [1, 4, 6, 4, 1] / 16.
_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift(img, dy, dx):
    """Edge-replicating integer shift as pad+slice (no gathers: lowers to
    concatenated static slices, pure VPU/copy work)."""
    H, W = img.shape
    out = img
    if dy:
        pad = ((0, dy), (0, 0)) if dy > 0 else ((-dy, 0), (0, 0))
        out = jnp.pad(out, pad, mode="edge")
        out = out[dy : dy + H, :] if dy > 0 else out[:H, :]
    if dx:
        pad = ((0, 0), (0, dx)) if dx > 0 else ((0, 0), (-dx, 0))
        out = jnp.pad(out, pad, mode="edge")
        out = out[:, dx : dx + W] if dx > 0 else out[:, :W]
    return out


def _sep_filter(img, taps, radius):
    """Separable symmetric filter via shifted adds (rows then cols)."""
    acc = img * taps[radius]
    for d in range(1, radius + 1):
        acc = acc + taps[radius - d] * _shift(img, -d, 0)
        acc = acc + taps[radius + d] * _shift(img, d, 0)
    out = acc * taps[radius]
    for d in range(1, radius + 1):
        out = out + taps[radius - d] * _shift(acc, 0, -d)
        out = out + taps[radius + d] * _shift(acc, 0, d)
    return out


def _banded(n_out, n_in, taps, radius, stride=1):
    """Numpy [n_out, n_in] banded filter matrix with edge replication:
    out[j] = Σ_t taps[t] · in[clip(stride·j + t − radius, 0, n_in−1)].

    Built at TRACE time and embedded as an executable constant, so a
    separable stencil becomes two matrix products; decimation folds into
    the matrix (stride) for free. Edge replication = index clipping with
    duplicate taps accumulating."""
    B = np.zeros((n_out, n_in), np.float64)
    j = np.arange(n_out)
    for t, w in enumerate(taps):
        i = np.clip(stride * j + t - radius, 0, n_in - 1)
        np.add.at(B, (j, i), w)
    return B


def _sep_mm(img, row_mat, col_mat):
    """out = row_mat @ img @ col_matᵀ at HIGHEST precision (a reduced-
    precision dot, bf16 or TF32 operands, would round image values up to
    255 by ~1 or ~0.1)."""
    hp = jax.lax.Precision.HIGHEST
    dt = img.dtype
    a = jnp.asarray(row_mat.astype(np.dtype(jnp.dtype(dt).name)))
    b = jnp.asarray(col_mat.astype(np.dtype(jnp.dtype(dt).name)))
    return jnp.matmul(
        jnp.matmul(a, img, precision=hp), b.T, precision=hp
    )


def _blur_down(img):
    """5x5 separable Gaussian blur + 2x decimation as two strided banded
    matmuls. img: [H, W] float.

    Note the original conv formulation used zero padding on the row pass;
    this uses edge replication on both passes (slightly better near borders,
    tracker-equivalent elsewhere)."""
    H, W = img.shape
    A = _banded(-(-H // 2), H, _K5, 2, 2)
    B = _banded(-(-W // 2), W, _K5, 2, 2)
    return _sep_mm(img, A, B)


def gaussian_pyramid(img, n_levels: int = 3):
    """Returns [L0=img, L1, L2, ...] with n_levels+1 entries (matching
    OpenCV's maxLevel=3 convention of levels 0..3)."""
    levels = [img]
    for _ in range(n_levels):
        levels.append(_blur_down(levels[-1]))
    return levels


def scharr_gradients(img):
    """Scharr 3×3 x/y gradients (the operator cv::calcOpticalFlowPyrLK uses
    for the template derivatives), normalized by 1/32. Shift-add form."""
    # Separable: gx = smooth_y([3,10,3]) ∘ diff_x([-1,0,1]); gy transposed.
    sy = (
        3.0 * _shift(img, -1, 0) + 10.0 * img + 3.0 * _shift(img, 1, 0)
    ) / 32.0
    gx = _shift(sy, 0, 1) - _shift(sy, 0, -1)
    sx = (
        3.0 * _shift(img, 0, -1) + 10.0 * img + 3.0 * _shift(img, 0, 1)
    ) / 32.0
    gy = _shift(sx, 1, 0) - _shift(sx, -1, 0)
    return gx, gy
