"""Spherical epipolar RANSAC on unit bearing vectors — fully batched.

Re-design of the reference's myfindFundamentalMat / compute_E_21 /
check_inliers (feature_tracker.cpp:186-327): 8-point essential matrix on
*bearings* (valid on the negative half-plane), symmetric cosine residual with
threshold sin(0.5°) = 0.00872653549837, 100 hypotheses, best-score selection,
final refit on inliers.

Formulation: all 100 hypotheses are solved simultaneously — the
minimal-set solves are a batched 9×9 symmetric eigendecomposition of AᵀA
(the null space of the stacked constraints), and scoring is one [100, N]
broadcast. No per-hypothesis loop, no host round trips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

COS_THR = 0.00872653549837  # sin(0.5 deg), reference feature_tracker.cpp:226
N_HYPOTHESES = 100  # reference max_num_iter (feature_tracker.cpp:290)


def _constraint_rows(b1, b2):
    """Epipolar constraint rows: kron(b2, b1) ordered so that row·vec(E) =
    b2ᵀ E b1 with E row-major (compute_E_21's stacking)."""
    return (b2[..., :, None] * b1[..., None, :]).reshape(*b1.shape[:-1], 9)


def _solve_E(A, weights=None):
    """Least-squares essential matrix from constraint rows A [..., n, 9]:
    smallest eigenvector of AᵀA, reshaped row-major, projected to rank 2."""
    if weights is not None:
        A = A * weights[..., None]
    AtA = jnp.einsum("...ni,...nj->...ij", A, A)
    w, V = jnp.linalg.eigh(AtA)
    e = V[..., :, 0]  # smallest eigenvalue's eigenvector
    E = e.reshape(*e.shape[:-1], 3, 3)
    # Rank-2 projection via SVD (batched 3x3).
    U, S, Vt = jnp.linalg.svd(E)
    S2 = S.at[..., 2].set(0.0)
    return U @ (S2[..., :, None] * Vt)


def _score(E, b1, b2, valid):
    """check_inliers semantics: symmetric cosine residuals; a match is an
    inlier iff both directed residuals pass; the score accumulates
    (thr - r2)² whenever r2 passes plus (thr - r1)² when both pass."""
    Eb1 = jnp.einsum("...ij,nj->...ni", E, b1)  # epiplane normal in 2
    Etb2 = jnp.einsum("...ji,nj->...ni", E, b2)  # E^T b2, epiplane in 1
    r2 = jnp.abs(jnp.einsum("...ni,ni->...n", Eb1, b2)) / jnp.maximum(
        jnp.linalg.norm(Eb1, axis=-1), 1e-12
    )
    r1 = jnp.abs(jnp.einsum("...ni,ni->...n", Etb2, b1)) / jnp.maximum(
        jnp.linalg.norm(Etb2, axis=-1), 1e-12
    )
    pass2 = (r2 <= COS_THR) & valid
    pass1 = (r1 <= COS_THR) & valid
    inlier = pass1 & pass2
    score = jnp.sum(
        jnp.where(pass2, (COS_THR - r2) ** 2, 0.0)
        + jnp.where(pass1 & pass2, (COS_THR - r1) ** 2, 0.0),
        axis=-1,
    )
    return inlier, score


def spherical_ransac_e(key, b1, b2, valid, n_hyp: int = N_HYPOTHESES):
    """RANSAC essential matrix between bearing sets b1, b2 [N, 3].

    Returns (E [3,3], inliers [N] bool). Invalid entries are never inliers.
    """
    N = b1.shape[0]
    dtype = b1.dtype

    # Sample minimal sets biased to valid entries: random keys with invalid
    # entries pushed to the end, take the first 8 per hypothesis.
    keys = jax.random.uniform(key, (n_hyp, N)) + (~valid)[None, :] * 10.0
    order = jnp.argsort(keys, axis=-1)[:, :8]  # [n_hyp, 8]
    b1s = b1[order]  # [n_hyp, 8, 3]
    b2s = b2[order]

    A_min = _constraint_rows(b1s, b2s)  # [n_hyp, 8, 9]
    E_hyp = _solve_E(A_min)  # [n_hyp, 3, 3]
    inl_hyp, score_hyp = _score(E_hyp, b1, b2, valid)  # [n_hyp, N], [n_hyp]

    best = jnp.argmax(score_hyp)
    best_inl = inl_hyp[best]

    # Final refit on the best hypothesis's inliers + rescore (reference
    # feature_tracker.cpp:311-326).
    A_all = _constraint_rows(b1, b2)
    E_fit = _solve_E(A_all, weights=best_inl.astype(dtype))
    inliers, _ = _score(E_fit, b1, b2, valid)
    # Degenerate safety: if the refit collapses (< 8 inliers), keep the
    # hypothesis inliers instead.
    ok = jnp.sum(inliers) >= 8
    inliers = jnp.where(ok, inliers, best_inl)
    E_out = jnp.where(ok, E_fit, E_hyp[best])
    return E_out, inliers
