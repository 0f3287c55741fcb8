import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lfvio_tpu import geom
from lfvio_tpu.frontend import (
    gaussian_pyramid,
    pyramidal_lk,
    shi_tomasi_response,
    select_features,
    annulus_mask,
    clahe,
    spherical_ransac_e,
)


def smooth_texture(h, w, seed=0, octaves=4):
    """Band-limited random texture with plenty of trackable structure."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w))
    for o in range(octaves):
        s = 2**o
        noise = rng.standard_normal((h // (8 * s) + 2, w // (8 * s) + 2))
        import cv2

        up = cv2.resize(noise, (w, h), interpolation=cv2.INTER_CUBIC)
        img += up * (1.5**o)
    img -= img.min()
    img *= 255.0 / img.max()
    return img.astype(np.float32)


def test_pyramid_matches_opencv():
    cv2 = pytest.importorskip("cv2")
    img = smooth_texture(96, 128)
    pyr = gaussian_pyramid(jnp.asarray(img), 2)
    down1 = cv2.pyrDown(img)
    # Interior must agree closely (border handling differs).
    np.testing.assert_allclose(
        np.asarray(pyr[1])[2:-2, 2:-2], down1[2:-2, 2:-2], atol=1.0
    )


def test_klt_recovers_constant_shift():
    cv2 = pytest.importorskip("cv2")
    img0 = smooth_texture(240, 320, seed=1)
    shift = (7.3, -4.6)  # (dx, dy) — needs the pyramid to catch it
    M = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    img1 = cv2.warpAffine(img0, M, (320, 240), flags=cv2.INTER_LINEAR)

    # Track well-textured interior points.
    pts = np.stack(
        np.meshgrid(np.arange(60, 260, 25), np.arange(60, 180, 25)), -1
    ).reshape(-1, 2).astype(np.float32)
    N = pts.shape[0]

    pyr0 = gaussian_pyramid(jnp.asarray(img0), 3)
    pyr1 = gaussian_pyramid(jnp.asarray(img1), 3)
    out, ok = pyramidal_lk(pyr0, pyr1, jnp.asarray(pts), jnp.ones(N, bool))
    out, ok = np.asarray(out), np.asarray(ok)

    assert ok.mean() > 0.8, ok
    flow = out[ok] - pts[ok]
    err = np.abs(flow - np.asarray(shift))
    assert np.median(err[:, 0]) < 0.25, np.median(err, 0)
    assert np.median(err[:, 1]) < 0.25, np.median(err, 0)

    # Cross-check accuracy against OpenCV's own tracker on the same data.
    cv_out, cv_st, _ = cv2.calcOpticalFlowPyrLK(
        img0.astype(np.uint8), img1.astype(np.uint8),
        pts.reshape(-1, 1, 2), None, winSize=(41, 41), maxLevel=3,
    )
    cv_flow = cv_out.reshape(-1, 2)[cv_st.ravel() > 0] - pts[cv_st.ravel() > 0]
    cv_err = np.abs(cv_flow - np.asarray(shift)).mean()
    our_err = err.mean()
    assert our_err < max(3 * cv_err, 0.35), (our_err, cv_err)


def test_klt_rejects_flat_regions():
    img0 = np.full((240, 320), 128.0, np.float32)
    img1 = img0.copy()
    pts = np.array([[100.0, 100.0], [200.0, 150.0]], np.float32)
    pyr0 = gaussian_pyramid(jnp.asarray(img0), 3)
    pyr1 = gaussian_pyramid(jnp.asarray(img1), 3)
    _, ok = pyramidal_lk(pyr0, pyr1, jnp.asarray(pts), jnp.ones(2, bool))
    assert not np.asarray(ok).any()


def test_detect_matches_opencv_corners():
    """Our Shi-Tomasi selection should land on (mostly) the same corners as
    cv::goodFeaturesToTrack with the reference's parameters."""
    cv2 = pytest.importorskip("cv2")
    img = smooth_texture(240, 320, seed=7)
    resp = shi_tomasi_response(jnp.asarray(img))
    mask = jnp.ones((240, 320), bool)
    pts, ok = select_features(
        resp, mask, jnp.zeros((1, 2)), jnp.zeros((1,), bool), 40, min_dist=20
    )
    ours = np.asarray(pts)[np.asarray(ok)]
    cv_pts = cv2.goodFeaturesToTrack(
        img.astype(np.uint8), 40, 0.01, 20
    ).reshape(-1, 2)
    assert len(ours) >= 20
    d = np.linalg.norm(ours[:, None, :] - cv_pts[None, :, :], axis=-1).min(1)
    frac_close = (d < 5.0).mean()
    assert frac_close > 0.5, (frac_close, d)


def test_detect_respects_mask_and_spacing():
    rng = np.random.default_rng(2)
    img = smooth_texture(240, 240, seed=3)
    resp = shi_tomasi_response(jnp.asarray(img))
    mask = annulus_mask((240, 240), 120.0, 120.0, 100.0, 40.0)
    existing = jnp.asarray([[150.0, 120.0]])
    pts, ok = select_features(
        resp, mask, existing, jnp.ones((1,), bool), 40, min_dist=20
    )
    pts, ok = np.asarray(pts), np.asarray(ok)
    got = pts[ok]
    r = np.linalg.norm(got - [120, 120], axis=-1)
    assert (r <= 101).all() and (r >= 39).all()
    # spacing among selected and vs existing
    d_exist = np.linalg.norm(got - [150, 120], axis=-1)
    assert (d_exist >= 19).all()
    for i in range(len(got)):
        for j in range(i + 1, len(got)):
            assert np.linalg.norm(got[i] - got[j]) >= 19


def test_clahe_close_to_opencv():
    cv2 = pytest.importorskip("cv2")
    img = smooth_texture(240, 320, seed=4)
    ours = np.asarray(clahe(jnp.asarray(img), 3.0, 8))
    cv = cv2.createCLAHE(3.0, (8, 8)).apply(img.astype(np.uint8)).astype(np.float32)
    # Same transform family; allow small deviations from rounding and
    # border interpolation differences.
    diff = np.abs(ours - cv)
    assert np.median(diff) < 6.0, np.median(diff)
    assert diff.mean() < 10.0, diff.mean()
    # Must actually equalize: higher local contrast than input.
    assert ours.std() > img.std() * 1.05


def test_spherical_ransac_rejects_outliers():
    rng = np.random.default_rng(5)
    N = 200
    # Two camera poses with baseline; bearings over the full sphere.
    R = np.asarray(geom.quat_to_mat(geom.so3_exp(jnp.asarray([0.02, -0.03, 0.05]))))
    t = np.array([0.3, 0.1, -0.05])
    pts = rng.standard_normal((N, 3)) * 4.0
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    # Mix in negative-plane points (behind z=0 in cam 1).
    pts[::3, 2] = -np.abs(pts[::3, 2]) - 0.5
    b1 = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    p2 = (pts - t) @ R  # coordinates in frame 2 (R: world->cam2 columns)
    b2 = p2 / np.linalg.norm(p2, axis=-1, keepdims=True)

    # Corrupt 25% with random directions.
    n_out = N // 4
    out_idx = rng.choice(N, n_out, replace=False)
    fake = rng.standard_normal((n_out, 3))
    b2_noisy = b2.copy()
    b2_noisy[out_idx] = fake / np.linalg.norm(fake, axis=-1, keepdims=True)

    E, inl = spherical_ransac_e(
        jax.random.PRNGKey(0),
        jnp.asarray(b1),
        jnp.asarray(b2_noisy),
        jnp.ones(N, bool),
    )
    inl = np.asarray(inl)
    is_out = np.zeros(N, bool)
    is_out[out_idx] = True
    # All kept matches must be true inliers; most true inliers kept.
    assert (inl & is_out).sum() <= 2, (inl & is_out).sum()
    assert inl[~is_out].mean() > 0.9, inl[~is_out].mean()


def test_exclusion_zone_equals_window_max_reference():
    """occupancy_dilated (separable 0/1 product) against the plain
    definition: max of the point-occupancy map over a (2·min_dist+1)²
    window, points rounded and clipped into the image."""
    from lfvio_tpu.frontend.detect import occupancy_dilated

    rng = np.random.default_rng(0)
    for t in range(6):
        H, W = 60 + 7 * t, 90 - 5 * t
        n = int(rng.integers(1, 40))
        pts = rng.uniform(-8, [W + 8, H + 8], (n, 2))
        valid = rng.random(n) < 0.7
        md = int(rng.integers(1, 15))
        iy = np.clip(np.round(pts[:, 1]).astype(int), 0, H - 1)
        ix = np.clip(np.round(pts[:, 0]).astype(int), 0, W - 1)
        yy, xx = np.mgrid[0:H, 0:W]
        ref = np.zeros((H, W), bool)
        for y, x in zip(iy[valid], ix[valid]):
            ref |= (np.abs(yy - y) <= md) & (np.abs(xx - x) <= md)
        got = occupancy_dilated((H, W), jnp.asarray(pts), jnp.asarray(valid), md)
        np.testing.assert_array_equal(np.asarray(got), ref)


def test_top_k_exact_matches_lax_top_k():
    """The sort-based top-k equals lax.top_k, ties included (lower index
    first), on a sparse map like the masked corner response."""
    from lfvio_tpu.frontend.detect import top_k_exact

    rng = np.random.default_rng(1)
    x = rng.random(5000).astype(np.float32)
    x[x < 0.8] = 0.0
    x[::97] = 0.5  # exact ties among positive values
    for k in (1, 64, 800):
        got = top_k_exact(jnp.asarray(x), k)
        ref = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
