"""AR overlay: project virtual objects into the camera image.

Equivalent of the reference ar_demo package (ar_demo/src/ar_demo_node.cpp):
virtual cubes/axes placed in the world frame are projected into the live
image through the calibrated camera model (``space_to_plane``) at the
estimator's odometry pose — a fidelity demo of the projection model on
large-FoV cameras, where straight world edges become strongly curved image
curves.

Design: the projection of all sampled edge points is one batched
``space_to_plane`` call (the reference projects point-by-point per marker);
rasterization of the projected polylines is a host-side numpy loop (output
imagery is a host artifact, like the reference's cv::line drawing).
"""

from __future__ import annotations

import numpy as np


def _cube_edges(center, size):
    """12 edges of an axis-aligned cube as (p0, p1) world-point pairs."""
    c = np.asarray(center, np.float64)
    h = float(size) / 2.0
    corners = np.array(
        [
            [sx, sy, sz]
            for sx in (-h, h)
            for sy in (-h, h)
            for sz in (-h, h)
        ]
    ) + c
    idx = []
    for i in range(8):
        for j in range(i + 1, 8):
            # Edge iff the corners differ in exactly one coordinate.
            if np.sum(np.abs(corners[i] - corners[j]) > 1e-12) == 1:
                idx.append((i, j))
    return corners, idx


class ArRenderer:
    """Projects virtual wireframe objects into images given camera pose.

    Parameters
    ----------
    camera : a camera model exposing ``space_to_plane`` (batched over [N,3])
    width, height : image size for clipping.
    samples_per_edge : straight world edges are sampled densely so their
        curved image projections render faithfully on the PAL annulus.
    """

    def __init__(self, camera, width: int, height: int, samples_per_edge: int = 32):
        self.camera = camera
        self.width = int(width)
        self.height = int(height)
        self.samples = int(samples_per_edge)
        self.objects = []  # list of (world_pts [E, S, 3], color)

    def add_cube(self, center, size: float, color=(0, 255, 0)):
        corners, edges = _cube_edges(center, size)
        t = np.linspace(0.0, 1.0, self.samples)
        segs = np.stack(
            [
                corners[i][None, :] * (1 - t)[:, None] + corners[j][None, :] * t[:, None]
                for i, j in edges
            ]
        )  # [12, S, 3]
        self.objects.append((segs, tuple(color)))

    def add_axes(self, origin, length: float = 1.0):
        o = np.asarray(origin, np.float64)
        t = np.linspace(0.0, 1.0, self.samples)
        for axis, color in zip(np.eye(3), [(255, 0, 0), (0, 255, 0), (0, 0, 255)]):
            seg = (o[None, :] * (1 - t)[:, None]
                   + (o + length * axis)[None, :] * t[:, None])
            self.objects.append((seg[None], tuple(color)))

    # ------------------------------------------------------------------
    def project(self, R_wc, t_wc):
        """Project all object edge samples into the image.

        R_wc, t_wc: camera pose in the world (x_w = R_wc x_c + t_wc).
        Returns list of (pix [E, S, 2], in_front [E, S] bool, color).
        """
        import jax.numpy as jnp

        R_cw = np.asarray(R_wc, np.float64).T
        t_cw = -R_cw @ np.asarray(t_wc, np.float64)
        out = []
        for segs, color in self.objects:
            E, S, _ = segs.shape
            pc = segs.reshape(-1, 3) @ R_cw.T + t_cw  # camera-frame points
            pix = np.asarray(
                self.camera.space_to_plane(jnp.asarray(pc, jnp.float32))
            ).reshape(E, S, 2)
            # Large-FoV: "in front" means the ray is inside the modeled FoV;
            # for the PAL annulus every direction with finite projection is
            # drawable — gate only on non-degenerate range.
            rng = np.linalg.norm(pc, axis=-1).reshape(E, S)
            ok = (rng > 1e-3) & np.isfinite(pix).all(axis=-1)
            out.append((pix, ok, color))
        return out

    def render(self, img, R_wc, t_wc, thickness: int = 1):
        """Draw the projected objects onto img (H, W[, 3] uint8) in place
        and return it."""
        img = np.ascontiguousarray(img)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        for pix, ok, color in self.project(R_wc, t_wc):
            E, S, _ = pix.shape
            for e in range(E):
                for s in range(S - 1):
                    if ok[e, s] and ok[e, s + 1]:
                        self._line(img, pix[e, s], pix[e, s + 1], color, thickness)
        return img

    def _line(self, img, p0, p1, color, thickness):
        h, w = img.shape[:2]
        n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
        if n > max(h, w):  # segment wraps across the annulus — skip
            return
        xs = np.linspace(p0[0], p1[0], n).round().astype(int)
        ys = np.linspace(p0[1], p1[1], n).round().astype(int)
        for r in range(-thickness + 1, thickness):
            for c in range(-thickness + 1, thickness):
                x = np.clip(xs + c, 0, w - 1)
                y = np.clip(ys + r, 0, h - 1)
                m = (xs + c >= 0) & (xs + c < w) & (ys + r >= 0) & (ys + r < h)
                img[y[m], x[m]] = color
