"""PAL → equirectangular panorama remap.

Equivalent of the pointcloud_image_fusion node's remap-table construction +
cv::remap (reference pointcloud_image_fusion.cpp:83-114): build the inverse
map once (pano pixel → direction → camera pixel via space_to_plane), then
every frame is one batched bilinear gather on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class PanoramaRemapper:
    def __init__(self, camera, src_shape, pano_width=1024, pano_height=256,
                 lat_min_deg=-50.0, lat_max_deg=40.0, dtype=jnp.float32):
        """lat range covers the PAL annulus's elevation span
        (reference rig: 360° × (−50°..+40°) about the horizon)."""
        self.H, self.W = src_shape
        lon = np.linspace(-np.pi, np.pi, pano_width, endpoint=False)
        lat = np.linspace(np.radians(lat_max_deg), np.radians(lat_min_deg),
                          pano_height)
        lon_g, lat_g = np.meshgrid(lon, lat)
        # Direction in camera frame: z up toward +elevation? The OCAM model
        # maps theta=atan2(-z, r); elevation>0 (inner annulus) has z<0 in
        # pixel terms... use the lift convention: direction with
        # z = sin(lat) * (-1)?  We pick d = (cos(lat)cos(lon),
        # cos(lat)sin(lon), -sin(lat)) so that lat>0 projects to the inner
        # annulus (theta>0) per spaceToPlane's theta=atan2(-z, rxy).
        d = np.stack(
            [
                np.cos(lat_g) * np.cos(lon_g),
                np.cos(lat_g) * np.sin(lon_g),
                -np.sin(lat_g),
            ],
            axis=-1,
        )
        pix = np.asarray(camera.space_to_plane(jnp.asarray(d.reshape(-1, 3))))
        # HOST (numpy) constants: _remap_impl closes over the maps, which
        # become trace constants (see runtime/tracker.py FrontEnd.__init__).
        npdt = np.dtype(jnp.dtype(dtype).name)
        self.map_x = np.asarray(
            pix[:, 0].reshape(pano_height, pano_width), npdt
        )
        self.map_y = np.asarray(
            pix[:, 1].reshape(pano_height, pano_width), npdt
        )
        self._remap = jax.jit(self._remap_impl)

    def _remap_impl(self, img):
        H, W = img.shape
        map_x = jnp.asarray(self.map_x)  # numpy -> trace constant
        map_y = jnp.asarray(self.map_y)
        x = jnp.clip(map_x, 0.0, W - 1.001)
        y = jnp.clip(map_y, 0.0, H - 1.001)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = x - x0
        fy = y - y0
        v00 = img[y0, x0]
        v01 = img[y0, x0 + 1]
        v10 = img[y0 + 1, x0]
        v11 = img[y0 + 1, x0 + 1]
        out = (
            v00 * (1 - fy) * (1 - fx)
            + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx)
            + v11 * fy * fx
        )
        # Mark pano pixels whose source fell outside the image.
        inside = (
            (map_x >= 0) & (map_x < W - 1)
            & (map_y >= 0) & (map_y < H - 1)
        )
        return jnp.where(inside, out, 0.0)

    def remap(self, img):
        return self._remap(jnp.asarray(img))
