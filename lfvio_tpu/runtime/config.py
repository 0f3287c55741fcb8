"""Full rig-configuration ingestion: ONE YAML file → the whole pipeline.

Equivalent of the reference's two config loaders
(/root/reference/vins_estimator/src/parameters.cpp:42-139 and
/root/reference/feature_tracker/src/parameters.cpp:43-84): a single
OpenCV-FileStorage YAML carries the camera intrinsics, IMU noise, annulus
mask, publish frequency, solver budgets, extrinsics (with the 0/1/2 trust
mode), td and rolling-shutter parameters. `load_rig_yaml` parses it into a
`RigConfig`; `RigConfig.make_pipeline()` builds the ready-to-run
FrontEnd + Estimator + VioPipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from ..cam.models import _parse_opencv_yaml, camera_from_dict
from ..imu import ImuNoise


@dataclasses.dataclass
class RigConfig:
    """Everything readParameters reads, in one place."""

    camera_cfg: dict
    image_width: int
    image_height: int
    # feature tracker (feature_tracker/src/parameters.cpp:43-84)
    max_cnt: int = 200
    min_dist: int = 20
    freq: float = 10.0
    equalize: bool = True
    annulus: tuple | None = None  # (center_x, center_y, max_r, min_r)
    # solver budgets (vins_estimator/src/parameters.cpp:55-57)
    max_num_iterations: int = 8
    max_solver_time: float = 0.04
    keyframe_parallax: float = 10.0  # pixels at virtual focal 160
    # IMU noise (parameters.cpp:90-95)
    acc_n: float = 0.02
    gyr_n: float = 0.01
    acc_w: float = 0.04
    gyr_w: float = 0.001
    g_norm: float = 9.81
    # extrinsics (parameters.cpp:60-89): 0 = trust, 1 = optimize around,
    # 2 = calibrate rotation online from scratch
    estimate_extrinsic: int = 0
    ric: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    tic: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # temporal calibration (parameters.cpp:103-124)
    estimate_td: bool = False
    td: float = 0.0
    rolling_shutter: bool = False
    rolling_shutter_tr: float = 0.0
    # output
    output_path: str = ""

    # ------------------------------------------------------------- builders
    def make_camera(self, dtype=jnp.float32):
        return camera_from_dict(self.camera_cfg, dtype=dtype)

    def make_frontend(self, n_slots: int = 256, dtype=jnp.float32, **kw):
        from .tracker import FrontEnd

        return FrontEnd(
            self.make_camera(dtype),
            (self.image_height, self.image_width),
            max_cnt=self.max_cnt,
            min_dist=self.min_dist,
            n_slots=n_slots,
            equalize=self.equalize,
            annulus=self.annulus,
            dtype=dtype,
            **kw,
        )

    def make_estimator(self, n_slots: int = 256, solver_dtype=jnp.float32, **kw):
        from .estimator import Estimator, EstimatorConfig

        cfg = EstimatorConfig(
            n_feature_slots=n_slots,
            min_parallax=self.keyframe_parallax / 160.0,
            imu_noise=ImuNoise(self.acc_n, self.gyr_n, self.acc_w, self.gyr_w),
            g_norm=self.g_norm,
            estimate_td=self.estimate_td,
            estimate_extrinsic=self.estimate_extrinsic >= 1,
            calib_extrinsic_rotation=self.estimate_extrinsic == 2,
            td0=self.td,
            tic=np.asarray(self.tic, np.float64),
            ric=np.asarray(self.ric, np.float64),
            max_iterations=self.max_num_iterations,
            max_solver_time=self.max_solver_time,
            solver_dtype=solver_dtype,
            rolling_shutter_tr=(
                self.rolling_shutter_tr if self.rolling_shutter else 0.0
            ),
            image_rows=self.image_height,
            **kw,
        )
        return Estimator(cfg)

    def make_pipeline(self, n_slots: int = 256, dtype=jnp.float32, **kw):
        from .pipeline import VioPipeline

        fe = self.make_frontend(n_slots=n_slots, dtype=dtype)
        est = self.make_estimator(n_slots=n_slots, solver_dtype=dtype)
        return VioPipeline(fe, est, freq=self.freq, td=self.td, **kw)


def _mat(node, shape):
    return np.asarray(node["data"], np.float64).reshape(shape)


def load_rig_yaml(path_or_text: str) -> RigConfig:
    """Parse a reference-format rig YAML (path or literal text)."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    d = _parse_opencv_yaml(text)

    annulus = None
    if all(k in d for k in ("center_x", "center_y", "max_r", "min_r")):
        annulus = (
            float(d["center_x"]), float(d["center_y"]),
            float(d["max_r"]), float(d["min_r"]),
        )

    est_ex = int(d.get("estimate_extrinsic", 0))
    ric, tic = np.eye(3), np.zeros(3)
    if est_ex != 2:
        if "extrinsicRotation" in d:
            ric = _mat(d["extrinsicRotation"], (3, 3))
        if "extrinsicTranslation" in d:
            tic = _mat(d["extrinsicTranslation"], (3,))

    return RigConfig(
        camera_cfg=d,
        image_width=int(d.get("image_width", 640)),
        image_height=int(d.get("image_height", 480)),
        max_cnt=int(d.get("max_cnt", 200)),
        min_dist=int(d.get("min_dist", 20)),
        freq=float(d.get("freq", 10.0)),
        equalize=bool(int(d.get("equalize", 1))),
        annulus=annulus,
        max_num_iterations=int(d.get("max_num_iterations", 8)),
        max_solver_time=float(d.get("max_solver_time", 0.04)),
        keyframe_parallax=float(d.get("keyframe_parallax", 10.0)),
        acc_n=float(d.get("acc_n", 0.02)),
        gyr_n=float(d.get("gyr_n", 0.01)),
        acc_w=float(d.get("acc_w", 0.04)),
        gyr_w=float(d.get("gyr_w", 0.001)),
        g_norm=float(d.get("g_norm", 9.81)),
        estimate_extrinsic=est_ex,
        ric=ric,
        tic=tic,
        estimate_td=bool(int(d.get("estimate_td", 0))),
        td=float(d.get("td", 0.0)),
        rolling_shutter=bool(int(d.get("rolling_shutter", 0))),
        rolling_shutter_tr=float(d.get("rolling_shutter_tr", 0.0)),
        output_path=str(d.get("output_path", "")),
    )
