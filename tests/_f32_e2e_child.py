"""Child process for the f32 e2e test: runs the bearing-level VIO pipeline
at the accelerator operating point (f32 solver, x64 disabled — the bench
configuration) and prints one JSON line with the ATE. Run by
tests/test_f32.py in a subprocess because x64 is a process-global flag the
CPU-mesh conftest turns on."""

import json
import sys

import pathlib

TESTS = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS.parent))
sys.path.insert(0, str(TESTS))

import jax

jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64

import numpy as np
import jax.numpy as jnp

from lfvio_tpu.runtime.synthetic import SyntheticWorld, make_synthetic_pal_camera
from lfvio_tpu.runtime.estimator import Estimator, EstimatorConfig
from lfvio_tpu.runtime.evaluation import ate_rmse
from _bearing_harness import make_landmarks, run_bearing_stream


def main():
    world = SyntheticWorld(camera=make_synthetic_pal_camera(dtype=jnp.float32))
    landmarks = make_landmarks(n=48)
    est = Estimator(EstimatorConfig(
        n_feature_slots=64, solver_dtype=jnp.float32,
    ))
    run_bearing_stream(est, world, landmarks, duration=6.0, frame_rate=20.0)
    ok = est.solver_flag == est.NON_LINEAR
    times = np.asarray(est.times)
    traj_p = np.asarray(est.traj_p)
    gt_p, _ = world.pose_batch(times)
    ate, n = ate_rmse(times, traj_p, times, gt_p)
    print(json.dumps({
        "initialized": bool(ok),
        "n_frames": int(len(times)),
        "ate_f32": float(ate),
    }))


if __name__ == "__main__":
    main()
