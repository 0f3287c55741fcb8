"""f32 operating-point validation (SURVEY §7 hard part #1): the estimator
must hold VIO-grade accuracy at the accelerator operating point — f32 solver,
x64 OFF — not only in the f64 configuration the CPU-mesh suite uses.

The f32 run happens in a subprocess (x64 is process-global); the f64
reference runs in-process on the identical scenario."""

import pytest
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp

from lfvio_tpu.runtime.synthetic import SyntheticWorld, make_synthetic_pal_camera
from lfvio_tpu.runtime.estimator import Estimator, EstimatorConfig
from lfvio_tpu.runtime.evaluation import ate_rmse

from _bearing_harness import make_landmarks, run_bearing_stream


@pytest.mark.slow
def test_f32_e2e_ate_matches_f64():
    # f64 reference in-process (conftest: x64 on).
    world = SyntheticWorld(camera=make_synthetic_pal_camera())
    landmarks = make_landmarks(n=48)
    est = Estimator(EstimatorConfig(n_feature_slots=64, solver_dtype=jnp.float64))
    run_bearing_stream(est, world, landmarks, duration=6.0, frame_rate=20.0)
    assert est.solver_flag == est.NON_LINEAR
    times = np.asarray(est.times)
    gt_p, _ = world.pose_batch(times)
    ate64, _ = ate_rmse(times, np.asarray(est.traj_p), times, gt_p)
    assert np.isfinite(ate64)

    # f32 run at the real operating point, clean environment.
    env = dict(os.environ)
    env.pop("JAX_ENABLE_X64", None)
    env["JAX_PLATFORMS"] = "cpu"
    child = os.path.join(os.path.dirname(__file__), "_f32_e2e_child.py")
    out = subprocess.run(
        [sys.executable, child], env=env, capture_output=True, text=True,
        timeout=540, cwd=os.path.dirname(os.path.dirname(child)),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["initialized"], result
    ate32 = result["ate_f32"]

    # f32 must be VIO-grade: within 2x of the f64 run (plus an absolute
    # floor so a tiny f64 ATE can't make the relative bound vacuous-tight).
    assert ate32 < max(2.0 * ate64, 0.05), (ate32, ate64)
