"""chip_smoke.py's checks and the pieces they drive, at small sizes.

The CPU tests run the tracker and solver parity checks with a float64
reference on the CPU (the script compares the card against the CPU the same
way) and the feature-sharded frame step on a 4-device CPU mesh. The ``gpu``
tests run the same checks against a card."""

import inspect
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke.py sits at the checkout root

import chip_smoke  # noqa: E402
from lfvio_tpu.runtime import device as devmod  # noqa: E402
from lfvio_tpu.runtime.synthetic import (  # noqa: E402
    MINDVISION_ANNULUS, MINDVISION_SIZE, SyntheticWorld,
    make_mindvision_pal_camera, make_synthetic_pal_camera,
)
from lfvio_tpu.runtime.tracker import FrontEnd  # noqa: E402

# A 256×192 crop of the synthetic PAL rig's view, annulus inside the image.
SIZE = (192, 256)
ANNULUS = (128.0, 96.0, 94.0, 30.0)


def _camera():
    return make_synthetic_pal_camera(width=SIZE[1], height=SIZE[0],
                                     dtype=jnp.float32)


def test_entry_point_refuses_a_cpu_device():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert "no GPU" in str(e.value.code)


def test_require_gpu_accepts_only_a_gpu_first():
    class Dev:
        def __init__(self, platform):
            self.platform = platform

    devmod.require_gpu([Dev("gpu"), Dev("cpu")])
    for devices in ([Dev("cpu"), Dev("gpu")], []):
        with pytest.raises(SystemExit):
            devmod.require_gpu(devices)


@pytest.mark.parametrize("env_dir", ["/some/where/jax-cache", None])
def test_compile_cache_placement(monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv(devmod.CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(devmod.CACHE_ENV, env_dir)
    before = jax.config.jax_compilation_cache_dir
    try:
        used = devmod.setup_compile_cache()
        after = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_dir is not None:
        # JAX reads the variable itself; nothing is set in code.
        assert used == env_dir and after == before
    else:
        fixed = ROOT / ".jax_cache"
        assert used == after == str(fixed)
        ignored = (ROOT / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored


def test_frontend_builds_and_steps_without_a_kernel_option():
    assert set(inspect.signature(FrontEnd).parameters) == {
        "camera", "image_size", "max_cnt", "min_dist", "n_slots", "equalize",
        "annulus", "n_levels", "border", "dtype", "seed", "refine_win",
        "id_counter",
    }
    cam = _camera()
    world = SyntheticWorld(camera=cam, width=SIZE[1], height=SIZE[0])
    fe = FrontEnd(cam, SIZE, max_cnt=40, min_dist=12, n_slots=48,
                  annulus=ANNULUS, equalize=True, dtype=jnp.float32)
    assert fe.process_arrays(world.render_u8(0.0), 0.0) is None
    fe.process_arrays(world.render_u8(1 / 15), 1 / 15)
    ids, bearings, vels, rows, pub = fe.process_arrays(
        world.render_u8(2 / 15), 2 / 15)
    assert ids.shape == (48,) and bearings.shape == vels.shape == (48, 3)
    assert pub.sum() >= 10, pub.sum()
    np.testing.assert_allclose(
        np.linalg.norm(bearings[pub], axis=-1), 1.0, atol=1e-5)


def test_tracker_parity_f32_against_f64_reference():
    cpu = jax.devices("cpu")[0]
    res = chip_smoke.tracker_parity(
        cpu, cpu, _camera(), SIZE, ANNULUS, n_slots=48, max_cnt=40,
        min_dist=12, ref_dtype=np.float64, precisions=("default",))
    r = res["default"]
    assert r["n_valid"] >= 20 and r["n_tracked_both"] >= 10, r
    chip_smoke.check_tracker_parity(r)


def test_solve_parity_f32_against_f64_reference():
    cpu = jax.devices("cpu")[0]
    res = chip_smoke.solve_parity(cpu, cpu, n_slots=64,
                                  precisions=("default",))
    # Same device, same dtype: the reference device's own f32 row is the
    # device row.
    assert res["default"] == res["ref_device_f32"]
    chip_smoke.check_solve("solve", res["default"])
    assert res["default"]["pos_max_m"] > 0.0  # f32 really ran against f64


def test_sharded_frame_step_matches_single_device_on_cpu_mesh():
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    dev, counts = chip_smoke.sharded_frame_step(devices, n_slots=64)
    assert counts == [4]
    chip_smoke.check_solve("four", dev, chip_smoke.DIST_POS_TOL_M,
                           chip_smoke.DIST_COST_RTOL)


@pytest.mark.gpu
def test_tracker_parity_on_gpu(gpu_device):
    # The full bench rig: on a small crop with few slots RANSAC's choice
    # among near-tied hypotheses differs between devices (chip_smoke.py).
    res = chip_smoke.tracker_parity(
        gpu_device, jax.devices("cpu")[0],
        make_mindvision_pal_camera(jnp.float32), MINDVISION_SIZE,
        MINDVISION_ANNULUS, precisions=("default",))
    chip_smoke.check_tracker_parity(res["default"])


@pytest.mark.gpu
def test_solve_parity_on_gpu(gpu_device):
    res = chip_smoke.solve_parity(gpu_device, jax.devices("cpu")[0],
                                  n_slots=64, precisions=("default",))
    chip_smoke.check_solve("solve", res["default"])
