"""Test configuration: run everything on a virtual 8-device CPU mesh with x64
enabled, so numerics are validated in double precision and the distributed
layer is testable without accelerators (SURVEY.md §4e).

Tests marked ``gpu`` need a card: run them there with
``LFVIO_TEST_PLATFORM=cuda,cpu python -m pytest -m gpu tests/``. They skip
through the ``gpu_device`` fixture everywhere else."""

import os
import sys

import pytest

# JAX tracing uses deep interpreter stacks; pytest's own frames push past
# the default 1000 limit.
sys.setrecursionlimit(5000)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Tests run on the CPU unless LFVIO_TEST_PLATFORM names other platforms; the
# config API (not only the env var) pins it before any backend starts.
_platform = os.environ.get("LFVIO_TEST_PLATFORM", "cpu")
jax.config.update("jax_platforms", _platform)
# x64 on the CPU mesh validates numerics in double precision; on a card the
# operating point is f32.
jax.config.update("jax_enable_x64", _platform == "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (LFVIO_TEST_PLATFORM=cuda,cpu on a card)")
    return gpus[0]
