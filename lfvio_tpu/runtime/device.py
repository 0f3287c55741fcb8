"""Accelerator checks shared by the entry points (chip_smoke.py, bench.py,
``python -m lfvio_tpu.runtime.profiling``).

* :func:`setup_compile_cache` places JAX's persistent compilation cache.
  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
  is set here; otherwise the cache lives at the fixed ``<checkout>/.jax_cache``
  (the path is part of the cache key, so it never moves).
* :func:`require_gpu` refuses to measure anything on a non-GPU device: no
  CPU fallback.
* :func:`device_line` names the device every printed number was taken on,
  with the card's name and power limit from ``nvidia-smi`` (a child process
  that stays off JAX).
"""

from __future__ import annotations

import os
import pathlib
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


def compile_cache_dir(environ=os.environ) -> str | None:
    """The cache directory this process must set in code: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX already honours it)."""
    if environ.get(CACHE_ENV):
        return None
    return str(DEFAULT_CACHE_DIR)


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    import jax

    path = compile_cache_dir()
    if path is None:
        return os.environ[CACHE_ENV]
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(devices) -> None:
    """Raise SystemExit unless the first device is a GPU."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(
            f"no GPU: jax.devices()[0].platform={platform!r}; this entry "
            "point measures the accelerator and has no CPU fallback"
        )


def card_info() -> str:
    """``name, power.limit`` of every visible card, one per line, as
    nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_line(devices) -> str:
    """One line naming the JAX device set and the card(s) behind it."""
    d0 = devices[0]
    cards = card_info().splitlines()
    return (
        f"platform={d0.platform} device_kind={d0.device_kind} "
        f"count={len(devices)} card={cards[0] if cards else 'unknown'}"
    )
