"""Test configuration: CPU with an 8-device virtual mesh.

Tests exercise the multi-chip sharding path (jax.sharding.Mesh over 8 virtual
CPU devices) without accelerator hardware. JAX_PLATFORMS picks the backend
(default cpu); the GPU-only tests (marker `gpu`, tests/test_chip.py) run with
JAX_PLATFORMS=cuda on a machine with the card. Must set env BEFORE jax is
imported anywhere.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from vil_fusion_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

# Persistent compilation cache: the suite is compile-dominated (most of it
# XLA:CPU LLVM). Cached executables survive across pytest processes;
# jax.clear_caches() below only drops the in-memory handles.
use_compile_cache()

import pytest  # noqa: E402


_HEAVY_MODULES = ("test_ba", "test_estimator", "test_lidar", "test_loops",
                  "test_pipeline", "test_initialization", "test_visual_loop")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module(request):
    """Release compiled executables after compile-heavy modules: the CPU
    backend's LLVM JIT segfaults nondeterministically once hundreds of
    programs accumulate in one process (observed in full-suite runs).
    Clearing only after the heavy modules bounds the live executable count
    without forcing recompiles of the cheap shared helpers."""
    yield
    if any(request.module.__name__.startswith(m) for m in _HEAVY_MODULES):
        jax.clear_caches()


@pytest.fixture(scope="session")
def mesh8():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual devices, got {len(devs)}"
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(devs[:8]).reshape(4, 2), ("data", "model"))
