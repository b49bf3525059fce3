"""Test configuration: CPU backend with 8 virtual devices + float64.

Correctness tests run in f64 on CPU to match the reference's LAPACK-based
tolerances (SURVEY.md §4); sharding tests use the 8-device virtual mesh.
Must set env BEFORE jax initializes.

When ``JAX_PLATFORMS`` already names CUDA (``chip_smoke.py`` runs
``pytest -m gpu`` that way on the card), the CPU is not forced, so the
gpu-marked tests (tests/test_gpu.py) see the card.
"""
import os

_ON_CARD = "cuda" in os.environ.get("JAX_PLATFORMS", "").lower()
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from randlapack_tpu.utils import enable_compile_cache  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compile cache: test matrices are fixed-shape, so reruns are fast
enable_compile_cache(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng_np():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables + their baked-in constants after each
    test module. With hundreds of live jitted programs the suite
    deterministically SEGFAULTED ~85% in inside jax's persistent-cache
    serializer (both the read and the write path; the same test passes in
    isolation, and the host has ample RAM — some executable-count-
    dependent state in the serializer). Clearing per module avoids the
    crash and also cut the full-suite wall time ~3x (329 s); the on-disk
    cache keeps re-JITs cheap."""
    yield
    jax.clear_caches()
