"""Test harness setup: 8 virtual CPU devices before anything initializes jax.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``); multi-device logic is tested
on ``--xla_force_host_platform_device_count`` virtual devices (SURVEY §4).
Tests marked ``gpu`` take the ``gpu`` fixture, which skips them unless JAX's
default backend is a GPU; ``chip_smoke.py`` runs them on the card.
"""
from __future__ import annotations

import os

# XLA_FLAGS is read at backend *initialization* (lazy), so setting it here —
# before any jax op runs — still works.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Keep the persistent XLA compilation cache OFF in tests: test_cli drives the
# real CLI, which calls utils.cache.enable_compilation_cache(), and XLA:CPU
# cache entries are AOT executables whose recorded machine features can
# mismatch the loading host ("could lead to execution errors such as SIGILL",
# cpu_aot_loader), which intermittently SIGABRTs the suite.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    A long-lived CPU test process accumulates ~1000 XLA:CPU executables over
    the suite; past ~85% of the run, fresh compiles started segfaulting
    inside backend_compile_and_load (observed on three different late-suite
    tests, each of which passes standalone).  Dropping the jit caches at
    module boundaries keeps the per-process executable population bounded;
    within-module reuse is unaffected."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run time,
    never at import: every pytest-xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run through chip_smoke.py")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def jax_cpu():
    import jax

    assert jax.devices()[0].platform == "cpu"
    return jax


@pytest.fixture(scope="session")
def scenes():
    """Lazily-loaded preset scene cache shared across the session."""
    import cg_raytracer as cgrt

    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = cgrt.load_scene(name)
        return cache[name]

    return get


@pytest.fixture(scope="session")
def default_camera():
    import cg_raytracer as cgrt

    return cgrt.Camera.default()


def assert_images_close(a, b, max_bad_fraction=0.005, atol=1e-4, msg=""):
    """Backend-agreement helper: images equal except for a tiny fraction of
    tie-break pixels (coincident-t hits on shared edges can resolve to different
    primitives between backends)."""
    a = np.asarray(a)
    b = np.asarray(b)
    bad = np.abs(a - b).max(axis=-1) > atol
    frac = bad.mean()
    assert frac <= max_bad_fraction, (
        f"{msg}: {bad.sum()} pixels ({frac:.2%}) differ by more than {atol}"
    )
