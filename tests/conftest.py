"""Test configuration: 8 virtual CPU devices + float64.

Tests run on the CPU by default, on a virtual 8-device mesh so the
distributed (shard_map) path is testable without several cards (the
pattern SURVEY.md §4 prescribes). An existing ``JAX_PLATFORMS`` is
honoured, so ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs
the ``gpu``-marked tests on a card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu():
    """Skip the test unless JAX's default device is a GPU (decided here,
    at run time, never while the module is imported)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables + traced jaxprs after every test module.

    The suite compiles hundreds of large programs in ONE process; letting
    them accumulate eventually crashes XLA's CPU compiler late in the run
    (observed as a segfault inside backend_compile around the 85% mark).
    Within a module caches persist, so compile-count/stability tests are
    unaffected."""
    yield
    jax.clear_caches()
