"""Test environment: CPU backend with 8 virtual devices unless told otherwise.

Must run before jax is imported anywhere — pytest imports conftest first.
Multi-device tests (tests/test_sharding.py) use the 8 virtual CPU devices
as a stand-in for a multi-GPU host, per the standard
``xla_force_host_platform_device_count`` recipe.  An explicit
``JAX_PLATFORMS`` is respected, so the ``gpu``-marked checks can run on a
card (README, "Testing"); without one the suite runs on the CPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)


@pytest.fixture
def gpu():
    """Skip the requesting test unless JAX's default backend is a GPU.

    Decided here, when the test runs — never at import or collection, so
    every test worker collects the same tests."""
    backend = jax.default_backend()
    if backend != "gpu":
        pytest.skip(f"needs a GPU; JAX's default backend is {backend!r}")
    return jax.devices()[0]


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """The CLI enables the persistent compilation cache at start-up; tests
    that drive the CLI must not write one into the checkout."""
    monkeypatch.setattr("softgnss_tpu.cli.enable_compile_cache", lambda: None)
