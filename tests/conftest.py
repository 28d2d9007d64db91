"""Test configuration: CPU backend with 8 virtual devices (to exercise the
multi-device sharding paths without accelerators) and float64 enabled
(parity mode — the reference is all double precision).

Tests that need a GPU take the ``gpu`` fixture, which skips them on any
other backend; ``python chip_smoke.py`` runs the same checks on the card."""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise.  The
    check runs here, never at import, so every xdist worker collects the
    same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform}")
    return dev
