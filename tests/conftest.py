"""Test configuration: force the CPU backend with 8 virtual devices so the
multi-device sharding paths compile and run without a GPU. Tests that need
the card carry the `gpu` marker and skip (from the `gpu` fixture) here."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
import pytest  # noqa: E402

REFERENCE = "/root/reference"


def pytest_configure(config):
    """The CPU backend, whatever JAX_PLATFORMS the shell carries, unless the
    run selects only the card's tests (`-m gpu`): those keep the backend the
    environment names. Runs before any test module imports JAX."""
    if config.getoption("markexpr", "").strip() != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"


@pytest.fixture(scope="session")
def refdir():
    return REFERENCE


@pytest.fixture
def gpu():
    """The GPU devices; skips the test where JAX finds none. Decided when the
    test runs, never while the module is imported."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda python -m pytest -m gpu)")
    return devs
