"""Test harness config: JAX on the CPU with 8 virtual devices, unless
``JAX_PLATFORMS`` names another platform.

Multi-device hardware is not where the suite runs; sharding tests exercise a
`jax.sharding.Mesh` over 8 virtual CPU devices (the device count has to be in
XLA_FLAGS before the backend starts).

Tests marked ``gpu`` run code that exists only compiled for the card (Pallas
kernels through Triton, without the interpreter). They take the
``gpu_device`` fixture, which skips them when JAX's first device is not a
GPU. On a machine with one: ``JAX_PLATFORMS=cuda python -m pytest tests -m
gpu`` (``chip_smoke.py`` runs them inside its own process).
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu_device():
    """JAX's first device when it is a GPU; skips the test otherwise."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {device.platform}")
    return device
