"""Test configuration: the CPU backend with 8 virtual devices, so the
sharding and halo tests run without accelerators (SURVEY.md §4).

``JAX_PLATFORMS``, where set, chooses the platforms instead (e.g.
``JAX_PLATFORMS=cuda,cpu`` to run the ``gpu``-marked tests on a card);
the 8 CPU devices are there either way. Set through ``jax.config`` so
that it holds however JAX was imported before this file.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture()
def gpu():
    """JAX's first device, when it is a GPU; skips the test otherwise.
    Decided here, when the test runs, never while modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev
