"""Test configuration: run the suite on a virtual 8-device CPU mesh with
float64 enabled (the parity path). The GPU path is exercised by
chip_smoke.py (tests/test_chip_smoke.py runs it where a GPU exists)."""

import os

# Must be set before jax is imported anywhere: the suite is the CPU f64
# parity path, and this process never opens an accelerator.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (multi-process launchers)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips (with a reason) without "
                   "one")
