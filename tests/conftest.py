"""Test harness: run everything on an 8-device virtual CPU mesh.

The JAX analog of the reference's `local[*]` single-JVM "cluster"
(driver.scala:14): `--xla_force_host_platform_device_count=8` gives 8 fake
CPU devices in one process, exercising the exact same pjit/shard_map
collective code paths as a multi-GPU host (SURVEY §4).

Must run before jax initializes its backend, hence env mutation at import
time of conftest (pytest imports conftest before test modules).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# If jax was imported before this file ran (a plugin, a site hook), the
# environment variable is read too late; the config option always wins.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (multi-process launch etc.)")
