"""Test configuration: force CPU with 8 virtual devices and float64.

Mirrors the reference's float64 numerics for golden comparisons and
provides the simulated multi-device mesh the reference never had
(SURVEY.md section 4).  The platform is set through jax.config as
well as the environment, so it holds however jax was first imported.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"          # for any subprocesses
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", (
    "tests must run on local CPU devices, got %r" % jax.devices()
)
