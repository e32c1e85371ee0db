"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Multi-device sharding paths are validated on the CPU backend with
XLA-simulated devices (SURVEY.md §4 item e), so the suite runs the same
on a machine with a GPU; the GPU itself is exercised by chip_smoke.py.
The platform is forced both through the environment (for any
subprocess) and through jax.config, in case jax was imported first.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses

import jax

jax.config.update("jax_platforms", "cpu")
