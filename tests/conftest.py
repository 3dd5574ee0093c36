"""Test configuration: force CPU with 8 virtual devices.

The 8-device CPU mesh stands in for the reference's ``mpirun -np 8``
smoke run (reference test.sh:9) — multi-device sharding tests run on it
exactly as they would on eight accelerators.  The platform is set
through jax.config after import, so it holds whatever the environment
says.  The compile cache follows the package rule (mfem_ad_tpu/__init__):
JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import mfem_ad_tpu  # noqa: E402,F401  (enables x64, sets the compile cache)
