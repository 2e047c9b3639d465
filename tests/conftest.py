"""Test configuration: force CPU with 8 virtual devices.

Multi-device hardware is not available in CI; sharding correctness is tested
on a virtual 8-device CPU mesh (SURVEY.md §4 "Distributed testing": the
reference's P=1 vs P=4 mpirun equivalence becomes a 1-device vs 8-device
shard_map equivalence here).  XLA_FLAGS is honoured because the CPU backend
has not been instantiated yet at conftest import time.  An explicit
``JAX_PLATFORMS`` is kept, so ``JAX_PLATFORMS=cuda pytest -m gpu`` runs the
tests that need the card on it.

Tests compile from cold: the persistent compilation cache that the CLI
turns on (prosper_tpu.utils.enable_compile_cache) is disabled here, so no
test writes compiled programs into the checkout.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_compilation_cache", False)
