"""Test configuration: run the suite on a CPU backend in float64.

The regression oracle (reference golden trajectories in `regress/*.dat`) was
generated in double precision; CPU x64 is the right place to check bit-close
parity. Multi-device sharding tests use 8 virtual CPU devices.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

# Force the CPU backend for deterministic f64 testing, whatever accelerator
# plugin the environment registers.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
