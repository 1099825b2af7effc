"""Global numeric configuration.

The simulation core is dtype-polymorphic: every kernel preserves the dtype of
its inputs. Scene/state builders consult :func:`default_dtype`.

On CPU (regression testing vs. the reference's golden trajectories, which were
produced in double precision) we run float64; on the GPU we run float32, which
is what the benchmarks use. `NEAR_ZERO` mirrors the reference's constant
(`include/Moby/Constants.h:21`, sqrt(machine eps)) and is resolved per-dtype.

Importing this module (which `import moby_tpu` does) pins f32 matrix products
to full f32 precision: on a GPU they would otherwise run in TF32, which keeps
about three decimal digits, while the LCP acceptance tolerance
(m·‖M‖∞·sqrt(eps_f32), `solvers/lcp.py`) assumes true f32 arithmetic.
"""

from __future__ import annotations

import os

import numpy as np
import jax

MATMUL_PRECISION = "highest"
jax.config.update("jax_default_matmul_precision", MATMUL_PRECISION)

# Reference: include/Moby/Constants.h:21  (sqrt of double-precision epsilon)
NEAR_ZERO_F64 = float(np.sqrt(np.finfo(np.float64).eps))
NEAR_ZERO_F32 = float(np.sqrt(np.finfo(np.float32).eps))

# the checkout root (the directory holding the `moby_tpu` package)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_dtype():
    """float64 when x64 is enabled (CPU regression mode), else float32."""
    return np.float64 if jax.config.jax_enable_x64 else np.float32


def near_zero(dtype) -> float:
    """Dtype-appropriate NEAR_ZERO (sqrt eps), mirroring Moby's constant."""
    if np.dtype(dtype) == np.float64:
        return NEAR_ZERO_F64
    return NEAR_ZERO_F32


def enable_x64_cpu():
    """Switch JAX to the CPU backend with float64 (regression-test mode)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    The directory is `JAX_COMPILATION_CACHE_DIR` when that is set, else a
    fixed `.jax_cache/` at the checkout root (listed in `.gitignore`). The
    path is part of the cache key, so it must not move between runs.
    Entry-point scripts call this before their first compilation.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    return path
