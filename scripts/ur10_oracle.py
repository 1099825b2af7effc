"""CPU f64 oracle for the ur10 contact-MPC sweep.

Runs the identical workload as scripts/bench_ur10_modes.py (same build(),
same member perturbations) on the CPU double-precision path — LAPACK
sub-solves, full production cascade — for the first ORACLE_N members, and
prints their converged costs. Compare against the GPU sweep's costs for the
same members (bench_ur10_modes prints its mean and first members under
MOBY_UR10_PRINT_MEMBERS=1).

Every arm throughput number ships with this oracle cost check.

Env: MOBY_BENCH_UR10_GEOM (proxy|real), MOBY_BENCH_UR10_B (build batch,
default 256 — member perturbations depend on it), MOBY_UR10_ORACLE_N
(members to solve, default 16).
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()

import numpy as np
import jax.numpy as jnp


def main():
    from bench_ur10_modes import build
    from moby_tpu.mpc import contact_mpc

    B = int(os.environ.get("MOBY_BENCH_UR10_B", "256"))
    n = int(os.environ.get("MOBY_UR10_ORACLE_N", "16"))
    prob, batched, cost, cost_final, us0 = build(B)
    sub = jax.tree_util.tree_map(lambda a: a[:n], batched)

    @jax.jit
    def sweep(states):
        return contact_mpc.solve_batch(
            prob, states, cost, cost_final, us0=us0, n_iters=4,
            mu_init=float(os.environ.get("MOBY_BENCH_UR10_MU0", "0.1")),
            record_replay=True).cost

    out = np.asarray(sweep(sub))
    print("oracle (CPU f64) member costs:",
          " ".join(f"{c:.4f}" for c in out))
    print(f"oracle mean over {n}: {out.mean():.4f}")


if __name__ == "__main__":
    main()
