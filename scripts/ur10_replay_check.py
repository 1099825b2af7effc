"""Control-replay oracle for the ur10 contact-MPC sweep: the strongest
cost-parity check.

Phase A (this process, attached GPU): run the production sweep, save the
optimized control sequences + reported costs of the first N members.
Phase B (spawned CPU f64 child): rebuild the scene in double precision and
ROLL OUT those exact controls through the strict dynamics (full production
LCP cascade, LAPACK sub-solves, no MPC shortcuts), recomputing each
member's cost. If the GPU-reported cost is genuinely achieved physics (not
an artifact of over-regularized contact), the f64-replayed cost of the SAME
controls matches it closely — this catches soft-contact inflation that a
solve-vs-solve comparison (both local optima) cannot.

Run from the repo root: python scripts/ur10_replay_check.py
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np

NPZ = "/tmp/ur10_replay_check.npz"
CHILD = os.environ.get("MOBY_REPLAY_CHILD") == "1"


def phase_a():
    import jax
    import jax.numpy as jnp
    from bench_ur10_modes import build
    from moby_tpu.mpc import contact_mpc

    B = int(os.environ.get("MOBY_BENCH_UR10_B", "256"))
    N = int(os.environ.get("MOBY_UR10_ORACLE_N", "8"))
    prob, batched, cost, cost_final, us0 = build(B)

    @jax.jit
    def sweep(states):
        return contact_mpc.solve_batch(
            prob, states, cost, cost_final, us0=us0, n_iters=4,
            mu_init=float(os.environ.get("MOBY_BENCH_UR10_MU0", "0.1")))

    res = sweep(batched)
    jax.block_until_ready(res.cost)
    np.savez(NPZ,
             us=np.asarray(res.us[:N], np.float64),
             cost=np.asarray(res.cost[:N], np.float64))
    print("GPU costs:", " ".join(f"{c:.4f}" for c in np.asarray(res.cost[:N])),
          flush=True)

    env = dict(os.environ)
    env["MOBY_REPLAY_CHILD"] = "1"
    out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, text=True,
                         timeout=3000)
    print(out.stdout)
    if out.returncode != 0:
        print(out.stderr[-2000:])
        sys.exit(1)


def phase_b():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    from bench_ur10_modes import build
    from moby_tpu.mpc import contact_mpc

    data = np.load(NPZ)
    us = jnp.asarray(data["us"])          # (N, H, nu) f64
    dev_cost = data["cost"]
    N = us.shape[0]
    B = int(os.environ.get("MOBY_BENCH_UR10_B", "256"))
    prob, batched, cost, cost_final, _ = build(B)
    sub = jax.tree_util.tree_map(lambda a: a[:N], batched)
    scene = prob.scene
    f = contact_mpc.make_dynamics(scene, prob.template, prob.dt)
    x0s = jax.vmap(lambda s: contact_mpc.pack(scene, s))(sub)

    @jax.jit
    def rollout_cost(x0, u_seq):
        def step(x, u):
            x2 = f(x, u)
            return x2, cost(x, u)
        xH, cs = jax.lax.scan(step, x0, u_seq)
        return jnp.sum(cs) + cost_final(xH)

    replayed = np.asarray(jax.vmap(rollout_cost)(x0s, us))
    print("f64-replayed costs:",
          " ".join(f"{c:.4f}" for c in replayed))
    rel = np.abs(replayed - dev_cost) / np.maximum(np.abs(replayed), 1e-9)
    print("relative gap per member:",
          " ".join(f"{r:.4f}" for r in rel))
    print(json.dumps({
        "dev_mean": float(dev_cost.mean()),
        "replayed_mean": float(replayed.mean()),
        "max_rel_gap": float(rel.max()),
    }))


if __name__ == "__main__":
    phase_b() if CHILD else phase_a()
