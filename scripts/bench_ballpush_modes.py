"""A/B of the ball-push contact-MPC sweep (the BASELINE north-star metric)
across backward-pass modes on the attached GPU.

Run from the repo root: python scripts/bench_ballpush_modes.py [modes...]
modes: plain rr rr_hoist hoist (default: plain rr)
Env: MOBY_BENCH_MPC_B (default 1024).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()

import numpy as np
import jax
import jax.numpy as jnp

from moby_tpu.core import scene as sc
from moby_tpu.math import quaternion as quat
from moby_tpu.mpc import contact_mpc


def build(B):
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
               pos=np.array([0.0, 0.0, 0.5]))
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [0.5])
    pq = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))
    b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
    b.set_contact_params(
        "ground", "ball", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5,
                                           nk=4))
    scene, st = b.compile()
    prob = contact_mpc.MPCProblem(scene=scene, template=st, dt=0.02,
                                  horizon=50)
    target = jnp.array([0.5, 0.0], st.pos.dtype)

    def cost(x, u):
        return 1e-4 * jnp.sum(u[:6] ** 2)

    def cost_final(x):
        return 50.0 * jnp.sum((x[0:2] - target) ** 2)

    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    key = jax.random.PRNGKey(0)
    dx = jax.random.uniform(key, (B,), dtype=batched.pos.dtype) * 0.2 - 0.1
    batched = batched.replace(pos=batched.pos.at[:, 0, 0].add(dx))
    return prob, batched, cost, cost_final


def main():
    modes = sys.argv[1:] or ["plain", "rr"]
    B = int(os.environ.get("MOBY_BENCH_MPC_B", "1024"))
    prob, batched, cost, cost_final = build(B)
    kws = {
        "plain": dict(record_replay=False),
        "rr": dict(record_replay=True, linearize_fwd=False),
        "rr_fwd": dict(record_replay=True, linearize_fwd=True),
        "rr_hoist": dict(record_replay=True, hoist_linearization=True,
                         linearize_fwd=False),
        "rr_fwd_hoist": dict(record_replay=True, hoist_linearization=True,
                             linearize_fwd=True),
        "hoist": dict(record_replay=False, hoist_linearization=True),
    }
    costs = {}
    for m in modes:
        @jax.jit
        def sweep(states, kw=kws[m]):
            return contact_mpc.solve_batch(
                prob, states, cost, cost_final, n_iters=4, **kw).cost

        t0 = time.time()
        out = sweep(batched)
        jax.block_until_ready(out)
        tc = time.time() - t0
        costs[m] = np.asarray(out)
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            out = sweep(batched)
        jax.block_until_ready(out)
        dt = time.time() - t0
        print(f"{m}: {B * reps / dt:.1f} solves/s  (B={B}, compile+1st "
              f"{tc:.1f}s, mean cost {costs[m].mean():.6f})", flush=True)
    names = list(costs)
    for m in names[1:]:
        d = np.max(np.abs(costs[m] - costs[names[0]]))
        print(f"cost parity {names[0]} vs {m}: max|d| = {d:.3e}", flush=True)


if __name__ == "__main__":
    main()
