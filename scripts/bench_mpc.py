"""Measure batched contact-MPC solves/s (H=50 iLQR, ball-push task)."""

import json
import os
import sys
import time

import numpy as np

# the repo root is inserted here so the script runs from any directory
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()


def main():
    import jax
    import jax.numpy as jnp

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from moby_tpu.core import scene as sc
    from moby_tpu.math import quaternion as quat
    from moby_tpu.mpc import contact_mpc

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
               pos=np.array([0.0, 0.0, 0.5]))
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [0.5])
    pq = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))
    b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
    b.set_contact_params("ground", "ball", sc.ContactParams(epsilon=0.0, mu_coulomb=0.0, nk=4))
    scene, st = b.compile()

    H = 50
    B = int(sys.argv[sys.argv.index("-B") + 1]) if "-B" in sys.argv else 32
    n_iters = 4
    prob = contact_mpc.MPCProblem(scene=scene, template=st, dt=0.02, horizon=H)
    target = jnp.array([0.5, 0.0])

    def cost(x, u):
        return 1e-4 * jnp.sum(u[:6] ** 2)

    def cost_final(x):
        return 50.0 * jnp.sum((x[0:2] - target) ** 2)

    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st
    )
    key = jax.random.PRNGKey(0)
    dx = jax.random.uniform(key, (B,), dtype=batched.pos.dtype) * 0.2 - 0.1
    batched = batched.replace(pos=batched.pos.at[:, 0, 0].add(dx))

    # small batches are latency-bound -> parallel alpha fan-out; large
    # batches are throughput-bound and the fan-out multiplies the working set
    pls = B < 128
    if "--pls" in sys.argv:
        pls = True
    if "--no-pls" in sys.argv:
        pls = False

    if "--batched" in sys.argv:
        # batch-level iLQR with the early-exit line search
        @jax.jit
        def sweep(states):
            return contact_mpc.solve_batch(
                prob, states, cost, cost_final, n_iters=n_iters
            ).cost
    else:
        @jax.jit
        def sweep(states):
            return jax.vmap(
                lambda s: contact_mpc.solve(
                    prob, s, cost, cost_final, n_iters=n_iters,
                    parallel_line_search=pls,
                ).cost
            )(states)

    t0 = time.time()
    out = sweep(batched)
    jax.block_until_ready(out)
    print(f"compile+first run: {time.time()-t0:.1f}s")

    t0 = time.time()
    reps = 3
    for _ in range(reps):
        out = sweep(batched)
    jax.block_until_ready(out)
    dt_run = time.time() - t0
    solves_per_s = B * reps / dt_run
    print(json.dumps({
        "metric": "contact_mpc_solves_per_s_H50",
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "B": B,
        "iters": n_iters,
    }))


if __name__ == "__main__":
    main()
