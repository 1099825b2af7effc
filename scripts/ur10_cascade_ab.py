"""A/B the ur10 recording-rollout wall time across MPC LCP-cascade configs
on the attached GPU. The recording rollout is the dominant component of the
ur10 sweep (r5 measurement: 1560 ms of a ~3 s sweep at B=256 proxy), so
isolating which cascade stage carries it directs the fix for the
lock-step-failure batch scaling (VERDICT r5 item #1).

Run from the repo root: python scripts/ur10_cascade_ab.py [B ...]
Env: MOBY_BENCH_UR10_GEOM=proxy|real (default real, the BENCH geometry)
"""

import os
import sys
import time

os.environ.setdefault("MOBY_BENCH_UR10_GEOM", "real")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()

import jax
import jax.numpy as jnp

CONFIGS = [
    ("ladder(dflt)", {}),
    ("ladder-noswp", {"MOBY_MPC_RESCUE": "0"}),
    ("no-ladder", {"MOBY_MPC_LADDER": ""}),
    ("ladder10-1e2", {"MOBY_MPC_LADDER": "10,100"}),
    ("ladder1e2", {"MOBY_MPC_LADDER": "100"}),
    ("stage12-only", {"MOBY_MPC_RESCUE": "0", "MOBY_MPC_LADDER": ""}),
]


def main():
    Bs = [int(a) for a in sys.argv[1:]] or [256]
    from bench import _ur10_setup
    from moby_tpu.mpc import contact_mpc

    for B in Bs:
        prob, batched, cost, cost_final, us0 = _ur10_setup(B)
        scene = prob.scene
        f, f_rec, f_rep = contact_mpc.make_dynamics_rr(
            scene, prob.template, prob.dt)
        x0s = jax.vmap(lambda s: contact_mpc.pack(scene, s))(batched)
        H, nu = prob.horizon, contact_mpc.n_controls(scene)
        us = jnp.broadcast_to(us0[None], (B, H, nu))

        for name, env in CONFIGS:
            old = {}
            for k, v in env.items():
                old[k] = os.environ.get(k)
                os.environ[k] = v
            jax.clear_caches()
            fB_rec = jax.vmap(f_rec)
            aux0 = jax.tree_util.tree_map(
                lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                f_rec.aux_init())

            @jax.jit
            def rollout(x0s_, uss):
                def step(carry, u):
                    x, aux = carry
                    x2, z, aux2 = fB_rec(x, u, aux)
                    return (x2, aux2), (x2, z)

                _, (xs, zs) = jax.lax.scan(
                    step, (x0s_, aux0), jnp.swapaxes(uss, 0, 1))
                return xs, zs

            xs, zs = rollout(x0s, us)
            jax.block_until_ready(xs)
            n_nan = int(jnp.sum(~jnp.isfinite(xs[-1]).all(axis=-1)))
            t0 = time.time()
            reps = 3
            for _ in range(reps):
                out = rollout(x0s, us)
            jax.block_until_ready(out)
            ms = (time.time() - t0) / reps * 1e3
            print(f"B={B:5d} {name:12s} rollout {ms:7.1f} ms"
                  f"  nan-members@H {n_nan}/{B}", flush=True)
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


if __name__ == "__main__":
    main()
