"""Per-component wall timing of the ur10 contact-MPC sweep on the GPU:
one warm-started recording rollout, one backward (replay) pass, and one
controller (line-search) rollout — isolates which phase carries the
dispatch-bound wall time. Run from the repo root."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import jax
import jax.numpy as jnp

from bench_ur10_modes import build
from moby_tpu.mpc import contact_mpc, ilqr


def main():
    B = int(os.environ.get("MOBY_BENCH_UR10_B", "256"))
    prob, batched, cost, cost_final, us0 = build(B)
    scene = prob.scene
    f, f_rec, f_rep = contact_mpc.make_dynamics_rr(
        scene, prob.template, prob.dt)
    x0s = jax.vmap(lambda s: contact_mpc.pack(scene, s))(batched)
    H, nu = prob.horizon, contact_mpc.n_controls(scene)
    us = jnp.broadcast_to(us0[None], (B, H, nu))
    fB_rec = jax.vmap(f_rec)

    aux0 = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), f_rec.aux_init())

    @jax.jit
    def rollout(x0s_, uss):
        def step(carry, u):
            x, aux = carry
            x2, z, aux2 = fB_rec(x, u, aux)
            return (x2, aux2), (x2, z)

        _, (xs, zs) = jax.lax.scan(
            step, (x0s_, aux0), jnp.swapaxes(uss, 0, 1))
        return (
            jnp.concatenate([x0s_[:, None], jnp.swapaxes(xs, 0, 1)], 1),
            jnp.swapaxes(zs, 0, 1),
        )

    nx = x0s.shape[1]
    fxu = jax.vmap(jax.jacrev(f_rep, argnums=(0, 1)))

    @jax.jit
    def backward_lin_only(xss, uss, zss):
        """Just the per-step Jacobians through the replay path (the
        backward pass's dominant work)."""
        def bstep(carry, inp):
            x_k, u_k, z_k = inp
            A_k, B_k = fxu(x_k, u_k, z_k)
            return carry, (A_k.sum(), B_k.sum())

        _, outs = jax.lax.scan(
            bstep, jnp.zeros(()),
            (jnp.swapaxes(xss[:, :-1], 0, 1), jnp.swapaxes(uss, 0, 1),
             jnp.swapaxes(zss, 0, 1)),
            reverse=True,
        )
        return outs

    def timeit(fn, *args, reps=2):
        out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.time() - t0) / reps

    t_roll = timeit(rollout, x0s, us)
    xss, zss = rollout(x0s, us)
    t_bwd = timeit(backward_lin_only, xss, us, zss)
    print(f"B={B} H={H}: rollout(record,warm) {t_roll*1e3:.0f} ms | "
          f"backward-linearize(replay) {t_bwd*1e3:.0f} ms", flush=True)
    print(f"a 4-iter solve ~= (1 + ~#alphas*4) rollouts + 4 backwards; "
          f"measured sweep wall fills the rest", flush=True)


if __name__ == "__main__":
    main()
