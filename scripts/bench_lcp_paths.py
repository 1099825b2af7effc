"""Microbenchmark: batched impact-LCP solve paths on the attached device.

Builds the friction sphere-stack scene, extracts the per-scenario QP KKT-LCP
(MM, qq, mask) exactly as `impact.resolve_impacts` assembles it, and times
the candidate batched solvers on those problems.

Usage: python scripts/bench_lcp_paths.py [-B 512] [--cpu]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_scene(mu=0.5, eps=0.3, nk=16):
    import jax.numpy as jnp
    from moby_tpu.core import scene as sc
    from moby_tpu.math import quaternion as quat

    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    inertia = sc.sphere_inertia(1.0, 1.0)
    b.add_body("sph1", mass=1.0, inertia=inertia, pos=np.array([0, 0, 1.0]))
    b.add_body("sph2", mass=1.0, inertia=inertia, pos=np.array([0, 0, 3.0]))
    b.add_body("sph3", mass=1.0, inertia=inertia, pos=np.array([0, 0, 5.0]))
    b.add_body("ground", enabled=False)
    for n in ("sph1", "sph2", "sph3"):
        b.add_geom(n, sc.SPHERE, [1.0])
    pq = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))
    b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
    cp = sc.ContactParams(epsilon=eps, mu_coulomb=mu, nk=nk)
    b.set_contact_params("ground", "sph1", cp)
    b.set_contact_params("sph1", "sph2", cp)
    b.set_contact_params("sph2", "sph3", cp)
    return b.compile()


def main():
    import jax
    import jax.numpy as jnp

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    B = int(sys.argv[sys.argv.index("-B") + 1]) if "-B" in sys.argv else 512

    from moby_tpu import config as cfg
    from moby_tpu.geometry import narrowphase as nph
    from moby_tpu.sim import impact, kinematics, stepper
    from moby_tpu.solvers import lcp

    cfg.use_compile_cache()

    scene, st = build_scene()
    print(f"scene: K={scene.n_contacts} NV={scene.n_vars} NI={scene.n_ineq} "
          f"n_lcp={scene.n_vars + scene.n_ineq}", flush=True)

    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st
    )
    key = jax.random.PRNGKey(0)
    dz = jax.random.uniform(key, (B, scene.nb), dtype=batched.pos.dtype) * 0.01
    batched = batched.replace(pos=batched.pos.at[:, :, 2].add(dz))

    # roll a few steps so spheres touch down (impacting state)
    @jax.jit
    def roll(states):
        def f(s, _):
            return jax.vmap(lambda x: stepper.step(scene, x, 0.01))(s), None
        out, _ = jax.lax.scan(f, states, None, length=12)
        return out

    states = roll(batched)
    jax.block_until_ready(states)

    @jax.jit
    def get_problem(s):
        # reproduce the pre-impact state of a step: push every sphere into
        # shallow penetration (stabilization parks them 2*NEAR_ZERO apart)
        # and apply the gravity velocity kick of do_mini_step
        g = jnp.asarray(scene.gravity, s.vel.dtype)
        shift = 1.5e-3 * jnp.arange(1, scene.nb + 1, dtype=s.pos.dtype)
        shift = jnp.where(scene.enabled, shift, 0.0)
        s = s.replace(
            pos=s.pos.at[:, 2].add(-shift),
            vel=s.vel + 0.01 * g[None, :] * scene.enabled[:, None],
        )
        pt = kinematics.compute(scene, s)
        _, con = nph.narrow_phase(scene, pt.pos, pt.quat, scene.contact_dist_thresh)
        nz = cfg.near_zero(s.pos.dtype)
        act, act_lim, _, _ = impact._active(scene, s, pt, con, nz)
        p = impact.assemble_problem(scene, s, pt, con, act, act_lim)
        MM, qq, mask = impact.build_qp_lcp(scene, p, act, act_lim)
        return MM, qq, mask

    MM, qq, mask = jax.vmap(get_problem)(states)
    jax.block_until_ready(MM)
    n_act = np.asarray(jnp.sum(mask, axis=1))
    print(f"B={B} n={qq.shape[1]} active rows: min={n_act.min()} "
          f"mean={n_act.mean():.1f} max={n_act.max()}", flush=True)

    z0 = jnp.zeros_like(qq)
    skip = jnp.zeros(B, bool)

    def timeit(name, fn, *args, reps=5):
        out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.time() - t0) / reps
        z = out[0]
        w = jnp.einsum("bij,bj->bi", MM, z) + qq
        resid = jnp.max(
            jnp.abs(jnp.where(mask, jnp.minimum(z, w), 0.0))
        )
        okf = np.asarray(jnp.mean(out[1].astype(jnp.float32)))
        print(f"{name:28s} {dt*1e3:9.2f} ms  ok={okf:.3f} "
              f"resid={float(resid):.2e}", flush=True)
        return dt

    # the production cascade (bpp -> fast_reg -> lemke_reg)
    prod = jax.jit(jax.vmap(
        lambda M, q, m, z, s: lcp.solve_lcp(M, q, m, z0=z, skip=s)
    ))
    timeit("vmap solve_lcp", prod, MM, qq, mask, z0, skip)

    # BPP only (GJ sub-solves on f32)
    bpp = jax.jit(jax.vmap(lambda M, q, m, z, s: lcp.lcp_bpp(M, q, m, z0=z, skip=s)))
    timeit("vmap lcp_bpp", bpp, MM, qq, mask, z0, skip)

    # GJ-vs-LAPACK sub-solve ablation on the BPP path
    lcp._GJ_OVERRIDE = False
    bpp_lap = jax.jit(jax.vmap(
        lambda M, q, m, z, s: lcp.lcp_bpp(M, q, m, z0=z, skip=s)
    ))
    timeit("vmap lcp_bpp LAPACK", bpp_lap, MM, qq, mask, z0, skip)
    lcp._GJ_OVERRIDE = None


if __name__ == "__main__":
    main()
