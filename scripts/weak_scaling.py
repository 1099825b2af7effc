"""Weak-scaling measurement on a virtual device mesh (BASELINE scaling row).

Real multi-chip hardware is unavailable in this environment; this measures
the *shape* of scaling — per-shard overhead of the sharded rollout and the
sharded contact-MPC sweep at fixed per-shard batch — on N virtual CPU
devices. Wall-clock on virtual CPU devices is NOT chip performance, but
collective/partitioning overhead per shard is visible: ideal weak scaling
keeps time flat as shards grow with total batch.

Run:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/weak_scaling.py

Writes a markdown table to stdout.
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import jax

# force the virtual CPU mesh explicitly, whatever accelerator plugin is
# installed (same mechanism as tests/conftest.py)
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()

from moby_tpu.core import scene as sc          # noqa: E402
from moby_tpu.math import quaternion as quat   # noqa: E402
from moby_tpu.mpc import contact_mpc           # noqa: E402
from moby_tpu.parallel import mesh as pmesh    # noqa: E402


def ball_scene():
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body("ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
               pos=np.array([0.0, 0.0, 0.5]))
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [0.5])
    pq = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))
    b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
    b.set_contact_params(
        "ground", "ball",
        sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4),
    )
    return b.compile()


def bench_rollout(scene, st, mesh_n, per_shard_b, n_steps=50, reps=3):
    mesh = pmesh.scenario_mesh(mesh_n)
    B = mesh_n * per_shard_b
    batched = pmesh.broadcast_state(st, B)
    dz = jnp.linspace(0.0, 0.1, B)
    batched = batched.replace(pos=batched.pos.at[:, 0, 2].add(dz))
    batched = pmesh.shard_batch(mesh, batched)
    out = pmesh.sharded_rollout(scene, mesh, batched, 0.01, n_steps)
    jax.block_until_ready(out.pos)
    t0 = time.time()
    for _ in range(reps):
        out = pmesh.sharded_rollout(scene, mesh, out, 0.01, n_steps)
    jax.block_until_ready(out.pos)
    dt = (time.time() - t0) / reps
    return B * n_steps / dt, dt


def bench_mpc(scene, st, mesh_n, per_shard_b, H=20, n_iters=3, reps=3):
    mesh = pmesh.scenario_mesh(mesh_n)
    B = mesh_n * per_shard_b
    batched = pmesh.broadcast_state(st, B)
    dx = jnp.linspace(-0.1, 0.1, B)
    batched = batched.replace(pos=batched.pos.at[:, 0, 0].add(dx))
    batched = pmesh.shard_batch(mesh, batched)
    prob = contact_mpc.MPCProblem(scene=scene, template=st, dt=0.02,
                                  horizon=H)
    target = jnp.asarray([0.5, 0.0], st.pos.dtype)

    def cost(x, u):
        return 1e-4 * jnp.sum(u[:6] ** 2)

    def cost_final(x):
        return 50.0 * jnp.sum((x[0:2] - target) ** 2)

    res = pmesh.sharded_mpc_sweep(prob, batched, cost, cost_final, mesh,
                                  n_iters=n_iters)
    jax.block_until_ready(res.cost)
    t0 = time.time()
    for _ in range(reps):
        res = pmesh.sharded_mpc_sweep(prob, batched, cost, cost_final, mesh,
                                      n_iters=n_iters)
    jax.block_until_ready(res.cost)
    dt = (time.time() - t0) / reps
    return B / dt, dt


def main():
    scene, st = ball_scene()
    shards = [1, 2, 4, 8]
    n_dev = len(jax.devices())
    shards = [s for s in shards if s <= n_dev]

    # per-shard MPC batch 64 (8 solves/shard made the MPC column
    # startup-noise dominated); per-shard work is now
    # large enough that the time deltas measure partitioning/collective
    # overhead, not dispatch jitter
    PS_STEP, PS_MPC = 32, 64

    print(f"devices: {n_dev} ({jax.devices()[0].platform})")
    print()
    print("| shards | total B (steps) | steps/s | step time (s) | "
          "total B (MPC) | solves/s | MPC time/shard-solve (ms) | "
          "efficiency |")
    print("|---|---|---|---|---|---|---|---|")
    base_step = base_mpc = None
    for s in shards:
        sps, t_step = bench_rollout(scene, st, s, per_shard_b=PS_STEP)
        mps, t_mpc = bench_mpc(scene, st, s, per_shard_b=PS_MPC)
        if base_step is None:
            base_step, base_mpc = t_step, t_mpc
        eff = 0.5 * (base_step / t_step + base_mpc / t_mpc)
        print(f"| {s} | {PS_STEP*s} | {sps:.0f} | {t_step:.3f} | "
              f"{PS_MPC*s} | {mps:.1f} | {1e3*t_mpc/PS_MPC:.1f} | "
              f"{eff:.2f} |")
    print()
    print(
        "Multi-device throughput ≈ single-device solves/s (bench.py on the "
        "card) × n_devices × efficiency(n_shards) from this table: the "
        "virtual-mesh efficiency column isolates partitioning/collective "
        "overhead."
    )


if __name__ == "__main__":
    main()
