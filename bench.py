"""Benchmark: contact-MPC and contact-sim throughput on the attached GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}.
`device` names the card as JAX reports it (platform, device_kind, count)
and as `nvidia-smi` reports it (name, power limit). Without a GPU the run
fails: it never falls back to the CPU.

Primary metric: **batched contact-MPC solves/s at horizon H=50** (iLQR over
the IFT-differentiable contact step, ball-push task with Coulomb friction
mu=0.5).

extra: contact-sim stepping throughput (scenario-steps/s) on the friction +
restitution sphere stack (mu=0.5, eps=0.3, full collision + impact-LCP
pipeline every step), batched with vmap over MOBY_BENCH_B scenarios; the
pooled 64-sphere pile; small-batch ball-push latency.

The arm (6-DoF) cell is out of the default run until its scene file is
back in the repository; `_ur10_setup` / `bench_ur10_mpc` stay for the
scripts that call them.

Env knobs: MOBY_BENCH_B (step batch, default 512), MOBY_BENCH_MPC_B (MPC
batch, default 1536), MOBY_BENCH_SKIP_MPC / MOBY_BENCH_SKIP_STEPS /
MOBY_BENCH_SKIP_PILE / MOBY_BENCH_SKIP_LATENCY.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def gpu_identity():
    """The card as JAX and `nvidia-smi` report it; raises without a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is on platform {devs[0].platform!r}"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": smi,
    }


def _stack_scene(mu=0.5, eps=0.3, nk=16):
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


def _stack_setup(B):
    """(batched_states, rollout_chunk) for the sphere stack at batch B with
    small random drops; `rollout_chunk` steps the batch 10 times at dt=1e-3."""
    import jax
    import jax.numpy as jnp

    from moby_tpu.sim import stepper

    scene, st = _stack_scene()
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st
    )
    key = jax.random.PRNGKey(0)
    dz = jax.random.uniform(key, (B, scene.nb), dtype=batched.pos.dtype) * 0.01
    batched = batched.replace(pos=batched.pos.at[:, :, 2].add(dz))

    @jax.jit
    def rollout_chunk(states):
        def f(s, _):
            return jax.vmap(lambda x: stepper.step(scene, x, 0.001))(s), None

        out, _ = jax.lax.scan(f, states, None, length=10)
        return out

    return batched, rollout_chunk


def bench_steps():
    """Friction+restitution sphere-stack stepping throughput (steps/s)."""
    import jax

    B = int(os.environ.get("MOBY_BENCH_B", "512"))
    batched, rollout_chunk = _stack_setup(B)
    out = rollout_chunk(batched)
    jax.block_until_ready(out)

    t0 = time.time()
    n_chunks = 5
    for _ in range(n_chunks):
        out = rollout_chunk(out)
    jax.block_until_ready(out)
    dt = time.time() - t0
    return B * 10 * n_chunks / dt


def _ballpush_setup(B, H=50):
    """(prob, batched_states, cost, cost_final, us0) for the ball-push
    contact-MPC task at batch B and horizon H (the north-star workload)."""
    import jax
    import jax.numpy as jnp

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
    b.set_contact_params(
        "ground", "ball",
        sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4),
    )
    scene, st = b.compile()

    prob = contact_mpc.MPCProblem(scene=scene, template=st, dt=0.02, horizon=H)
    target = jnp.array([0.5, 0.0], st.pos.dtype)

    def cost(x, u):
        return 1e-4 * jnp.sum(u[:6] ** 2)

    def cost_final(x):
        return 50.0 * jnp.sum((x[0:2] - target) ** 2)

    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st
    )
    # offsets drawn in f32 whatever the run's dtype, so an f64 reference
    # solves exactly the members an f32 run solves
    key = jax.random.PRNGKey(0)
    dx = jax.random.uniform(key, (B,), dtype=jnp.float32) * 0.2 - 0.1
    batched = batched.replace(
        pos=batched.pos.at[:, 0, 0].add(dx.astype(batched.pos.dtype)))
    return prob, batched, cost, cost_final, None


def bench_mpc():
    """Contact-MPC solves/s at H=50 (the BASELINE metric): iLQR ball-push
    with Coulomb friction through the IFT-differentiable impact LCP."""
    import jax
    import jax.numpy as jnp

    from moby_tpu.mpc import contact_mpc

    # default batch chosen before the GPU port; not yet re-swept on the GPU
    B = int(os.environ.get("MOBY_BENCH_MPC_B", "1536"))
    n_iters = 4
    prob, batched, cost, cost_final, _ = _ballpush_setup(B)

    # batch-level iLQR: batch-voted early-exit line search (~1.5x over the
    # lock-step vmapped 8-alpha scan; identical per-member semantics)
    @jax.jit
    def sweep(states):
        return contact_mpc.solve_batch(
            prob, states, cost, cost_final, n_iters=n_iters
        ).cost

    out = sweep(batched)
    jax.block_until_ready(out)

    t0 = time.time()
    reps = 3
    for _ in range(reps):
        out = sweep(batched)
    jax.block_until_ready(out)
    dt = time.time() - t0
    return B * reps / dt, B


def _ur10_setup(B):
    """(prob, batched_states, cost, cost_final, us0) for the UR10
    contact-MPC reach task (BASELINE.json configs row 5: '6-DoF articulated
    reduced-coords dynamics with joint limits, contact-MPC reach task'):
    the reference arm (example/ur10/ur10/ur10.sdf) reaching a target AT the
    floor plane — the optimum presses into the unilateral contact, so every
    iLQR iteration differentiates through an articulated multi-slot impact
    LCP with 12 joint-limit rows.

    Geometry (MOBY_BENCH_UR10_GEOM): 'real' (default) collides the wrist_3
    link's actual Collada collision hull (meshes/collision/Wrist3.dae, read
    directly by io/collada.py) against the floor; the other links' hulls
    stay >0.4 m above the floor for the whole task and are dropped — the
    fixed-shape equivalent of the reference's broad-phase cull (checked by
    an oracle-rollout clearance assert, see scripts/ur10_cull_check.py).
    'proxy' keeps the round-3 3 cm fist box (comparability).
    """
    import xml.etree.ElementTree as ET

    import jax
    import jax.numpy as jnp

    from moby_tpu.core import scene as sc
    from moby_tpu.io import sdfio
    from moby_tpu.math import quaternion as quat
    from moby_tpu.mpc import contact_mpc
    from moby_tpu.sim import kinematics
    from moby_tpu.dynamics import aba as art_dyn

    sdf_path = "/root/reference/example/ur10/ur10/ur10.sdf"
    root = ET.parse(sdf_path).getroot()
    model = root if root.tag == "model" else root.find("model")

    geom_mode = os.environ.get("MOBY_BENCH_UR10_GEOM", "real")
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    mname, _, _ = sdfio.add_model(
        b, model, os.path.dirname(os.path.abspath(sdf_path))
    )
    wrist = f"{mname}/wrist_3_link"
    if geom_mode == "proxy":
        b.geoms = [g for g in b.geoms if g.gtype != sc.POLYHEDRON]
        b.add_geom(wrist, sc.BOX, [0.03, 0.03, 0.03])
    else:
        b.geoms = [
            g for g in b.geoms
            if g.gtype != sc.POLYHEDRON or g.body == wrist
        ]
    b.add_body("ground", enabled=False)
    import jax.numpy as _j
    pq = np.asarray(quat.from_rpy(_j.array([1.5707963267949, 0, 0])))
    b.add_geom("ground", sc.PLANE, [0.0], pos=np.array([0, 0, -0.05]),
               quat=pq)
    b.set_contact_params(
        "ground", mname,
        sc.ContactParams(
            epsilon=0.0, mu_coulomb=0.5, nk=4,
            # real-hull mode: 4-slot manifold cap (a resting manifold needs
            # 3-4 points; the 128-vert wrist hull would otherwise claim
            # VSLOT_CAP=16 slots = 6+ LCP rows each)
            max_slots=4 if geom_mode == "real" else 0,
        ),
    )
    scene, st = b.compile()

    ee_slot = scene.nb + [
        l.name for l in scene.arts[0].model.links
    ].index("wrist_3_link")
    nq = scene.nq_art
    # packed-state layout: 13 values per ENABLED free body (the ground is
    # disabled and excluded), then q_art, qd_art
    o_q = 13 * int(np.asarray(scene.enabled).sum())

    def ee_pos_of(q_art):
        s = st.replace(q_art=q_art)
        pt = kinematics.compute(scene, s)
        return pt.pos[ee_slot]

    p0 = np.asarray(jax.jit(ee_pos_of)(st.q_art))
    # target past the floor-touch depth: the optimum presses the contact
    target = jnp.asarray(
        np.array([p0[0] - 0.10, p0[1] + 0.10, -0.03]), st.pos.dtype
    )

    def cost(x, u):
        qd = x[o_q + nq : o_q + 2 * nq]
        return 1e-6 * jnp.sum(u ** 2) + 0.01 * jnp.sum(qd ** 2)

    def cost_final(x):
        ee = ee_pos_of(x[o_q : o_q + nq])
        qd = x[o_q + nq : o_q + 2 * nq]
        return 500.0 * jnp.sum((ee - target) ** 2) + jnp.sum(qd ** 2)

    H = 50
    prob = contact_mpc.MPCProblem(scene=scene, template=st, dt=0.01,
                                  horizon=H)

    tau_hold = art_dyn.rnea(
        scene.arts[0].model, st.q_art, jnp.zeros(nq), jnp.zeros(nq),
        scene.gravity,
    )
    # controls span enabled bodies' wrenches + joint torques
    # (contact_mpc.n_controls); warm start = gravity hold on the arm dofs
    nu = contact_mpc.n_controls(scene)
    us0 = jnp.zeros((H, nu), st.pos.dtype).at[:, nu - nq :].set(
        tau_hold[None, :]
    )

    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st
    )
    key = jax.random.PRNGKey(1)
    dq = jax.random.uniform(key, (B, nq), dtype=batched.q_art.dtype) * 0.04
    batched = batched.replace(q_art=batched.q_art + dq)
    return prob, batched, cost, cost_final, us0


def bench_ur10_mpc():
    """UR10 contact-MPC reach throughput (see _ur10_setup).
    Returns (solves/s, B)."""
    import jax

    from moby_tpu.mpc import contact_mpc

    B = int(os.environ.get("MOBY_BENCH_UR10_B", "256"))
    n_iters = 4
    prob, batched, cost, cost_final, us0 = _ur10_setup(B)

    # mu_init=0.1 (MOBY_BENCH_UR10_MU0): with the r5 gradient fixes the
    # articulated backward pass produces real (finite) gains, and the
    # contact-regularized Quu needs this much Levenberg mu to be PD from
    # iteration 1 — at the old 1e-6 the first ~5 iterations only inflate
    # mu, so a 4-iteration solve accepted nothing (measured: mean cost
    # 7.34 -> 4.76 in 4 iters at mu0=0.1; du=0 at mu0=1e-6)
    mu0 = float(os.environ.get("MOBY_BENCH_UR10_MU0", "0.1"))

    @jax.jit
    def sweep(states):
        return contact_mpc.solve_batch(
            prob, states, cost, cost_final, us0=us0, n_iters=n_iters,
            mu_init=mu0,
        ).cost

    out = sweep(batched)
    jax.block_until_ready(out)

    t0 = time.time()
    reps = 3
    for _ in range(reps):
        out = sweep(batched)
    jax.block_until_ready(out)
    dt_s = time.time() - t0
    return B * reps / dt_s, B


def _pile64_setup(B, side=4, pool=256):
    """(scene, batched_states, n_candidates, rollout_chunk) for the pooled
    side**3-sphere pile at batch B. At the defaults (64 spheres, pool
    256), 2016 sphere-sphere candidates are culled
    each step to 256 runtime-assigned contact slots (set_pair_pool — the
    fixed-shape stand-in for the reference's sweep-and-prune broad phase,
    src/CCD.cpp:702-990), so the impact LCP is cap-bound (n = 1920 +
    limits) instead of O(n_bodies^2) (~13k dense). `rollout_chunk` steps
    the batch 10 times at dt=0.01."""
    import jax
    import jax.numpy as jnp

    from moby_tpu.core import scene as sc
    from moby_tpu.math import quaternion as quat
    from moby_tpu.sim import stepper

    # compacted BPP working set keeps the big-LCP sub-solves small
    os.environ.setdefault("MOBY_BPP_COMPACT_NA", "384")

    n = side ** 3
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    r = 0.5
    rng = np.random.RandomState(0)
    k = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                jit_off = rng.uniform(-0.01, 0.01, 3)
                pos = np.array([
                    (ix - side / 2) * 1.02 + jit_off[0],
                    (iy - side / 2) * 1.02 + jit_off[1],
                    r + 0.01 + iz * 1.02 + jit_off[2],
                ])
                b.add_body(f"p{k}", mass=1.0,
                           inertia=sc.sphere_inertia(1.0, r), pos=pos)
                b.add_geom(f"p{k}", sc.SPHERE, [r])
                k += 1
    pq = np.asarray(quat.from_rpy(np.array([1.5707963267949, 0, 0])))
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4)
    for i in range(n):
        b.set_contact_params("ground", f"p{i}", cp)
        for j in range(i + 1, n):
            b.set_contact_params(f"p{i}", f"p{j}", cp)
    b.set_pair_pool(sc.SPHERE, sc.SPHERE, pool)
    scene, st = b.compile()
    n_cand = int(scene.n_pairs) - n  # sphere-sphere candidates

    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st
    )
    key = jax.random.PRNGKey(0)
    dz = jax.random.uniform(key, (B, scene.nb),
                            dtype=batched.pos.dtype) * 0.005
    batched = batched.replace(pos=batched.pos.at[:, :, 2].add(dz))

    @jax.jit
    def rollout_chunk(states):
        def f(s, _):
            return jax.vmap(lambda x: stepper.step(scene, x, 0.01))(s), None

        out, _ = jax.lax.scan(f, states, None, length=10)
        return out

    return scene, batched, n_cand, rollout_chunk


def bench_pile64():
    """64-sphere pile stepping on the runtime pair pool (see
    `_pile64_setup`; the >=64-body regime).

    Returns (steps/s, settled_ok, K, n_candidates). Also checks that the
    pile actually comes to rest (stability evidence, not just throughput).
    """
    import jax

    n = 64
    B = int(os.environ.get("MOBY_BENCH_PILE_B", "8"))
    scene, batched, n_cand, rollout_chunk = _pile64_setup(B)
    out = rollout_chunk(batched)
    jax.block_until_ready(out)
    t0 = time.time()
    n_chunks = 5
    for _ in range(n_chunks):
        out = rollout_chunk(out)
    jax.block_until_ready(out)
    dt = time.time() - t0
    sps = B * 10 * n_chunks / dt

    # settle the pile and check it is at rest (stability evidence)
    for _ in range(10):
        out = rollout_chunk(out)
    pos = np.asarray(out.pos)
    vel = np.asarray(out.vel)
    ke = 0.5 * float(np.sum(vel[0] ** 2))
    settled = bool(
        np.isfinite(pos).all()
        and (pos[:, :n, 2] > 0.45).all()
        and ke < 10.0
    )
    return sps, settled, int(scene.n_contacts), n_cand


def bench_latency():
    """Per-solve wall latency (ms) in the small-B/online regime a real MPC
    loop runs in (ball-push; the arm cell returns with its scene file).

    One timed call = one full batched contact-MPC solve (4 iLQR iterations,
    H=50); at B=1 this IS the replanning latency a controller would see.
    Mirrors the reference's `-or` per-iteration wall reporting
    (/root/reference/programs/driver.cpp:234-241), which is likewise wall
    time of the whole solve unit. Returns {field: ms}.
    """
    import jax

    from moby_tpu.mpc import contact_mpc

    out = {}
    for name, setup in (("ballpush", _ballpush_setup),):
        for B in (1, 8, 64):
            prob, batched, cost, cost_final, us0 = setup(B)

            @jax.jit
            def sweep(states, prob=prob, cost=cost, cost_final=cost_final,
                      us0=us0):
                return contact_mpc.solve_batch(
                    prob, states, cost, cost_final, us0=us0, n_iters=4
                ).cost

            r = sweep(batched)
            jax.block_until_ready(r)
            reps = 5
            t0 = time.time()
            for _ in range(reps):
                r = sweep(batched)
            jax.block_until_ready(r)
            ms = (time.time() - t0) / reps * 1e3
            out[f"latency_ms_{name}_B{B}"] = round(ms, 1)
    return out


def main():
    from moby_tpu import config

    device = gpu_identity()
    config.use_compile_cache()
    extra = {}
    steps_per_s = None
    if os.environ.get("MOBY_BENCH_SKIP_STEPS") != "1":
        steps_per_s = bench_steps()
        extra["contact_sim_steps_per_s"] = round(steps_per_s, 1)
        extra["steps_B"] = int(os.environ.get("MOBY_BENCH_B", "512"))

    if os.environ.get("MOBY_BENCH_SKIP_MPC") == "1":
        print(json.dumps({
            "metric": "contact_sim_scenario_steps_per_s",
            "value": round(steps_per_s, 1),
            "unit": "steps/s",
            "device": device,
            "extra": extra,
        }))
        return

    solves_per_s, mpc_b = bench_mpc()
    extra["mpc_B"] = mpc_b
    extra["mpc_iters"] = 4

    if os.environ.get("MOBY_BENCH_SKIP_PILE") != "1":
        pile_sps, pile_ok, pile_k, pile_cand = bench_pile64()
        extra["pile64_steps_per_s"] = round(pile_sps, 1)
        extra["pile64_settled"] = pile_ok
        extra["pile64_contact_slots"] = pile_k
        extra["pile64_candidate_pairs"] = pile_cand

    if os.environ.get("MOBY_BENCH_SKIP_LATENCY") != "1":
        extra.update(bench_latency())

    print(json.dumps({
        "metric": "contact_mpc_solves_per_s_H50",
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "device": device,
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
