"""Quick A/B of the ur10 contact-MPC sweep across backward-pass modes
(record/replay, hoisted linearization) on the attached GPU.

Run from the repo root: python scripts/bench_ur10_modes.py [modes...]
modes: plain rr rr_hoist (default: rr rr_hoist)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()

import xml.etree.ElementTree as ET

import numpy as np
import jax
import jax.numpy as jnp

from moby_tpu.core import scene as sc
from moby_tpu.io import sdfio
from moby_tpu.math import quaternion as quat
from moby_tpu.mpc import contact_mpc
from moby_tpu.sim import kinematics
from moby_tpu.dynamics import aba as art_dyn


def build(B=256):
    """geom mode (env MOBY_BENCH_UR10_GEOM):
    - 'proxy' (round-3 comparable): drop all mesh hulls, 3cm fist box on
      the wrist vs the floor plane
    - 'real': the wrist_3 link's actual .dae collision hull vs the floor;
      other links' hulls dropped (they stay >0.4 m above the floor for the
      whole task — dropping distant pairs is the fixed-shape equivalent of
      the reference's broad-phase cull)
    """
    geom_mode = os.environ.get("MOBY_BENCH_UR10_GEOM", "proxy")
    sdf_path = "/root/reference/example/ur10/ur10/ur10.sdf"
    root = ET.parse(sdf_path).getroot()
    model = root if root.tag == "model" else root.find("model")
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    mname, _, _ = sdfio.add_model(
        b, model, os.path.dirname(os.path.abspath(sdf_path)),
        strict_meshes=False,
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
    pq = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))
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
    print(f"geom={geom_mode}: K={scene.n_contacts} NL={scene.n_limits} "
          f"n_lcp={scene.n_lcp}", flush=True)
    ee_slot = scene.nb + [
        l.name for l in scene.arts[0].model.links
    ].index("wrist_3_link")
    nq = scene.nq_art
    o_q = 13 * int(np.asarray(scene.enabled).sum())

    def ee_pos_of(q_art):
        s = st.replace(q_art=q_art)
        return kinematics.compute(scene, s).pos[ee_slot]

    p0 = np.asarray(jax.jit(ee_pos_of)(st.q_art))
    target = jnp.asarray(
        np.array([p0[0] - 0.10, p0[1] + 0.10, -0.03]), st.pos.dtype)

    def cost(x, u):
        qd = x[o_q + nq: o_q + 2 * nq]
        return 1e-6 * jnp.sum(u ** 2) + 0.01 * jnp.sum(qd ** 2)

    def cost_final(x):
        ee = ee_pos_of(x[o_q: o_q + nq])
        qd = x[o_q + nq: o_q + 2 * nq]
        return 500.0 * jnp.sum((ee - target) ** 2) + jnp.sum(qd ** 2)

    H = 50
    prob = contact_mpc.MPCProblem(scene=scene, template=st, dt=0.01,
                                  horizon=H)
    tau_hold = art_dyn.rnea(scene.arts[0].model, st.q_art, jnp.zeros(nq),
                            jnp.zeros(nq), scene.gravity)
    nu = contact_mpc.n_controls(scene)
    us0 = jnp.zeros((H, nu), st.pos.dtype).at[:, nu - nq:].set(
        tau_hold[None, :])
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    key = jax.random.PRNGKey(1)
    dq = jax.random.uniform(key, (B, nq), dtype=batched.q_art.dtype) * 0.04
    batched = batched.replace(q_art=batched.q_art + dq)
    return prob, batched, cost, cost_final, us0


def main():
    modes = sys.argv[1:] or ["rr", "rr_hoist"]
    B = int(os.environ.get("MOBY_BENCH_UR10_B", "256"))
    prob, batched, cost, cost_final, us0 = build(B)
    kws = {
        "plain": dict(record_replay=False),
        "rr": dict(record_replay=True),
        "rr_hoist": dict(record_replay=True, hoist_linearization=True),
        "hoist": dict(record_replay=False, hoist_linearization=True),
    }
    costs = {}
    for m in modes:
        @jax.jit
        def sweep(states, kw=kws[m]):
            return contact_mpc.solve_batch(
                prob, states, cost, cost_final, us0=us0, n_iters=4,
                mu_init=float(os.environ.get("MOBY_BENCH_UR10_MU0", "0.1")),
                **kw
            ).cost

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
        print(f"{m}: {B * reps / dt:.2f} solves/s  (B={B}, compile+1st "
              f"{tc:.1f}s, mean cost {costs[m].mean():.4f})", flush=True)
        if os.environ.get("MOBY_UR10_PRINT_MEMBERS", "0") == "1":
            print("  member costs[:16]:",
                  " ".join(f"{c:.4f}" for c in costs[m][:16]), flush=True)
    names = list(costs)
    for m in names[1:]:
        d = np.max(np.abs(costs[m] - costs[names[0]]))
        print(f"cost parity {names[0]} vs {m}: max|d| = {d:.3e}", flush=True)


if __name__ == "__main__":
    main()
