"""Verify the ur10 bench's fixed-shape broad-phase cull (VERDICT r4 #8).

bench.py's ur10 scene keeps only the wrist_3 collision hull against the
floor and drops the other links' hulls as a "fixed-shape broad-phase cull".
This script turns that assertion into a checked invariant:

1. Solve the benchmark task (real geometry, production config) for a batch
   of members.
2. Re-run FK over every state of every optimized member trajectory and
   compute, for each DROPPED moving link hull, a conservative lower bound
   on its distance to the floor plane: center_height - hull_bounding_radius.
3. Assert the bound stays positive (the hull can never touch the floor) for
   every dropped link, state, and member.

The base link is excluded from the clearance requirement on different
grounds: a fixed-base arm's base link has all-zero Jacobian rows, so a
base-floor contact could never produce impulses (static-to-static).

Run from the repo root: python scripts/ur10_cull_check.py
Exit code 0 = cull verified.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from bench import _ur10_setup
    from moby_tpu.core import scene as sc
    from moby_tpu.mpc import contact_mpc
    from moby_tpu.sim import kinematics

    os.environ.setdefault("MOBY_BENCH_UR10_GEOM", "real")
    B = int(os.environ.get("MOBY_UR10_CULL_B", "32"))
    prob, batched, cost, cost_final, us0 = _ur10_setup(B)
    scene = prob.scene

    res = contact_mpc.solve_batch(
        prob, batched, cost, cost_final, us0=us0, n_iters=4,
        mu_init=float(os.environ.get("MOBY_BENCH_UR10_MU0", "0.1")))
    xs = res.xs  # (B, H+1, nx)
    print(f"solved B={B}, mean cost {float(np.asarray(res.cost).mean()):.3f}")

    # rebuild WITH all hulls to get each dropped link's bounding radius
    import xml.etree.ElementTree as ET
    from moby_tpu.io import sdfio

    sdf_path = "/root/reference/example/ur10/ur10/ur10.sdf"
    root = ET.parse(sdf_path).getroot()
    model = root if root.tag == "model" else root.find("model")
    bfull = sc.SceneBuilder()
    bfull.set_gravity([0, 0, -9.81])
    mname, _, _ = sdfio.add_model(
        bfull, model, os.path.dirname(os.path.abspath(sdf_path)))
    # per-link hull radius + local offset of the hull origin
    link_geoms = {}
    for g in bfull.geoms:
        if g.gtype != sc.POLYHEDRON or g.verts is None:
            continue
        link = g.body.split("/", 1)[1]
        r = float(np.max(np.linalg.norm(g.verts, axis=1)))
        link_geoms[link] = (np.asarray(g.pos, float), r)

    link_names = [l.name for l in scene.arts[0].model.links]
    moving_dropped = [
        ln for ln in link_names
        if ln in link_geoms and ln not in ("base_link", "wrist_3_link")
    ]
    print("dropped moving hulls checked:", moving_dropped)

    floor_z = -0.05  # bench plane height
    nq = scene.nq_art
    o_q = 13 * int(np.asarray(scene.enabled).sum())
    slot_of = {ln: scene.nb + i for i, ln in enumerate(link_names)}

    from moby_tpu.math import quaternion as quat

    @jax.jit
    def min_clearances(x):
        st = contact_mpc.unpack(scene, prob.template, x)
        pt = kinematics.compute(scene, st)
        outs = []
        for ln in moving_dropped:
            s = slot_of[ln]
            off, r = link_geoms[ln]
            c = pt.pos[s] + quat.rotate(pt.quat[s], jnp.asarray(off, x.dtype))
            outs.append(c[2] - floor_z - r)
        return jnp.stack(outs)

    clr = jax.vmap(jax.vmap(min_clearances))(xs)  # (B, H+1, n_links)
    clr_min = np.asarray(jnp.min(clr, axis=(0, 1)))
    ok = True
    for ln, c in zip(moving_dropped, clr_min):
        status = "OK" if c > 0 else "VIOLATION"
        print(f"  {ln:20s} min clearance bound {c:+.3f} m  {status}")
        ok &= c > 0
    if not ok:
        print("CULL VIOLATED: a dropped hull can reach the floor")
        sys.exit(1)
    print("CULL VERIFIED: every dropped moving hull stays clear of the "
          "floor over all optimized trajectories (bounding-sphere bound)")


if __name__ == "__main__":
    main()
