"""f32 (GPU execution dtype) trajectory-sanity harness.

The golden-regression suite runs f64 on CPU; the benchmarks run f32 on the
GPU (`bench.py` conditions). These tests run the same scenes at f32 — which
also exercises the fused Gauss–Jordan sub-solve route (`lcp._use_gj`) that
the GPU production path uses — and assert bounded drift against the f64
trajectory plus physical invariants (resting heights, no energy blow-up).

Mirrors the reference's implicit contract that trajectories are stable at
the solver's NEAR_ZERO scale (include/Moby/Constants.h:21); NEAR_ZERO(f32)
= 3.5e-4 sits at contact scale, so this is the harness that proves the
f32-retuned thresholds hold up.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from moby_tpu.core import scene as sc
from moby_tpu.math import quaternion as quat
from moby_tpu.sim import stepper


def _sphere_stack(dtype):
    b = sc.SceneBuilder(dtype=dtype)
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
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.0, nk=16)
    b.set_contact_params("ground", "sph1", cp)
    b.set_contact_params("sph1", "sph2", cp)
    b.set_contact_params("sph2", "sph3", cp)
    return b.compile()


def _friction_box(dtype):
    b = sc.SceneBuilder(dtype=dtype)
    b.set_gravity([0, 0, -9.81])
    b.add_body(
        "box", mass=1.0, inertia=sc.box_inertia(1.0, 0.5, 0.5, 0.5),
        pos=np.array([0, 0, 0.5]),
    )
    b.add_body("ground", enabled=False)
    b.add_geom("box", sc.BOX, [0.5, 0.5, 0.5])
    pq = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))
    b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
    b.set_contact_params(
        "ground", "box", sc.ContactParams(epsilon=0.0, mu_coulomb=0.5, nk=4)
    )
    return b.compile()


def _rollout(scene, st, dt, n):
    @jax.jit
    def run(s):
        def f(s, _):
            s2 = stepper.step(scene, s, dt)
            return s2, s2.pos
        return jax.lax.scan(f, s, None, length=n)

    return run(st)


class TestF32SphereStack:
    def test_drift_vs_f64(self):
        n_steps = 150
        scene64, st64 = _sphere_stack(np.float64)
        scene32, st32 = _sphere_stack(np.float32)
        assert st32.pos.dtype == jnp.float32

        _, traj64 = _rollout(scene64, st64, 0.01, n_steps)
        _, traj32 = _rollout(scene32, st32, 0.01, n_steps)

        drift = np.max(np.abs(np.asarray(traj64, np.float64)
                              - np.asarray(traj32, np.float64)))
        # contact scale is NEAR_ZERO(f32) = 3.5e-4; the stack must track the
        # f64 trajectory to a few contact-scale units over 1.5 s
        assert drift < 5e-3, f"f32 drift {drift}"

    def test_resting_heights(self):
        scene, st = _sphere_stack(np.float32)
        final, _ = _rollout(scene, st, 0.01, 200)
        z = np.asarray(final.pos[:, 2])
        np.testing.assert_allclose(z[:3], [1.0, 3.0, 5.0], atol=5e-3)
        # at f32 the stack parks at 2*NEAR_ZERO separation and alternates one
        # free-fall step (|v| = g*dt) with an impact step; bound by one step
        # of gravity
        v = np.asarray(final.vel)
        assert np.max(np.abs(v[:3])) < 9.81 * 0.01 + 1e-3

    def test_no_energy_gain(self):
        scene, st = _sphere_stack(np.float32)

        @jax.jit
        def run(s):
            def f(s, _):
                s2 = stepper.step(scene, s, 0.01)
                ke = 0.5 * jnp.sum(s2.vel ** 2) + 0.5 * jnp.sum(s2.omega ** 2)
                pe = 9.81 * jnp.sum(s2.pos[:3, 2])
                return s2, ke + pe
            return jax.lax.scan(f, s, None, length=100)

        _, energy = run(st)
        e = np.asarray(energy)
        # total energy must not grow above its start (impacts only
        # dissipate); the f32 parking band (2*NEAR_ZERO position breathing +
        # one gravity-step of KE) accounts for ~0.04 J of jitter on this
        # 88 J baseline — bound at 0.1 J, far below any real blow-up
        assert e.max() <= e[0] + 0.1, f"energy gain {e.max() - e[0]}"


class TestF32FrictionBox:
    def test_box_rests(self):
        scene, st = _friction_box(np.float32)
        final, traj = _rollout(scene, st, 0.01, 150)
        z = float(final.pos[0, 2])
        assert abs(z - 0.5) < 5e-3, f"box height {z}"
        # no lateral wander and no spin-up
        assert float(jnp.max(jnp.abs(final.pos[0, :2]))) < 1e-3
        assert float(jnp.max(jnp.abs(final.omega[0]))) < 1e-2

    def test_sliding_box_stops(self):
        scene, st = _friction_box(np.float32)
        st = st.replace(vel=st.vel.at[0, 0].set(jnp.asarray(2.0, jnp.float32)))
        final, _ = _rollout(scene, st, 0.01, 150)
        # mu=0.5 => decel 4.905 m/s^2, stops after ~0.41 s
        assert float(jnp.abs(final.vel[0, 0])) < 2e-2
        x = float(final.pos[0, 0])
        # analytic sliding distance v^2/(2 mu g) = 0.4077
        assert abs(x - 0.4077) < 0.05, f"slide distance {x}"
