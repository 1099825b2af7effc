"""Multi-device sharding tests (8 virtual CPU devices via conftest).

The reference has no distributed tests (nothing to distribute, SURVEY.md §4);
these are the shard-count-invariance tests the batched build requires: identical
trajectories at 1 device and N devices.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from moby_tpu.core import scene as sc
from moby_tpu.math import quaternion as quat
from moby_tpu.parallel import mesh as pmesh


def build_scene():
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    b.add_body(
        "ball", mass=1.0, inertia=sc.sphere_inertia(1.0, 0.5),
        pos=np.array([0.0, 0.0, 1.0]),
    )
    b.add_body("ground", enabled=False)
    b.add_geom("ball", sc.SPHERE, [0.5])
    pq = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))
    b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
    b.set_contact_params(
        "ground", "ball", sc.ContactParams(epsilon=0.3, mu_coulomb=0.0, nk=4)
    )
    return b.compile()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
class TestSharding:
    def test_shard_count_invariance(self):
        scene, st = build_scene()
        B = 16
        batched = pmesh.broadcast_state(st, B)
        dz = jnp.linspace(0.0, 0.5, B)
        batched = batched.replace(pos=batched.pos.at[:, 0, 2].add(dz))

        m8 = pmesh.scenario_mesh(8)
        m1 = pmesh.scenario_mesh(1)

        out8 = pmesh.sharded_rollout(
            scene, m8, pmesh.shard_batch(m8, batched), 0.01, 20
        )
        out1 = pmesh.sharded_rollout(
            scene, m1, pmesh.shard_batch(m1, batched), 0.01, 20
        )
        np.testing.assert_allclose(
            np.asarray(out8.pos), np.asarray(out1.pos), atol=1e-12
        )
        # scenarios genuinely differ
        assert np.std(np.asarray(out8.pos[:, 0, 2])) > 1e-3

    def test_sharded_state_devices(self):
        scene, st = build_scene()
        m = pmesh.scenario_mesh(8)
        batched = pmesh.shard_batch(m, pmesh.broadcast_state(st, 16))
        # the batch is actually spread over devices
        assert len(batched.pos.sharding.device_set) == 8


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
class TestShardedMPC:
    def test_sharded_mpc_matches_unsharded(self):
        """`sharded_mpc_sweep` (shard_map + batch-voted iLQR) must produce
        the same solves as single-device `solve_batch` — shard-count
        invariance for the north-star MPC path."""
        from moby_tpu.mpc import contact_mpc

        scene, st = build_scene()
        B = 16
        batched = pmesh.broadcast_state(st, B)
        dz = jnp.linspace(0.0, 0.3, B)
        batched = batched.replace(pos=batched.pos.at[:, 0, 2].add(dz))

        prob = contact_mpc.MPCProblem(
            scene=scene, template=st, dt=0.02, horizon=6
        )
        target = jnp.asarray([0.5, 0.0], st.pos.dtype)

        def cost(x, u):
            return 1e-4 * jnp.sum(u[:6] ** 2)

        def cost_final(x):
            return 50.0 * jnp.sum((x[0:2] - target) ** 2)

        m8 = pmesh.scenario_mesh(8)
        res8 = pmesh.sharded_mpc_sweep(
            prob, pmesh.shard_batch(m8, batched), cost, cost_final, m8,
            n_iters=3,
        )
        res1 = contact_mpc.solve_batch(
            prob, batched, cost, cost_final, n_iters=3
        )
        np.testing.assert_allclose(
            np.asarray(res8.cost), np.asarray(res1.cost), rtol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(res8.us), np.asarray(res1.us), atol=1e-9
        )
