"""Ellipse-on-plane example plugin.

Python reimplementation of the reference's ellipse example
(example/ellipse/ellipse2D.xml + ellipse-plane-coldet-plugin.cpp): an
ellipsoid with semi-axes (1, 2, 1) bounces with restitution 0.6 and Coulomb
friction on a ground plane, constrained to the x-y plane by two low-friction
walls at z = ±1.

The reference plugin finds the ellipsoid's supporting point against each
plane by a (theta, phi) grid search + Newton polish
(ellipse-plane-coldet-plugin.cpp:131-210). The batched kernel uses the
closed form instead: the support point of the ellipsoid x^T diag(a,b,c)^-2 x
= 1 in direction d is p = (a^2 d_x, b^2 d_y, c^2 d_z) / |(a d_x, b d_y,
c d_z)| — exact, branch-free, and identical to the converged Newton polish.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import scene as sc
from ..math import quaternion as quat

AXES = (1.0, 2.0, 1.0)   # reference struct Ellipse {x=1, y=2, z=1}


def _ellipse_plane_kernel(axes):
    a2 = np.asarray(axes, float) ** 2
    a1 = np.asarray(axes, float)

    def kernel(scene, pos, quat_b, pairs):
        from ..geometry.narrowphase import geom_world_pose

        ga = scene.pair_g1[pairs]   # ellipse ghost (body pose)
        gb = scene.pair_g2[pairs]   # plane ghost (body pose, local y-up)
        ep, eq = geom_world_pose(scene, pos, quat_b, ga)
        pp, pq = geom_world_pose(scene, pos, quat_b, gb)
        dtype = pos.dtype
        up = quat.rotate(pq, jnp.array([0.0, 1.0, 0.0], dtype))
        dl = quat.inverse_rotate(eq, -up)            # support dir, local
        den = jnp.sqrt(
            jnp.sum((jnp.asarray(a1, dtype) * dl) ** 2, axis=-1)
        )
        p_l = jnp.asarray(a2, dtype) * dl / jnp.maximum(den, 1e-30)[..., None]
        pw = ep + quat.rotate(eq, p_l)               # lowest point, world
        y = jnp.sum((pw - pp) * up, axis=-1)
        pa = pw
        pb = pw - up * y[..., None]
        point = 0.5 * (pa + pb)
        return y, pa, pb, point[:, None, :], up[:, None, :], y[:, None]

    return kernel


def build():
    """Scene of example/ellipse/ellipse2D.xml: returns (scene, state)."""
    b = sc.SceneBuilder()
    b.set_gravity([0, -9.81, 0])
    # InertiaFromPrimitive: unit sphere, mass 1 -> I = (2/5) m r^2
    b.add_body(
        "ellipse", mass=1.0, inertia=sc.sphere_inertia(1.0, 1.0),
        pos=np.array([0.0, 5.0, 0.0]),
        lin_vel=np.array([0.5, 0.0, 0.0]),
        ang_vel=np.array([0.0, 0.0, 3.0]),
    )
    b.add_body("ground", enabled=False)
    rx = lambda a: np.asarray(quat.from_rpy(jnp.array([a, 0.0, 0.0])))
    # walls: plane normals +z (at z=-1) and -z (at z=+1), as the XML's
    # pz-pos / pz-neg rotated planes
    b.add_body("wall_pos", enabled=False, pos=np.array([0.0, 0.0, -1.0]),
               quat=rx(np.pi / 2))
    b.add_body("wall_neg", enabled=False, pos=np.array([0.0, 0.0, 1.0]),
               quat=rx(-np.pi / 2))
    kern = _ellipse_plane_kernel(AXES)
    for wall in ("ground", "wall_pos", "wall_neg"):
        b.add_custom_pair("ellipse", wall, kern, 1)
    b.set_contact_params(
        "ground", "ellipse",
        sc.ContactParams(epsilon=0.6, mu_coulomb=1.0, nk=16),
    )
    for wall in ("wall_pos", "wall_neg"):
        b.set_contact_params(
            wall, "ellipse",
            sc.ContactParams(epsilon=0.6, mu_coulomb=0.1, nk=16),
        )
    return b.compile()
