"""moby_tpu: a batched rigid-body dynamics + contact-implicit MPC engine.

A from-scratch JAX framework with the capabilities of the Moby
multi-rigid-body simulator (reference: PositronicsLab/Moby): reduced-
coordinate Featherstone dynamics, semi-implicit time stepping with unilateral
contact resolved by batched LCP/QP impact solvers, joint limits, bilateral
implicit constraints, constraint stabilization, analytic + GJK collision,
Moby-XML/URDF/SDF scene loading, and an iLQR/SQP contact-MPC layer that
batches thousands of scenarios per device and shards across device meshes.

Everything is pure-functional and fixed-shape: a scene compiles to static
arrays, one time step is `step(state, scene) -> state`, and batching is
`jax.vmap` / `shard_map` over a leading scenario axis.
"""

from . import config  # noqa: F401  (pins the f32 matmul precision)

__version__ = "0.1.0"
