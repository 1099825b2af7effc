"""Multi-process scaling and solver-axis sharding of large LCP blocks.

The reference is single-process/single-thread (SURVEY.md §2.6); these are the
framework-native distributed components:

* **Host axis + scenario axis.** `initialize()` wraps
  `jax.distributed.initialize` for multi-process launches;
  `host_scenario_mesh()` builds a 2-D ("host", "scenario") mesh whose host
  axis spans processes and whose scenario axis spans the devices of one
  process. Scenario batches shard over the *flattened* mesh — scenarios are
  independent, so the layout is pure data parallelism and trajectories are
  shard-count invariant (asserted in tests on a virtual 8-device mesh).

* **Solver axis for large LCP blocks.** When one complementarity block is
  too big for a chip (BASELINE.md scaling row; SURVEY §5 "many contacts"),
  `lcp_apgd_sharded` solves it with rows of the Delassus operator sharded
  over a `solver` mesh axis: each shard owns M[rows, :] and updates its z
  rows locally; one `all_gather` of z per iteration is the only collective.
  The algorithm is accelerated projected gradient (APGD, Nesterov momentum
  with restart) on the convex QP  min ½z'Mz + q'z  s.t. z ≥ 0, whose KKT
  conditions are exactly the monotone LCP of the impact model. Fixed
  iteration count, mask-padded — the same fixed-shape design rules as the
  dense solvers. `lcp_apgd` is the single-device reference implementation used for
  verification and as a batched presolve.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Bring up jax.distributed for a multi-host run (no-op when single
    process and no coordinator is given). Call before first device use."""
    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_scenario_mesh(n_hosts: Optional[int] = None,
                       devices=None) -> Mesh:
    """2-D ("host", "scenario") mesh. In a multi-process run, rows map to
    processes and columns to the devices of one process; under a virtual
    flat device list the same layout validates the sharding program."""
    devs = list(devices if devices is not None else jax.devices())
    nh = n_hosts or max(1, jax.process_count())
    if len(devs) % nh:
        raise ValueError(f"{len(devs)} devices do not split over {nh} hosts")
    arr = np.array(devs).reshape(nh, len(devs) // nh)
    return Mesh(arr, axis_names=("host", "scenario"))


def shard_batch_2d(mesh: Mesh, batched):
    """Shard a leading scenario batch over the flattened (host, scenario)
    mesh (pure data parallelism)."""
    spec = lambda x: NamedSharding(
        mesh, P(("host", "scenario"), *([None] * (x.ndim - 1)))
    )
    return jax.device_put(
        batched, jax.tree_util.tree_map(spec, batched)
    )


def sharded_rollout_2d(scene, mesh: Mesh, batched, dt, n_steps):
    """Batched rollout sharded over the (host, scenario) mesh."""
    from ..sim import stepper

    @jax.jit
    def run(states):
        states = jax.lax.with_sharding_constraint(
            states,
            jax.tree_util.tree_map(
                lambda x: NamedSharding(
                    mesh, P(("host", "scenario"), *([None] * (x.ndim - 1)))
                ),
                states,
            ),
        )

        def f(s, _):
            return jax.vmap(lambda x: stepper.step(scene, x, dt))(s), None

        out, _ = jax.lax.scan(f, states, None, length=n_steps)
        return out

    return run(batched)


# ---------------------------------------------------------------------------
# Solver-axis sharding: APGD for one large monotone LCP
# ---------------------------------------------------------------------------


def _apgd_body(matvec, q, mask, L, z0, iters, axis=None):
    """APGD on min ½z'Mz+q'z, z>=0. matvec(y) must return M y for the rows
    this shard owns. When `axis` is given (inside shard_map) the restart dot
    product is psum-reduced so every row block restarts consistently."""
    dtype = q.dtype
    alpha = 1.0 / L

    def body(carry, _):
        z, y, t = carry
        grad = matvec(y) + q
        z_new = jnp.maximum(jnp.where(mask, y - alpha * grad, 0.0), 0.0)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        beta = (t - 1.0) / t_new
        y_new = z_new + beta * (z_new - z)
        # gradient restart: momentum fights descent -> reset (global dot)
        rdot = jnp.vdot(grad, z_new - z)
        if axis is not None:
            rdot = jax.lax.psum(rdot, axis)
        restart = rdot > 0.0
        y_new = jnp.where(restart, z_new, y_new)
        t_new = jnp.where(restart, jnp.asarray(1.0, dtype), t_new)
        return (z_new, y_new, t_new), None

    t0 = jnp.asarray(1.0, dtype)
    if axis is not None:
        t0 = jax.lax.pcast(t0, axis, to="varying")
    (z, _, _), _ = jax.lax.scan(
        body, (z0, z0, t0), None, length=iters
    )
    return z


def lcp_apgd(M, q, mask, z0=None, iters: int = 200):
    """Single-device APGD LCP solve (verification reference / presolve)."""
    n = q.shape[0]
    dtype = M.dtype
    outer = mask[:, None] & mask[None, :]
    Mm = jnp.where(outer, M, 0.0)
    qm = jnp.where(mask, q, 0.0)
    L = jnp.maximum(jnp.max(jnp.sum(jnp.abs(Mm), axis=1)), 1e-12)
    z0 = jnp.zeros(n, dtype) if z0 is None else jnp.where(mask, z0, 0.0)
    return _apgd_body(lambda y: Mm @ y, qm, mask, L, z0, iters)


def lcp_apgd_sharded(M, q, mask, mesh: Mesh, axis: str = "solver",
                     z0=None, iters: int = 200):
    """One large LCP sharded over `axis`: row-block matvecs local to each
    shard, one all-gather of z per iteration.

    M: (n, n) with n divisible by the axis size. Returns the full z on every
    shard (replicated).
    """
    n = q.shape[0]
    nshards = mesh.shape[axis]
    if n % nshards:
        raise ValueError(f"LCP dim {n} not divisible by {nshards} shards")
    dtype = M.dtype

    outer = mask[:, None] & mask[None, :]
    Mm = jnp.where(outer, M, 0.0)
    qm = jnp.where(mask, q, 0.0)
    L = jnp.maximum(jnp.max(jnp.sum(jnp.abs(Mm), axis=1)), 1e-12)
    z0 = jnp.zeros(n, dtype) if z0 is None else jnp.where(mask, z0, 0.0)

    def solve_local(M_rows, q_rows, mask_rows, z0_rows, L_full):
        # each shard owns a contiguous row block; z lives sharded and is
        # re-assembled by all_gather for the matvec
        def matvec(y_rows):
            y = jax.lax.all_gather(y_rows, axis, tiled=True)
            return M_rows @ y

        return _apgd_body(
            matvec, q_rows, mask_rows, L_full[0], z0_rows, iters, axis=axis
        )

    pr = P(axis)
    f = jax.shard_map(
        solve_local,
        mesh=mesh,
        in_specs=(P(axis, None), pr, pr, pr, P(None)),
        out_specs=P(axis),
    )
    return f(Mm, qm, mask, z0, L[None])
