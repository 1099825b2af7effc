"""Ablate the steady-state step cost at B=512 on the attached device."""
import time, sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()
import jax, jax.numpy as jnp

from __graft_entry__ import _build_scene
from moby_tpu.sim import stepper, impact, stabilization

def timeit(stepf, st, n=10):
    st = stepf(st)
    jax.block_until_ready(st)  # compile + settle start
    for _ in range(30):
        st = stepf(st)
    jax.block_until_ready(st)
    t0 = time.time()
    out = st
    for _ in range(n):
        out = stepf(out)
    jax.block_until_ready(out)
    return (time.time() - t0) / n * 1000

def main():
    scene, st = _build_scene()
    B = 512
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    key = jax.random.PRNGKey(0)
    dz = jax.random.uniform(key, (B, scene.nb), dtype=batched.pos.dtype) * 0.01
    batched = batched.replace(pos=batched.pos.at[:, :, 2].add(dz))

    full = jax.jit(jax.vmap(lambda x: stepper.step(scene, x, 0.001)))
    print("full step ms:", round(timeit(full, batched), 2))

    # no stabilization
    orig_stab = stabilization.stabilize
    stabilization.stabilize = lambda scene, s: s
    nostab = jax.jit(jax.vmap(lambda x: stepper.step(scene, x, 0.001)))
    print("no-stabilization ms:", round(timeit(nostab, batched), 2))
    stabilization.stabilize = orig_stab

    # no impact resolution (and no stabilization)
    orig_imp = impact.resolve_impacts
    def noimp(scene_, st_, pt, con, zlast, zlast_active, lcp_solver=None):
        return impact.ImpactResult(
            jnp.zeros(scene_.ngc, st_.pos.dtype), zlast, zlast_active,
            jnp.zeros(scene_.n_contacts, st_.pos.dtype))
    impact.resolve_impacts = noimp
    stabilization.stabilize = lambda scene, s: s
    noimpact = jax.jit(jax.vmap(lambda x: stepper.step(scene, x, 0.001)))
    print("no-impact+no-stab ms:", round(timeit(noimpact, batched), 2))
    impact.resolve_impacts = orig_imp
    stabilization.stabilize = orig_stab

if __name__ == "__main__":
    main()
