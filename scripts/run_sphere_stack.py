"""Dev harness: sphere-stack vs reference golden trajectory."""

import os, sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()

from moby_tpu.core import scene as sc
from moby_tpu.sim import stepper


def build():
    b = sc.SceneBuilder()
    b.set_gravity([0, 0, -9.81])
    r = 1.0
    inertia = sc.sphere_inertia(1.0, r)
    b.add_body("sph1", mass=1.0, inertia=inertia, pos=np.array([0, 0, 1.0]))
    b.add_body("sph2", mass=1.0, inertia=inertia, pos=np.array([0, 0, 3.0]))
    b.add_body("sph3", mass=1.0, inertia=inertia, pos=np.array([0, 0, 5.0]))
    b.add_body("ground", enabled=False)
    b.add_geom("sph1", sc.SPHERE, [r])
    b.add_geom("sph2", sc.SPHERE, [r])
    b.add_geom("sph3", sc.SPHERE, [r])
    # plane rotated so +z is up (rpy 1.5707963267949 0 0 maps local +y -> +z)
    from moby_tpu.math import quaternion as quat

    pq = np.asarray(quat.from_rpy(jnp.array([1.5707963267949, 0, 0])))
    b.add_geom("ground", sc.PLANE, [0.0], quat=pq)
    cp = sc.ContactParams(epsilon=0.0, mu_coulomb=0.0, mu_viscous=0.0, nk=16)
    b.set_contact_params("ground", "sph1", cp)
    b.set_contact_params("sph1", "sph2", cp)
    b.set_contact_params("sph2", "sph3", cp)
    return b.compile()


def main():
    scene, st = build()
    print("pairs:", scene.n_pairs, "contacts:", scene.n_contacts, "lcp:", scene.n_lcp)

    golden = np.loadtxt("/root/reference/regress/sphere-stack.dat", max_rows=1000)
    dt = 0.001
    nsteps = int(sys.argv[1]) if len(sys.argv) > 1 else 100

    step_j = jax.jit(lambda s: stepper.step(scene, s, dt))
    errs = []
    for i in range(nsteps):
        st = step_j(st)
        row = golden[i + 1] if i + 1 < len(golden) else None
        ours = np.concatenate(
            [
                np.concatenate([np.asarray(st.pos[b]), np.asarray(st.quat[b])])
                for b in range(3)
            ]
        )
        if row is not None:
            ref = row[1:22]
            err = np.max(np.abs(ours - ref))
            errs.append(err)
            if i < 5 or (i + 1) % 20 == 0 or err > 1e-4:
                print(f"step {i+1} t={st.time:.3f} Linf={err:.3e}  z=({st.pos[0,2]:.9f},{st.pos[1,2]:.9f},{st.pos[2,2]:.9f})")
            if err > 1e-3:
                print("ref:", ref)
                print("got:", ours)
                break
    print("max Linf over", len(errs), "steps:", max(errs))


if __name__ == "__main__":
    main()
