"""cc-pendulum dt-convergence study (round-1 VERDICT item 4).

The reference setup (`regress/contact-constrained-pendulum.setup`) says
-s=1e-4 -mt=10, but the golden trajectory has 6501 lines at 1e-3 spacing over
6.5 s — the data was generated at 1e-3 (or decimated). This study simulates
our engine at dt in {1e-3, 5e-4, 2e-4, 1e-4}, samples at the golden's 1e-3
grid, and reports

  * the L-inf error vs the golden over the first 1 s and over 6.5 s,
  * the pin-anchor drift |anchor(t)| at 1 s and 6.5 s per dt,

to separate our integration error (must converge as dt -> 0) from the
reference-side sag (whatever the golden itself does).

Usage: python scripts/cc_pendulum_dt_study.py [--full]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from moby_tpu import config  # noqa: E402
config.use_compile_cache()

GOLDEN = "/root/reference/regress/contact-constrained-pendulum.dat"


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from moby_tpu.plugins import cc_pendulum
    from moby_tpu.sim import stepper
    from moby_tpu.math import quaternion as quat_mod

    scene, st, dopts = cc_pendulum.build()

    # last line of the golden is the original run's CPU seconds
    # (programs/regress.cpp:274-277) — drop it
    with open(GOLDEN) as fh:
        lines = [l.split() for l in fh]
    golden = np.array([[float(x) for x in l] for l in lines if len(l) == 8])
    t_g = golden[:, 0]

    horizon = 6.5 if "--full" in sys.argv else 1.0
    n_keep = min(int(round(horizon / 0.001)) + 1, len(golden))
    gold = golden[:n_keep]

    print(f"golden: {len(t_g)} lines, dt spacing {t_g[1]-t_g[0]:.4g}; "
          f"comparing over {horizon}s", flush=True)

    for dt in (1e-3, 5e-4, 2e-4, 1e-4):
        sub = int(round(0.001 / dt))
        n_steps = (n_keep - 1) * sub

        @jax.jit
        def chunk(s):
            def f(s, _):
                return stepper.step(scene, s, dt), None
            out, _ = jax.lax.scan(f, s, None, length=sub)
            return out

        s = st
        rows = [np.concatenate([np.asarray(st.pos[0]), np.asarray(st.quat[0])])]
        for k in range(n_keep - 1):
            s = chunk(s)
            rows.append(
                np.concatenate([np.asarray(s.pos[0]), np.asarray(s.quat[0])])
            )
        traj = np.stack(rows)  # (n_keep, 7): x y z qx qy qz qw

        # golden columns: t x y z qx qy qz qw
        err = np.abs(traj - gold[:, 1:8])
        # quaternion sign ambiguity
        err_q = np.minimum(
            np.abs(traj[:, 3:] - gold[:, 4:8]),
            np.abs(traj[:, 3:] + gold[:, 4:8]),
        )
        linf = max(err[:, :3].max(), err_q.max())
        linf_1s = max(err[:1001, :3].max(), err_q[:1001].max()) if n_keep > 1000 else linf

        # pin-anchor drift: |world position of the body's local (0, 1, 0)|
        def anchor_drift(row):
            p = row[:3]
            q = row[3:7]
            R = np.asarray(quat_mod.to_matrix(jnp.asarray(q)))
            return float(np.linalg.norm(p + R @ np.array([0.0, 1.0, 0.0])))

        drift_end = anchor_drift(traj[-1])
        drift_gold = anchor_drift(gold[-1, 1:8])
        print(
            f"dt={dt:8.1e}: L-inf[0,1s]={linf_1s:10.3e}  "
            f"L-inf[0,{horizon}s]={linf:10.3e}  "
            f"anchor drift ours={drift_end:.6f} golden={drift_gold:.6f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
