"""`moby-driver` equivalent: load a scene, run it, checkpoint, log, report.

Mirrors the reference driver's CLI surface (programs/driver.cpp:566-657):
  -s=H           step size (default from the scene's <DRIVER> block)
  -mt=T          maximum simulation time
  -mi=N          maximum iterations
  -p=NAME        plugin (Python module under moby_tpu.plugins with build())
  -w=N           write a checkpoint every N iterations
  -r=PATH        restore state from a checkpoint before running
  -l=MASK        logging mask (int or names: simulator,constraint,...)
  -lf=FILE       logging output file
  -or            output timing (s/iter and s/sim-sec, driver.cpp:234-241)
  -oi            output iteration numbers
  -stats         print per-step LCP solver effort (pivot counts / fallbacks,
                 the reference's LCP pivot counters, include/Moby/LCP.h:30)
  -prof=DIR      capture a jax.profiler trace of the run into DIR (the
                 gperftools PROFILE hook analog, driver.cpp:542-544)
  --cpu          force the float64 CPU backend
  -b=N           batch N identical scenarios (vmap) — an extension of the
                 reference CLI

Usage: python -m moby_tpu.cli.driver [flags] scene.xml
"""

from __future__ import annotations

import importlib
import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {
        "s": None, "mt": float("inf"), "mi": float("inf"), "p": None,
        "w": 0, "r": None, "l": 0, "lf": None, "or": False, "oi": False,
        "cpu": False, "b": 1, "stats": False, "prof": None,
    }
    pos = []
    for a in argv:
        if a.startswith("-s="):
            opts["s"] = float(a[3:])
        elif a.startswith("-mt="):
            opts["mt"] = float(a[4:])
        elif a.startswith("-mi="):
            opts["mi"] = int(a[4:])
        elif a.startswith("-p="):
            opts["p"] = a[3:]
        elif a.startswith("-w="):
            opts["w"] = int(a[3:])
        elif a.startswith("-r="):
            opts["r"] = a[3:]
        elif a.startswith("-l="):
            opts["l"] = a[3:]
        elif a.startswith("-lf="):
            opts["lf"] = a[4:]
        elif a == "-or":
            opts["or"] = True
        elif a == "-oi":
            opts["oi"] = True
        elif a == "--cpu":
            opts["cpu"] = True
        elif a == "-stats":
            opts["stats"] = True
        elif a.startswith("-prof="):
            opts["prof"] = a[6:]
        elif a.startswith("-b="):
            opts["b"] = int(a[3:])
        elif not a.startswith("-"):
            pos.append(a)

    if opts["cpu"]:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from .. import config
    from ..io import mobyxml, checkpoint
    from ..sim import stepper
    from ..utils import log as mlog

    config.use_compile_cache()
    if opts["l"]:
        mlog.set_reporting_level(opts["l"])
        mlog.set_output(opts["lf"])

    if opts["p"]:
        mod = importlib.import_module(f"moby_tpu.plugins.{opts['p']}")
        scene, st, dopts = mod.build()
    elif pos:
        scene, st, dopts = mobyxml.load(pos[0])
    else:
        print(__doc__)
        return 1

    dt = opts["s"] if opts["s"] is not None else dopts.step_size
    mlog.log(mlog.LOG_SIMULATOR, "scene: %d bodies, %d contacts, dt=%g",
             scene.nb, scene.n_contacts, dt)

    if opts["r"]:
        st, meta = checkpoint.load(opts["r"], st)
        print(f"restored checkpoint at t={float(np.ravel(st.time)[0]):.4f}")

    B = opts["b"]
    if B > 1:
        st = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (B,) + x.shape), st
        )
        step_j = jax.jit(
            lambda s: jax.vmap(lambda x: stepper.step(scene, x, dt))(s)
        )
    else:
        step_j = jax.jit(lambda s: stepper.step(scene, s, dt))

    prof_ctx = None
    if opts["prof"]:
        from jax import profiler as jprof

        jprof.start_trace(opts["prof"])

    total_pivots = 0
    total_fallbacks = 0
    it = 0
    t_wall0 = time.time()
    while it < opts["mi"]:
        t_now = float(np.ravel(np.asarray(st.time))[0])
        if t_now > opts["mt"]:
            break
        t0 = time.time()
        st = step_j(st)
        jax.block_until_ready(st.pos)
        it += 1
        if opts["stats"] and st.solver_pivots is not None:
            p = int(np.sum(np.asarray(st.solver_pivots)))
            f = int(np.sum(np.asarray(st.solver_fallbacks)))
            total_pivots += p
            total_fallbacks += f
            if opts["oi"] or it % 100 == 0:
                print(f"[solver] step {it}: {p} pivots, {f} fallbacks")
        if opts["oi"]:
            print(f"iteration: {it}  simulation time: {t_now:.6f}")
        if opts["or"] and it % 100 == 0:
            el = time.time() - t_wall0
            print(
                f"[timing] {el/it:.6f} s/iter, "
                f"{el/max(t_now, 1e-12):.3f} s/sim-sec"
            )
        if opts["w"] and it % opts["w"] == 0:
            checkpoint.save(f"driver.state.{it}.npz", st, {"iter": it})

    if opts["prof"]:
        from jax import profiler as jprof

        jprof.stop_trace()
        print(f"profiler trace written to {opts['prof']}")
    if opts["stats"]:
        print(
            f"[solver] total: {total_pivots} pivots, {total_fallbacks} "
            f"fallbacks ({total_pivots/max(it,1):.1f} pivots/step)"
        )
    el = time.time() - t_wall0
    t_now = float(np.ravel(np.asarray(st.time))[0])
    print(
        f"done: {it} iterations to t={t_now:.4f} in {el:.2f}s wall "
        f"({it*B/max(el,1e-9):.1f} scenario-steps/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
