"""On-card smoke test: drive the main path once on a GPU and check it.

    python chip_smoke.py               # every phase, one card
    python chip_smoke.py --four-cards  # only the sharded ball-push sweep, 4 cards

Phases (one card), each through the entry points a user calls, at the
widths `bench.py` uses:

1. precision — a 66x66 f32 product against numpy f64 (TF32 cannot pass);
2. stack     — friction+restitution sphere stack, B=512 in 10-step chunks;
               200-step f32 trajectory against the CPU f64 one;
3. table     — fixed-articulated-table (no-slip, articulated), 1 s at
               dt=1e-3 against CPU f64;
4. driver    — `moby_tpu.cli.driver.main` on sitting-box at -b=512;
5. ballpush  — contact-MPC ball-push, B=1536, H=50, 4 iLQR iterations via
               `contact_mpc.solve_batch`; mean cost of 8 members against
               the CPU f64 solve of the same members;
6. pile64    — pooled 64-sphere pile, B=8, LCP n~1920.

The CPU float64 references run in one child process (JAX_PLATFORMS=cpu,
x64) that never opens the card. The script exits non-zero, and prints no
result line, when JAX finds no GPU or any phase fails. Otherwise the last
line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TABLE_XML = os.path.join(REPO, "scenes", "fixed-articulated-table.xml")
BOX_XML = os.path.join(REPO, "scenes", "sitting-box.xml")

STACK_STEPS, STACK_DT = 200, 1e-3
TABLE_STEPS, TABLE_DT = 1000, 1e-3
MPC_ITERS = 4
REF_MEMBERS = 8
# f32 and f64 contact solves branch differently after impacts, so in-plane
# positions drift apart while the height stays physically pinned
STACK_MAX_DRIFT, STACK_Z_DRIFT = 5e-2, 5e-3
TABLE_DRIFT_02S, TABLE_DRIFT_MAX = 5e-3, 2e-2
# iLQR from f32 and f64 rollouts takes different local line-search branches
BALLPUSH_MEAN_RTOL = 5e-2
# the bound the virtual-mesh dry run holds sharded MPC to
SHARD_RTOL = 1e-5


class PhaseError(AssertionError):
    """A phase's result is outside its stated tolerance."""


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def require_gpu():
    """JAX's first device; exits non-zero unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(
            f"chip_smoke: needs a GPU, JAX found platform {dev.platform!r}\n"
        )
        raise SystemExit(2)
    return dev


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = _block(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# rollouts shared by the GPU phases and the CPU f64 reference
# ---------------------------------------------------------------------------


def _trajectory(scene, st, n_steps, dt, field):
    """jit'd scan of `stepper.step`; returns (compiled fn, state)."""
    import jax

    from moby_tpu.sim import stepper

    @jax.jit
    def run(s):
        def f(s, _):
            s = stepper.step(scene, s, dt)
            return s, getattr(s, field)

        return jax.lax.scan(f, s, None, length=n_steps)[1]

    return run, st


def stack_trajectory(n_steps=STACK_STEPS):
    """(n_steps, nb, 3) positions of the single unperturbed sphere stack."""
    import bench

    run, st = _trajectory(*bench._stack_scene(), n_steps, STACK_DT, "pos")
    return np.asarray(run(st), np.float64)


def table_trajectory(n_steps=TABLE_STEPS):
    """(n_steps, nq) joint positions of the articulated table."""
    from moby_tpu.io import mobyxml

    scene, st, _ = mobyxml.load(TABLE_XML)
    run, st = _trajectory(scene, st, n_steps, TABLE_DT, "q_art")
    return np.asarray(run(st), np.float64)


def ballpush_member_costs(B, n_members=REF_MEMBERS, n_iters=MPC_ITERS, H=50):
    """Costs of the first n_members of the B-member ball-push batch, solved
    as a batch of their own."""
    import jax

    import bench
    from moby_tpu.mpc import contact_mpc

    prob, batched, cost, cost_final, us0 = bench._ballpush_setup(B, H)
    sub = jax.tree_util.tree_map(lambda x: x[:n_members], batched)
    res = jax.jit(lambda s: contact_mpc.solve_batch(
        prob, s, cost, cost_final, us0=us0, n_iters=n_iters).cost)(sub)
    return np.asarray(res, np.float64)


def cpu_reference(out_path, stack_steps=STACK_STEPS, table_steps=TABLE_STEPS,
                  mpc_B=1536):
    """Entry of the CPU child: f64 references, saved to out_path (.npz)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    check(jax.devices()[0].platform == "cpu", "reference child left the CPU")
    np.savez(
        out_path,
        stack=stack_trajectory(stack_steps),
        table=table_trajectory(table_steps),
        ballpush=ballpush_member_costs(mpc_B),
    )


def start_cpu_reference(out_path):
    # no persistent cache: a CPU executable cached on another host may use
    # instructions this host lacks
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               CUDA_VISIBLE_DEVICES="", JAX_ENABLE_COMPILATION_CACHE="false")
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; chip_smoke.cpu_reference(sys.argv[1])",
         out_path],
        cwd=REPO, env=env,
    )


# ---------------------------------------------------------------------------
# phases (sizes are arguments so the tests can run them tiny on the CPU)
# ---------------------------------------------------------------------------


def phase_precision(n=66):
    """A default-precision f32 product must agree with f64 to 1e-6: what
    `import moby_tpu` pins (TF32 keeps about 1e-3)."""
    import jax
    import jax.numpy as jnp

    import moby_tpu  # noqa: F401

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    f = jax.jit(lambda x, y: x @ y)
    xa, xb = jnp.asarray(a), jnp.asarray(b)
    c, t_compile = _timed(f, xa, xb)
    c, t_steady = _timed(f, xa, xb)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    rel = float(np.abs(np.asarray(c, np.float64) - exact).max()
                / np.abs(exact).max())
    check(c.dtype == jnp.float32, f"product dtype {c.dtype}")
    check(rel < 1e-6, f"f32 product relative error {rel:.3e} (TF32?)")
    return {"compile_s": t_compile, "steady_s": t_steady, "rel_err": rel,
            "matmul_precision": jax.config.jax_default_matmul_precision}


def phase_stack(ref_traj, B=512, chunks=5, traj_steps=STACK_STEPS):
    """Batched stack throughput, then the single-scenario trajectory."""
    import bench

    batched, chunk = bench._stack_setup(B)
    out, t_compile = _timed(chunk, batched)
    t0 = time.perf_counter()
    for _ in range(chunks):
        out = chunk(out)
    _block(out)
    t_chunk = (time.perf_counter() - t0) / chunks
    check(bool(np.isfinite(np.asarray(out.pos)).all()), "non-finite batch")

    traj = stack_trajectory(traj_steps)
    drift = np.abs(traj - ref_traj)
    z_drift = float(np.abs(traj[-1][:, 2] - ref_traj[-1][:, 2]).max())
    order = bool((np.argsort(traj[-1][:, 2])
                  == np.argsort(ref_traj[-1][:, 2])).all())
    check(drift.max() < STACK_MAX_DRIFT, f"max drift {drift.max():.3e} m")
    check(z_drift < STACK_Z_DRIFT, f"final height drift {z_drift:.3e} m")
    check(order, "final stack order differs from the f64 reference")
    return {"compile_s": t_compile, "steady_s_per_chunk": t_chunk,
            "scenario_steps_per_s": B * 10 / t_chunk, "B": B,
            "max_drift_m": float(drift.max()), "final_z_drift_m": z_drift,
            "order_match": order}


def phase_table(ref_traj, n_steps=TABLE_STEPS):
    from moby_tpu.io import mobyxml

    scene, st, _ = mobyxml.load(TABLE_XML)
    run, st = _trajectory(scene, st, n_steps, TABLE_DT, "q_art")
    _, t_compile = _timed(run, st)
    q, t_steady = _timed(run, st)
    drift = np.abs(np.asarray(q, np.float64) - ref_traj).max(axis=1)
    i02 = min(199, n_steps - 1)
    check(drift[i02] < TABLE_DRIFT_02S, f"q drift @0.2s {drift[i02]:.3e}")
    check(drift.max() < TABLE_DRIFT_MAX, f"q drift {drift.max():.3e} rad")
    return {"compile_s": t_compile, "steady_s": t_steady,
            "drift_0.2s_rad": float(drift[i02]),
            "drift_max_rad": float(drift.max())}


def phase_driver(B=512, max_time=0.2, scene_xml=BOX_XML):
    """The driver CLI in-process; its `[timing]` lines give the steady
    per-iteration time, its first iteration includes the compile."""
    from moby_tpu.cli import driver

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = driver.main(["-or", f"-b={B}", f"-mt={max_time}", scene_xml])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    check(rc == 0, f"driver returned {rc}: {text[-500:]}")
    done = re.search(r"done: (\d+) iterations to t=([0-9.eE+-]+)", text)
    check(done is not None, f"driver printed no summary: {text[-500:]}")
    iters, t_end = int(done.group(1)), float(done.group(2))
    check(np.isfinite(t_end) and t_end >= max_time,
          f"driver stopped at t={t_end}")
    timing = [float(m) for m in re.findall(r"\[timing\] ([0-9.eE+-]+) s/iter",
                                           text)]
    steady = None
    if len(timing) >= 2:  # cumulative means at iterations 100 and 200
        steady = (timing[1] * 200 - timing[0] * 100) / 100
    return {"wall_s_incl_compile": wall, "iterations": iters,
            "steady_s_per_iter": steady, "B": B, "t_end": t_end}


def phase_ballpush(ref_costs, B=1536, reps=3, n_iters=MPC_ITERS, H=50):
    import jax

    import bench
    from moby_tpu.mpc import contact_mpc

    prob, batched, cost, cost_final, us0 = bench._ballpush_setup(B, H)
    sweep = jax.jit(lambda s: contact_mpc.solve_batch(
        prob, s, cost, cost_final, us0=us0, n_iters=n_iters).cost)
    costs, t_compile = _timed(sweep, batched)
    t0 = time.perf_counter()
    for _ in range(reps):
        costs = sweep(batched)
    _block(costs)
    t_solve = (time.perf_counter() - t0) / reps
    costs = np.asarray(costs, np.float64)
    check(bool(np.isfinite(costs).all()), "non-finite member cost")
    k = len(ref_costs)
    mean, ref_mean = float(costs[:k].mean()), float(np.mean(ref_costs))
    gap = abs(mean - ref_mean) / max(abs(ref_mean), 1e-12)
    check(gap < BALLPUSH_MEAN_RTOL,
          f"mean cost {mean:.6g} vs f64 {ref_mean:.6g} (rel {gap:.3e})")
    return {"compile_s": t_compile, "steady_s_per_solve_batch": t_solve,
            "solves_per_s": B / t_solve, "B": B, "mean_cost_8": mean,
            "ref_mean_cost_8": ref_mean, "rel_gap": gap,
            "mean_cost_all": float(costs.mean())}


def phase_pile64(B=8, chunks=5, side=4, pool=256):
    import bench

    n = side ** 3
    scene, batched, n_cand, chunk = bench._pile64_setup(B, side, pool)
    out, t_compile = _timed(chunk, batched)
    t0 = time.perf_counter()
    for _ in range(chunks):
        out = chunk(out)
    _block(out)
    t_chunk = (time.perf_counter() - t0) / chunks
    pos = np.asarray(out.pos)
    check(bool(np.isfinite(pos).all()), "non-finite pile positions")
    zmin = float(pos[:, :n, 2].min())
    check(zmin > 0.45, f"a sphere sank to z={zmin:.3f}")
    return {"compile_s": t_compile, "steady_s_per_chunk": t_chunk,
            "scenario_steps_per_s": B * 10 / t_chunk, "B": B,
            "lcp_n": int(scene.n_lcp), "candidates": n_cand, "min_z": zmin}


def phase_four_cards(B_per=1536, n_cards=4, n_iters=MPC_ITERS, H=50):
    """Ball-push sweep sharded over a 1-D `scenario` mesh, against the same
    slices solved one after another on card 0 at identical shapes."""
    import jax

    import bench
    from moby_tpu.mpc import contact_mpc
    from moby_tpu.parallel import mesh as pmesh

    devs = jax.devices()
    check(len(devs) >= n_cards, f"{len(devs)} devices, need {n_cards}")
    mesh = pmesh.scenario_mesh(n_cards)
    prob, batched, cost, cost_final, us0 = bench._ballpush_setup(
        n_cards * B_per, H)
    sharded = pmesh.shard_batch(mesh, batched)

    def sweep_sharded():
        return pmesh.sharded_mpc_sweep(prob, sharded, cost, cost_final, mesh,
                                       n_iters=n_iters, us0=us0).cost

    res, t_first = _timed(sweep_sharded)
    res, t_second = _timed(sweep_sharded)
    shard_rows = {s.device.id: s.data.shape[0] for s in res.addressable_shards}
    check(sorted(shard_rows) == sorted(d.id for d in devs[:n_cards]),
          f"result shards on devices {sorted(shard_rows)}")
    check(all(r == B_per for r in shard_rows.values()),
          f"shard rows {shard_rows}")

    one = jax.jit(lambda s: contact_mpc.solve_batch(
        prob, s, cost, cost_final, us0=us0, n_iters=n_iters).cost)
    seq, t_seq = [], []
    for i in range(n_cards):
        sl = jax.device_put(
            jax.tree_util.tree_map(
                lambda x: np.asarray(x[i * B_per:(i + 1) * B_per]), batched),
            devs[0])
        c, t = _timed(one, sl)
        seq.append(np.asarray(c, np.float64))
        t_seq.append(t)
    seq = np.concatenate(seq)
    got = np.asarray(res, np.float64)
    check(bool(np.isfinite(got).all()), "non-finite sharded cost")
    err = np.abs(got - seq) / (1.0 + np.abs(seq))
    check(float(err.max()) <= SHARD_RTOL,
          f"sharded vs card-0 costs differ by {float(err.max()):.3e}")
    return {"first_call_s_incl_compile": t_first,
            "second_call_s": t_second,
            "card0_compile_plus_first_s": t_seq[0],
            "card0_steady_s_per_slice": float(np.mean(t_seq[1:]))
            if n_cards > 1 else None,
            "B_total": n_cards * B_per, "shard_rows": shard_rows,
            "max_rel_err": float(err.max()),
            "mean_cost": float(got.mean())}


# ---------------------------------------------------------------------------


def _header(dev):
    import jax
    import jaxlib

    from moby_tpu import config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        print(f"nvidia-smi: {line}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"matmul precision: {jax.config.jax_default_matmul_precision}")
    print(f"compile cache: {config.use_compile_cache()}")
    print(f"device: {dev.device_kind} x{len(jax.devices())}", flush=True)


def _run_phase(name, fn, *args, results, failed):
    print(f"[{name}] start", flush=True)
    try:
        r = fn(*args)
    except Exception:  # noqa: BLE001 — report every phase, then fail
        traceback.print_exc()
        print(f"[{name}] FAILED", flush=True)
        failed.append(name)
        return
    results[name] = r
    print(f"[{name}] ok {json.dumps(r, default=str)}", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    dev = require_gpu()
    import jax

    _header(dev)
    results, failed = {}, []
    if four:
        _run_phase("four_cards", phase_four_cards,
                   results=results, failed=failed)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            ref_path = os.path.join(tmp, "ref.npz")
            child = start_cpu_reference(ref_path)
            try:
                _run_phase("precision", phase_precision,
                           results=results, failed=failed)
                _run_phase("driver", phase_driver,
                           results=results, failed=failed)
                _run_phase("pile64", phase_pile64,
                           results=results, failed=failed)
                rc = child.wait(timeout=900)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
            if rc != 0:
                print(f"[reference] CPU f64 child exited {rc}", flush=True)
                failed.append("reference")
            else:
                ref = dict(np.load(ref_path))
                _run_phase("stack", phase_stack, ref["stack"],
                           results=results, failed=failed)
                _run_phase("table", phase_table, ref["table"],
                           results=results, failed=failed)
                _run_phase("ballpush", phase_ballpush, ref["ballpush"],
                           results=results, failed=failed)
    if failed:
        print(f"FAILED phases: {failed}", flush=True)
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
