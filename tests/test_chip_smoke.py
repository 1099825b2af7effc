"""chip_smoke.py's phases at tiny sizes on the CPU, each against a
reference computed the way its CPU child computes it, plus its refusal to
run without a GPU. (On the CPU in x64 both sides run in f64, so these check
the plumbing and the checks, not the f32/f64 gap.)"""

import jax
import numpy as np
import pytest

import chip_smoke


def test_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_phase_precision():
    r = chip_smoke.phase_precision()
    assert r["rel_err"] < 1e-6 and r["matmul_precision"] == "highest"


def test_phase_stack_tiny():
    ref = chip_smoke.stack_trajectory(5)
    r = chip_smoke.phase_stack(ref, B=2, chunks=1, traj_steps=5)
    assert r["order_match"] and r["max_drift_m"] < 1e-9


def test_phase_stack_catches_drift():
    ref = chip_smoke.stack_trajectory(5).copy()
    ref[:, :, 2] += 0.1
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.phase_stack(ref, B=2, chunks=1, traj_steps=5)


def test_phase_table_tiny():
    ref = chip_smoke.table_trajectory(5)
    r = chip_smoke.phase_table(ref, n_steps=5)
    assert r["drift_max_rad"] < 1e-9


def test_phase_driver_tiny():
    r = chip_smoke.phase_driver(B=2, max_time=0.005)
    assert r["iterations"] >= 5 and r["t_end"] >= 0.005


def test_phase_ballpush_tiny():
    ref = chip_smoke.ballpush_member_costs(3, n_members=2, n_iters=1, H=5)
    r = chip_smoke.phase_ballpush(ref, B=3, reps=1, n_iters=1, H=5)
    assert r["rel_gap"] < 1e-9 and np.isfinite(r["mean_cost_all"])


def test_phase_pile_tiny():
    r = chip_smoke.phase_pile64(B=1, chunks=1, side=2, pool=8)
    assert r["min_z"] > 0.45 and r["candidates"] == 28


def test_phase_four_cards_virtual():
    assert len(jax.devices()) >= 4
    r = chip_smoke.phase_four_cards(B_per=2, n_cards=4, n_iters=1, H=5)
    assert sorted(r["shard_rows"].values()) == [2, 2, 2, 2]
    assert r["max_rel_err"] <= chip_smoke.SHARD_RTOL
