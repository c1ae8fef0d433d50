"""Port parity, whole slice: the composed planner simulation under the
LTV-MPC (`runtime/planner_sim.py::run_planner_sim`, tracker="ltv",
perspective fusion).

The `corridor` golden of the compiled reference loop
(tests/golden/e2e_oracle/goldens) cut to its first simulated second,
float64 on the CPU, through the JAX package and the port.  The
configurations are the config defaults with tests/test_e2e_parity.py's
overrides (standard_diff back end, piece buckets (4, 8, 16, 24)): its
yaml profiles are not in the repository, and tests/test_profiles.py pins
the defaults to them.

* Port against JAX: the 1 kHz gate attempts, the plan ticks and their
  trajectory starts are equal (host float64 clocks on both sides), so
  are the piece counts and the FSM edges with their times.  The truth
  poses, the commands and the EKF trace agree within about three times
  the gaps measured (pose 9.3e-3 m, commands 0.032, EKF pose 9.1e-3 and
  ICR 1.3e-5): 0.03 m, 0.1 and 0.03 / 1e-4.  The gaps come from the back
  end, not the loop: from the same front-end input the MINCO back end is
  chaotic at float64 (ROADMAP.md section 3; the plans' inner points end
  up to 14 cm apart), and the tracker follows whichever plan it gets.
* Port against the golden, with tests/test_e2e_parity.py's bands on the
  prefix: every golden plan tick is a gate attempt, the plan sets match
  up to three skips, trajectory starts are exact, the truth-pose
  deviation stays inside the 0.15 m mean and 0.45 m max band, no pose
  enters an occupied cell, the FSM edges are the golden's, the opening
  commands agree to 1e-2 and the prefix's to 0.1 / 0.2, and the EKF's
  cold-start rows to 1e-9.  (The prefix holds 99 commands and no EKF row
  past the 200th, which that file's stream and estimator bands start
  from.)
* The popup branch, on a scenario derived from the `popup` golden (not
  the golden itself): the obstacle dropped at 0.3 s instead of 4 s, run
  to 0.5 s, port against JAX only (gaps seen: pose 2.6e-3 m, commands
  0.028, EKF 2.2e-3; held to 0.01, 0.1, 0.01), no pose inside an
  occupied cell, popup included once it is there.
"""
import gzip
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.control.ltv_mpc import LtvMpcConfig
from alore_legged_manipulator_tpu.mission.plan_manager import (
    PlanManagerConfig)
from alore_legged_manipulator_tpu.planner.backend import BackendConfig
from alore_legged_manipulator_tpu.planner.frontend import FrontendConfig
from alore_legged_manipulator_tpu.runtime import planner_sim as jps
from alore_legged_manipulator_tpu.world.lidar import OccupancyConfig
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.runtime import planner_sim as tps
from tests.test_e2e_parity import _match_ticks

torch.set_num_threads(1)

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden" / "e2e_oracle" / \
    "goldens"
# oracle StateMachine (plan_manager.hpp:26) -> PlanState name
STATE_NAMES = {1: "IDLE", 2: "PLANNING", 3: "REPLAN", 4: "GOING_TO_GOAL",
               5: "EMERGENCY_STOP"}

_RUNS = {}


def load_golden(name):
    with gzip.open(GOLDEN_DIR / f"{name}.json.gz", "rt") as f:
        return json.load(f)


def run_both(golden_name, sim_T, tracker, **scn_kw):
    """(golden, scenario, JAX trace, port trace) at float64, cached."""
    key = (golden_name, sim_T, tracker, tuple(sorted(scn_kw.items())))
    if key not in _RUNS:
        golden = load_golden(golden_name)
        scn = jps.E2EScenario.from_golden(golden["scenario"])
        scn.sim_T = sim_T
        for k, v in scn_kw.items():
            setattr(scn, k, v)
        cfg = PlanManagerConfig(
            replan_period=scn.replan_time,
            max_replan_time=scn.max_replan_time,
            backend=BackendConfig(standard_diff=True),
            frontend=FrontendConfig(piece_buckets=(4, 8, 16, 24)),
            dtype=jnp.float64)
        ref = jps.run_planner_sim(scn, cfg, LtvMpcConfig(), OccupancyConfig(),
                                  dtype=jnp.float64, tracker=tracker)
        got = tps.run_planner_sim(
            from_jax_numpy(scn), from_jax_numpy(cfg),
            from_jax_numpy(LtvMpcConfig()), from_jax_numpy(OccupancyConfig()),
            dtype=torch.float64, tracker=tracker, device="cpu")
        _RUNS[key] = (golden, scn, ref, got)
    return _RUNS[key]


def edges(trace):
    return [(t, s.name) for t, s in trace.states]


def assert_port_matches_jax(ref, got, pose_tol, cmd_tol, ekf_tol,
                            icr_tol=1e-4):
    assert got.attempts == ref.attempts
    assert len(got.attempts) >= 5
    for key in ("t", "traj_start", "n_pieces"):
        assert [p[key] for p in got.plans] == [p[key] for p in ref.plans], key
    assert edges(got) == edges(ref)
    assert got.poses.shape == ref.poses.shape
    assert got.cmds.shape == ref.cmds.shape
    assert got.ekf.shape == ref.ekf.shape
    np.testing.assert_array_equal(got.poses[:, 0], ref.poses[:, 0])
    np.testing.assert_array_equal(got.cmds[:, 0], ref.cmds[:, 0])
    np.testing.assert_allclose(got.poses[:, 1:4], ref.poses[:, 1:4], rtol=0,
                               atol=pose_tol)
    # the truth (v, omega) columns are the commands the plant adopted
    np.testing.assert_allclose(got.poses[:, 4:], ref.poses[:, 4:], rtol=0,
                               atol=cmd_tol)
    np.testing.assert_allclose(got.cmds[:, 1:], ref.cmds[:, 1:], rtol=0,
                               atol=cmd_tol)
    np.testing.assert_allclose(got.ekf[:, 1:4], ref.ekf[:, 1:4], rtol=0,
                               atol=ekf_tol)
    np.testing.assert_allclose(got.ekf[:, 4:], ref.ekf[:, 4:], rtol=0,
                               atol=icr_tol)


def assert_cadence_matches_golden(golden, scn, trace, t_end):
    """Every golden plan tick in the prefix is a gate attempt, the plan
    sets match up to three skips, trajectory starts are exact."""
    g_t = [p["t"] for p in golden["plans"] if p["t"] <= t_end]
    t_t = [p["t"] for p in trace.plans]
    att = np.asarray(trace.attempts)
    assert len(g_t) >= 5
    for gt in g_t:
        assert np.min(np.abs(att - gt)) <= 1e-9, gt
    matched, unmatched_g, unmatched_t = _match_ticks(g_t, t_t)
    assert matched >= len(g_t) - 3, (unmatched_g, unmatched_t)
    assert len(unmatched_t) <= 3, unmatched_t
    offs = np.array([p["traj_start"] - p["t"] for p in trace.plans])
    assert abs(offs[0]) < 1e-9
    np.testing.assert_allclose(offs[1:], scn.max_replan_time, atol=1e-9)


def pose_deviation(golden, trace):
    gp = np.array(golden["poses"])
    tp = trace.poses
    n = len(tp)
    np.testing.assert_allclose(gp[:n, 0], tp[:, 0], atol=1e-9)
    return np.hypot(tp[:, 1] - gp[:n, 1], tp[:, 2] - gp[:n, 2])


def assert_free_poses(scn, trace):
    """No truth pose inside an occupied cell (the popup block included
    once it is there)."""
    grid = scn.grid.copy()
    if scn.obs_t >= 0:
        x0, y0, x1, y1 = scn.obs_cells
        grid[x0:x1, y0:y1] = True
    P = trace.poses
    ix = ((P[:, 1] - scn.lower[0]) / scn.res).astype(int).clip(
        0, grid.shape[0] - 1)
    iy = ((P[:, 2] - scn.lower[1]) / scn.res).astype(int).clip(
        0, grid.shape[1] - 1)
    after = P[:, 0] >= (scn.obs_t if scn.obs_t >= 0 else -1.0)
    base = scn.grid[ix, iy]
    assert base.sum() == 0
    assert (grid[ix, iy] & ~base & after).sum() == 0


def assert_fsm_matches_golden(golden, trace, t_end):
    g_edges = [(t, STATE_NAMES[s]) for t, s in golden["states"]
               if s in STATE_NAMES and t <= t_end]
    t_edges = edges(trace)
    assert [s for _, s in t_edges] == [s for _, s in g_edges]
    for (gt, _), (tt, _) in zip(g_edges, t_edges):
        assert abs(gt - tt) <= 1e-6, (gt, tt)


CORRIDOR_T = 1.0


@pytest.fixture(scope="module")
def corridor():
    return run_both("corridor", CORRIDOR_T, "ltv")


def test_corridor_port_matches_jax(corridor):
    _, _, ref, got = corridor
    assert len(got.plans) == 13
    assert_port_matches_jax(ref, got, pose_tol=0.03, cmd_tol=0.1,
                            ekf_tol=0.03)


def test_corridor_cadence_matches_golden(corridor):
    golden, scn, _, got = corridor
    assert_cadence_matches_golden(golden, scn, got, CORRIDOR_T)


def test_corridor_trajectory_matches_golden(corridor):
    golden, scn, _, got = corridor
    dev = pose_deviation(golden, got)
    assert dev.mean() < 0.15, dev.mean()
    assert dev.max() < 0.45, dev.max()
    assert_free_poses(scn, got)


def test_corridor_fsm_matches_golden(corridor):
    golden, _, _, got = corridor
    assert_fsm_matches_golden(golden, got, CORRIDOR_T)


def test_corridor_commands_and_estimates_match_golden(corridor):
    golden, _, _, got = corridor
    gc = np.array(golden["cmds"])
    tc = got.cmds
    n = len(tc)
    assert n >= 99
    np.testing.assert_allclose(tc[:, 0], gc[:n, 0], atol=1e-9)
    dv = np.abs(tc[:, 1] - gc[:n, 1])
    dw = np.abs(tc[:, 2] - gc[:n, 2])
    assert dv[:5].max() < 1e-2 and dw[:5].max() < 1e-2
    assert dv.max() < 0.1, dv.max()
    assert dw.max() < 0.2, dw.max()
    ge = np.array(golden["ekf"])
    np.testing.assert_allclose(got.ekf[:9], ge[:9], atol=1e-9)
    # the estimate tracks this loop's truth from the first odometry on
    m = min(len(got.poses), len(got.ekf))
    err = np.hypot(got.ekf[10:m, 1] - got.poses[10:m, 1],
                   got.ekf[10:m, 2] - got.poses[10:m, 2])
    assert err.max() < 0.12, err.max()


def test_popup_derived_port_matches_jax():
    """The popup branch: the `popup` golden's block dropped at 0.3 s."""
    _, scn, ref, got = run_both("popup", 0.5, "ltv", obs_t=0.3)
    assert scn.obs_t == 0.3
    assert_port_matches_jax(ref, got, pose_tol=0.01, cmd_tol=0.1,
                            ekf_tol=0.01)
    assert_free_poses(scn, got)


def test_planner_sim_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scn = tps.E2EScenario(grid=np.zeros((10, 10), bool), lower=(0.0, 0.0),
                          res=0.1, start=(0.2, 0.2, 0.0),
                          goal=(0.8, 0.8, 0.0), sim_T=0.01)
    with pytest.raises(RuntimeError):
        tps.run_planner_sim(scn, tps.PlanManagerConfig(), tps.LtvMpcConfig())
    with pytest.raises(ValueError):
        tps.run_planner_sim(scn, tps.PlanManagerConfig(), tps.LtvMpcConfig(),
                            tracker="pid", device="cpu")
