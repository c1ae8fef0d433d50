"""The port's planner simulation held to a whole golden of the compiled
reference loop (tests/golden/e2e_oracle/goldens), port only, float64 on
the CPU, with the bands of tests/test_e2e_parity.py (LTV-MPC) and
tests/test_e2e_parity_nmpc.py (NMPC).

`run_port(name, tracker)` runs one golden over its whole length once per
process, with the configurations of
tests/test_torch_planner_sim.py::run_both (config defaults, the
standard_diff back end, piece buckets (4, 8, 16, 24)); the `check_*`
functions are the JAX tests' checks on the port's trace.
"""
import gzip
import json
import pathlib
import time

import numpy as np
import torch

from alore_legged_manipulator_tpu_torch.control.ltv_mpc import LtvMpcConfig
from alore_legged_manipulator_tpu_torch.mission.plan_manager import (
    PlanManagerConfig)
from alore_legged_manipulator_tpu_torch.planner.backend import BackendConfig
from alore_legged_manipulator_tpu_torch.planner.frontend import (
    FrontendConfig)
from alore_legged_manipulator_tpu_torch.runtime.planner_sim import (
    E2EScenario, run_planner_sim)
from alore_legged_manipulator_tpu_torch.world.lidar import OccupancyConfig
from tests.test_e2e_parity import _n_skips
from tests.test_torch_planner_sim import (STATE_NAMES,
                                          assert_cadence_matches_golden,
                                          assert_free_poses)

torch.set_num_threads(1)

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden" / "e2e_oracle" / \
    "goldens"
_RUNS = {}


def run_port(name, tracker):
    """(golden, scenario, trace, wall seconds) of the whole golden."""
    if name not in _RUNS:
        with gzip.open(GOLDEN_DIR / f"{name}.json.gz", "rt") as f:
            golden = json.load(f)
        scn = E2EScenario.from_golden(golden["scenario"])
        cfg = PlanManagerConfig(
            replan_period=scn.replan_time,
            max_replan_time=scn.max_replan_time,
            backend=BackendConfig(standard_diff=True),
            frontend=FrontendConfig(piece_buckets=(4, 8, 16, 24)),
            dtype=torch.float64)
        t0 = time.perf_counter()
        trace = run_planner_sim(scn, cfg, LtvMpcConfig(), OccupancyConfig(),
                                dtype=torch.float64, tracker=tracker,
                                device="cpu")
        _RUNS[name] = (golden, scn, trace, time.perf_counter() - t0)
    return _RUNS[name]


def check_cadence(golden, scn, trace):
    """Every golden plan tick is a gate attempt, the plan sets match up
    to three skips either way, the golden's and the port's trajectories
    start at the plan tick, then max_replan_time after it."""
    assert len(golden["plans"]) >= 10
    assert_cadence_matches_golden(golden, scn, trace, np.inf)
    offs = np.array([p["traj_start"] - p["t"] for p in golden["plans"]])
    assert abs(offs[0]) < 1e-9
    np.testing.assert_allclose(offs[1:], scn.max_replan_time, atol=1e-9)


def pose_deviation(golden, trace):
    gp = np.array(golden["poses"])
    tp = trace.poses
    n = min(len(gp), len(tp))
    np.testing.assert_allclose(gp[:n, 0], tp[:n, 0], atol=1e-9)
    return np.hypot(tp[:n, 1] - gp[:n, 1], tp[:n, 2] - gp[:n, 2])


def check_trajectory(golden, scn, trace, mean_tol, max_tol):
    """Truth-pose deviation from the golden within the band, the goal
    reached (0.15 m) where the golden ended (0.2 m), no pose in an
    occupied cell."""
    dev = pose_deviation(golden, trace)
    assert dev.mean() < mean_tol, dev.mean()
    assert dev.max() < max_tol, dev.max()
    final = trace.poses[-1, 1:3]
    assert np.hypot(*(final - np.asarray(scn.goal[:2]))) < 0.15
    assert np.hypot(*(final - np.asarray(golden["poses"][-1][1:3]))) < 0.2
    assert_free_poses(scn, trace)


def check_fsm(golden, trace):
    """The golden's FSM edge sequence; IDLE / PLANNING / REPLAN edges of
    the first second on the same tick, the others within 0.6 s."""
    g_edges = [(t, STATE_NAMES[s]) for t, s in golden["states"]
               if s in STATE_NAMES]
    t_edges = [(t, s.name) for t, s in trace.states]
    assert [s for _, s in t_edges] == [s for _, s in g_edges], \
        (t_edges, g_edges)
    for (gt, gs), (tt, _) in zip(g_edges, t_edges):
        tol = 1e-6 if gs in ("IDLE", "PLANNING", "REPLAN") and gt < 1.0 \
            else 0.6
        assert abs(gt - tt) <= tol, (gt, tt, gs)


def check_ltv_commands(golden, trace):
    """The published (v, omega) stream: the opening commands within
    1e-2, the first second's within 0.1 / 0.2."""
    gc = np.array(golden["cmds"])
    tc = trace.cmds
    n = min(len(gc), len(tc))
    assert n >= 100
    np.testing.assert_allclose(tc[:n, 0], gc[:n, 0], atol=1e-9)
    dv = np.abs(tc[:n, 1] - gc[:n, 1])
    dw = np.abs(tc[:n, 2] - gc[:n, 2])
    assert dv[:5].max() < 1e-2 and dw[:5].max() < 1e-2
    assert dv[:100].max() < 0.1, dv[:100].max()
    assert dw[:100].max() < 0.2, dw[:100].max()


def check_wheel_stream(golden, trace):
    """The published (v_r, v_l) stream over the whole mission: the cold
    transient sign for sign where the golden is decisive (at most one
    tick off by more than 0.5), then max 0.75, mean 0.20, p99 0.60."""
    gc = np.array(golden["cmds"])
    tc = trace.cmds
    n = min(len(gc), len(tc))
    assert n >= 100
    np.testing.assert_allclose(tc[:n, 0], gc[:n, 0], atol=1e-9)
    assert np.abs(tc[:, 1:]).max() <= 3.0 + 1e-6
    dev = np.maximum(np.abs(tc[:n, 1] - gc[:n, 1]),
                     np.abs(tc[:n, 2] - gc[:n, 2]))
    cold = tc[:n, 0] <= 0.105
    assert cold.sum() >= 8
    for col in (1, 2):
        g_col, t_col = gc[:n, col][cold], tc[:n, col][cold]
        decisive = np.abs(g_col) > 0.5
        assert np.all(np.sign(g_col[decisive]) == np.sign(t_col[decisive])), \
            (g_col, t_col)
    assert (dev[cold] > 0.5).sum() <= 1, dev[cold]
    assert dev.max() < 0.75, dev.max()
    assert dev.mean() < 0.20, dev.mean()
    assert np.percentile(dev, 99) < 0.60, np.percentile(dev, 99)


def check_estimates(golden, trace):
    """The EKF stream: cold-start rows to 1e-9, from the 200th row on
    within the trajectory band of the golden's estimate (0.45 m, 0.75 m
    after a skip) and within 0.12 m of the port's own truth."""
    ge = np.array(golden["ekf"])
    te = trace.ekf
    n = min(len(ge), len(te))
    np.testing.assert_allclose(te[:9], ge[:9], atol=1e-9)
    dev = np.hypot(te[:n, 1] - ge[:n, 1], te[:n, 2] - ge[:n, 2])
    band = 0.45 if _n_skips(trace, golden) == 0 else 0.75
    assert dev[200:].max() < band, dev[200:].max()
    P = trace.poses
    m = min(len(P), len(te))
    err = np.hypot(te[:m, 1] - P[:m, 1], te[:m, 2] - P[:m, 2])
    assert err[200:].max() < 0.12, err[200:].max()
