"""Port parity, whole slice: the composed planner simulation under the
real robot's tracker (`run_planner_sim(..., tracker="nmpc")`: the ACADO
RTI NMPC over the wheel path, raycast fusion of occlusion-aware beam
scans, the host f64 scan).

The `nmpc_corridor_raycast` golden of the compiled reference loop cut to
its first half second, float64 on the CPU, through the JAX package and
the port, with the configurations of tests/test_torch_planner_sim.py.

* Port against JAX: gate attempts, plan ticks, trajectory starts, piece
  counts and FSM edges equal; truth poses, wheel commands and the EKF
  trace within about three times the gaps measured (pose 2.7e-3 m,
  wheel commands 0.025, EKF pose 2.6e-3 and ICR 6.1e-7): 0.01 m, 0.08
  and 0.01 / 1e-4 (the plans' inner points end up 10 cm apart from the
  same front-end input: the back end is chaotic at float64, ROADMAP.md
  section 3).
* Port against the golden, with tests/test_e2e_parity_nmpc.py's float64
  bands on the prefix: cadence and trajectory starts, the pose
  deviation's 0.12 m mean and 0.65 m max, no pose in an occupied cell,
  the FSM edges, the wheel stream's cold transient sign for sign where
  the golden is decisive (at most one tick off by more than 0.5) and its
  0.75 max, 0.20 mean and 0.60 p99 band, and the EKF's cold-start rows.
"""
import numpy as np
import pytest

from tests.test_torch_planner_sim import (assert_cadence_matches_golden,
                                          assert_free_poses,
                                          assert_fsm_matches_golden,
                                          assert_port_matches_jax,
                                          pose_deviation, run_both)

NMPC_T = 0.5


@pytest.fixture(scope="module")
def raycast():
    return run_both("nmpc_corridor_raycast", NMPC_T, "nmpc")


def test_raycast_port_matches_jax(raycast):
    _, scn, ref, got = raycast
    assert scn.laser_mode == "raycast"
    assert len(got.plans) == 7
    assert_port_matches_jax(ref, got, pose_tol=0.01, cmd_tol=0.08,
                            ekf_tol=0.01)


def test_raycast_cadence_and_fsm_match_golden(raycast):
    golden, scn, _, got = raycast
    assert_cadence_matches_golden(golden, scn, got, NMPC_T)
    assert_fsm_matches_golden(golden, got, NMPC_T)


def test_raycast_trajectory_matches_golden(raycast):
    golden, scn, _, got = raycast
    dev = pose_deviation(golden, got)
    assert dev.mean() < 0.12, dev.mean()
    assert dev.max() < 0.65, dev.max()
    assert_free_poses(scn, got)


def test_raycast_wheel_stream_matches_golden(raycast):
    golden, _, _, got = raycast
    gc = np.array(golden["cmds"])
    tc = got.cmds
    n = len(tc)
    assert n >= 49
    np.testing.assert_allclose(tc[:, 0], gc[:n, 0], atol=1e-9)
    assert np.abs(tc[:, 1:]).max() <= 3.0 + 1e-6
    dev = np.maximum(np.abs(tc[:, 1] - gc[:n, 1]),
                     np.abs(tc[:, 2] - gc[:n, 2]))
    cold = tc[:, 0] <= 0.105
    assert cold.sum() >= 8
    for col in (1, 2):
        g_col, t_col = gc[:n, col][cold], tc[:, col][cold]
        decisive = np.abs(g_col) > 0.5
        assert np.all(np.sign(g_col[decisive]) == np.sign(t_col[decisive]))
    assert (dev[cold] > 0.5).sum() <= 1, dev[cold]
    assert dev.max() < 0.75, dev.max()
    assert dev.mean() < 0.20, dev.mean()
    assert np.percentile(dev, 99) < 0.60


def test_raycast_estimates_match_golden(raycast):
    golden, _, _, got = raycast
    ge = np.array(golden["ekf"])
    np.testing.assert_allclose(got.ekf[:9], ge[:9], atol=1e-9)
    m = min(len(got.poses), len(got.ekf))
    err = np.hypot(got.ekf[10:m, 1] - got.poses[10:m, 1],
                   got.ekf[10:m, 2] - got.poses[10:m, 2])
    assert err.max() < 0.12, err.max()
