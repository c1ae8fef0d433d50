"""The port's planner simulation under the LTV-MPC held to the whole
`corridor_raycast` golden of the compiled reference loop
(occlusion-aware beam scans, raycast fusion), port only, float64 on the
CPU, with tests/test_e2e_parity.py's float64 bands
(tests/torch_e2e_whole.py): cadence, truth-pose deviation (mean 0.15 m,
max 0.45 m or 0.75 m after a skip), goal reached, no pose in an occupied
cell, FSM edges, the first second's command stream and the estimator
trace. One run of the whole golden serves every test.
"""
import pytest

from tests import torch_e2e_whole as w


@pytest.fixture(scope="module")
def run():
    return w.run_port("corridor_raycast", "ltv")


def test_cadence_matches_golden(run):
    golden, scn, trace, _ = run
    w.check_cadence(golden, scn, trace)


def test_trajectory_matches_golden(run):
    golden, scn, trace, _ = run
    max_tol = 0.45 if w._n_skips(trace, golden) == 0 else 0.75
    w.check_trajectory(golden, scn, trace, 0.15, max_tol)


def test_fsm_edges_match_golden(run):
    golden, _, trace, _ = run
    w.check_fsm(golden, trace)


def test_command_stream_matches_golden(run):
    golden, _, trace, _ = run
    w.check_ltv_commands(golden, trace)


def test_estimator_trace_matches_golden(run):
    golden, _, trace, _ = run
    w.check_estimates(golden, trace)
