"""The port's planner simulation under the NMPC held to the whole
`nmpc_corridor` golden of the compiled reference loop (perspective
fusion), port only, float64 on the CPU, with
tests/test_e2e_parity_nmpc.py's float64 bands
(tests/torch_e2e_whole.py): cadence, truth-pose deviation (mean 0.12 m,
max 0.65 m), goal reached, no pose in an occupied cell, FSM edges, the
whole wheel-command stream and the estimator trace. One run of the whole
golden serves every test.
"""
import pytest

from tests import torch_e2e_whole as w


@pytest.fixture(scope="module")
def run():
    return w.run_port("nmpc_corridor", "nmpc")


def test_cadence_matches_golden(run):
    golden, scn, trace, _ = run
    w.check_cadence(golden, scn, trace)


def test_trajectory_matches_golden(run):
    golden, scn, trace, _ = run
    w.check_trajectory(golden, scn, trace, 0.12, 0.65)


def test_fsm_edges_match_golden(run):
    golden, _, trace, _ = run
    w.check_fsm(golden, trace)


def test_wheel_stream_matches_golden(run):
    golden, _, trace, _ = run
    w.check_wheel_stream(golden, trace)


def test_estimator_trace_matches_golden(run):
    golden, _, trace, _ = run
    w.check_estimates(golden, trace)
