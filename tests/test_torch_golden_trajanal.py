"""The port's controller-side trajectory analysis held to the compiled
reference TrajAnal's goldens (tests/golden/trajanal: `a`, `b`, `c`),
port only, float64 on the CPU, with tests/test_trajanal_parity.py's
tolerances: `control/tracked_traj.py::build_tracked_traj` on the same
2048-step grid, the duration within 1e-12 relative, and at every query
time `pstate`'s yaw within 1e-10, `vstate` within 1e-10, `astate`
within 1e-9 and the Simpson-integrated position within 1e-5 m.
"""
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.control.tracked_traj import (
    astate, build_tracked_traj, pstate, vstate)
from alore_legged_manipulator_tpu_torch.planner.flat_traj import Polynome
from tests import torch_golden_io as gio

torch.set_num_threads(1)


def query(name, dtype=torch.float64, device="cpu"):
    """(golden duration, duration, golden rows (M, 8), pose (M, 3),
    velocity (M, 2), acceleration (M, 2))."""
    ini, fin, inner, times, start, icr, dur, rows = gio.trajanal_case(name)

    def t(a):
        return torch.tensor(np.asarray(a)[None], dtype=dtype, device=device)
    msg = Polynome(traj_start_time=t(0.0), inner_points=t(inner),
                   piece_times=t(times), init_state=t(ini),
                   tail_state=t(fin), start_position=t(start), icr=t(icr))
    tt = build_tracked_traj(msg, n_grid=2048)
    ts = t(rows[:, 0])
    out = (pstate(tt, ts), vstate(tt, ts), astate(tt, ts))
    return (dur, float(tt.duration[0]), rows,
            *(o[0].to(torch.float64).cpu().numpy() for o in out))


def trajanal_checks(name, device="cpu"):
    dur_ref, dur, rows, p, v, a = query(name, device=device)
    assert len(rows) > 0
    return [gio.deviation(f"{name} duration", dur, dur_ref, 0.0, 1e-12),
            gio.deviation(f"{name} yaw", p[:, 2], rows[:, 3], 1e-10),
            gio.deviation(f"{name} velocities", v, rows[:, 4:6], 1e-10),
            gio.deviation(f"{name} accelerations", a, rows[:, 6:8], 1e-9),
            gio.deviation(f"{name} xy", p[:, :2], rows[:, 1:3], 1e-5)]


@pytest.mark.parametrize("name", gio.TRAJANAL_CASES)
def test_tracked_traj_matches_trajanal(name):
    gio.assert_checks(trajanal_checks(name))
