"""Port parity: the figures (`utils/viz.py`), host only.

tests/test_viz.py's figures built and saved from the port, with tensors
as inputs (the port's batched tracking result, one lane of it), and the
same pixels as the JAX package's module draws from the same numpy data.
Importing the module needs no matplotlib (the card's machine has none).
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)

from alore_legged_manipulator_tpu.utils import viz as jviz  # noqa: E402
from alore_legged_manipulator_tpu_torch.utils import viz  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _occ():
    occ = np.zeros((40, 40), bool)
    occ[15:20, 22:25] = True
    return occ


def _track(T=50):
    xs = np.stack([np.linspace(1, 5, T), np.full(T, 4.0), np.zeros(T)], 1)
    return xs, np.abs(np.sin(np.arange(T) * 0.1)), np.exp(-np.arange(T)
                                                         * 0.05)


def _rgba(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def test_tracking_figure_from_tensors_matches_jax(tmp_path):
    xs, perr, ierr = _track()
    res = types.SimpleNamespace(xytheta=torch.tensor(xs),
                                pos_err=torch.tensor(perr),
                                icr_err=torch.tensor(ierr))
    tt = types.SimpleNamespace(seq=torch.tensor(xs + 0.02))
    fig = viz.tracking_figure(res, tt=tt, occ=torch.tensor(_occ()),
                              lower=(0.0, 0.0), res=0.1)
    out = viz.save_figure(fig, str(tmp_path / "track.png"))
    assert out.endswith("track.png")
    assert (tmp_path / "track.png").stat().st_size > 1000
    ref = jviz.tracking_figure(
        types.SimpleNamespace(xytheta=xs, pos_err=perr, icr_err=ierr),
        tt=types.SimpleNamespace(seq=xs + 0.02), occ=_occ(),
        lower=(0.0, 0.0), res=0.1)
    np.testing.assert_array_equal(_rgba(fig), _rgba(ref))


def test_tracking_figure_of_a_port_result(tmp_path):
    """One lane of the port's batched closed-loop result."""
    from alore_legged_manipulator_tpu_torch.runtime.closed_loop import (
        TrackingResult, simulate_tracking)
    from tests.torch_dist_worker import tick_inputs
    tt, icr, _, _, _ = tick_inputs(1, 8, torch.float64)
    res = simulate_tracking(tt, icr, 20)
    lane = TrackingResult(*(x[0] for x in res))
    fig = viz.tracking_figure(lane, tt=types.SimpleNamespace(seq=tt.seq[0]))
    viz.save_figure(fig, str(tmp_path / "lane.png"))
    assert (tmp_path / "lane.png").stat().st_size > 1000


def test_mission_figure_builds_and_saves(tmp_path):
    items = np.array([[1.0, 1.0], [2.5, 3.0]])
    targets = np.array([[3.0, 1.5], [1.5, 3.5]])
    tracks = [torch.tensor(np.stack([np.linspace(a[0], b[0], 20),
                                     np.linspace(a[1], b[1], 20)], 1))
              for a, b in zip(items, targets)]
    robot = torch.tensor(np.stack([np.linspace(0.5, 3.0, 30),
                                   np.linspace(0.5, 3.0, 30)], 1))
    fig = viz.mission_figure(torch.tensor(_occ()), (0.0, 0.0), 0.1,
                             torch.tensor(items), torch.tensor(targets),
                             object_tracks=tracks, robot_track=robot)
    viz.save_figure(fig, str(tmp_path / "mission.png"))
    assert (tmp_path / "mission.png").stat().st_size > 1000


def test_map_with_esdf_field(tmp_path):
    import matplotlib.pyplot as plt

    yy, xx = np.meshgrid(np.arange(40), np.arange(40))
    dist = torch.tensor(np.hypot(xx - 17, yy - 23) * 0.1)
    fig, ax = plt.subplots()
    viz.plot_map(ax, _occ(), (0.0, 0.0), 0.1, esdf_dist=dist, title="esdf")
    viz.plot_poses(ax, torch.tensor([[1.0, 1.0, 0.0], [2.0, 2.0, 1.0]]),
                   slot=1, every=1)
    viz.save_figure(fig, str(tmp_path / "esdf.png"))
    assert (tmp_path / "esdf.png").stat().st_size > 1000


def test_import_needs_no_matplotlib():
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "from alore_legged_manipulator_tpu_torch.utils import viz\n"
            "print('OK', len(viz.SERIES))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK 6" in out.stdout
