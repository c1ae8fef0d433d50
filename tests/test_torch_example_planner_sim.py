"""Port parity: the planner-simulation twin
(`alore_legged_manipulator_tpu_torch/examples/planner_sim.py`) against
the JAX package's example (`examples/planner_sim.py`), both on the CPU
at the example's float32, with the nearer goal `--goal 3.0 4.5 0.0` (a
2.7-2.9 s trajectory instead of the default's 5-6 s).

* `--noise 0`: the plan manager's front end hands the back end the same
  FlatTraj bit for bit.  The back end is chaotic (ROADMAP.md section 3),
  so the outcomes are held to bands of a few times the JAX-vs-JAX gaps
  seen when the start moves 1e-4 m (five starts, as the example prints
  them): the tracking error's mean, p95 and final value and the goal
  distance within 0.005 m of JAX's (gaps seen up to 0.002 m), the
  trajectory's duration within 0.5 s (0.18 s), the EKF's final ICR error
  within 0.01 (0.002).
* `--noise 0.01` (the port's own noise stream, drawn from a
  torch.Generator seeded 1): finite and inside the same bands of JAX's
  noise-free run; `--plot` writes its figure.
* `--plot` without matplotlib stops before planning, with a clear error;
  without a card the twin raises unless asked for the CPU.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.mission import plan_manager as jpm
from alore_legged_manipulator_tpu_torch.examples import planner_sim
from alore_legged_manipulator_tpu_torch.mission import plan_manager as tpm

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOAL = ["--goal", "3.0", "4.5", "0.0"]
BANDS = {"err_mean": 0.005, "err_p95": 0.005, "err_final": 0.005,
         "goal_dist": 0.005, "duration_s": 0.5, "icr_err": 0.01}


def _recording(mp, mod, out):
    orig = mod.plan_frontend

    def frontend(*a, **kw):
        out.append(orig(*a, **kw))
        return out[-1]
    mp.setattr(mod, "plan_frontend", frontend)


def _parse(text):
    """The quantities the example prints."""
    num = r"(-?[0-9.]+)"
    m = {k: re.search(p, text) for k, p in {
        "duration_s": rf"pieces, {num} s trajectory",
        "err_mean": rf"tracking error: mean {num} m",
        "err_p95": rf"p95 {num} m",
        "err_final": rf"final {num} m",
        "goal_dist": rf"goal distance {num} m",
        "icr_err": rf"EKF ICR error: {num}"}.items()}
    return {k: float(v.group(1)) for k, v in m.items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX example at --noise 0: its printed quantities and its front
    end's outputs."""
    spec = importlib.util.spec_from_file_location(
        "jax_planner_sim", REPO / "examples" / "planner_sim.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    flats, out = [], io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, jpm, flats)
        mp.setattr(sys, "argv", ["planner_sim.py", "--noise", "0"] + GOAL)
        with contextlib.redirect_stdout(out):
            example.main()
    return _parse(out.getvalue()), flats


def _in_bands(got, ref):
    for k, band in BANDS.items():
        assert np.isfinite(got[k]), k
        assert abs(got[k] - ref[k]) <= band, (k, got[k], ref[k])


def test_noise_off_matches_jax(jax_run, monkeypatch):
    ref, ref_flats = jax_run
    flats = []
    _recording(monkeypatch, tpm, flats)
    got = planner_sim.main(["--noise", "0", "--device", "cpu"] + GOAL)
    assert len(flats) == len(ref_flats) == 1
    for name in ref_flats[0]._fields:
        np.testing.assert_array_equal(
            getattr(flats[0], name).numpy()[0],
            np.asarray(getattr(ref_flats[0], name)), err_msg=name)
    _in_bands(got, ref)


def test_noisy_port_stays_in_band(jax_run, tmp_path):
    ref, _ = jax_run
    png = tmp_path / "tracking.png"
    got = planner_sim.main(["--device", "cpu", "--plot", str(png)] + GOAL)
    assert got["ticks"] == int(got["duration_s"] / 0.01) + 100
    assert np.isfinite(got["final_pose"]).all()
    _in_bands(got, ref)
    assert png.stat().st_size > 0


def test_plot_needs_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        planner_sim.main(["--device", "cpu", "--plot",
                          str(tmp_path / "x.png")])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        planner_sim.main([])
