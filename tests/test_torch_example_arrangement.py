"""Port parity: the arrangement twin
(`alore_legged_manipulator_tpu_torch/examples/arrangement_mission.py`)
against the JAX package's example, two objects on the kinematic plant.

The JAX run (`examples/arrangement_mission.py --objects 2`: float32,
plant noise on) was recorded once by `tests/arrangement_capture.py` into
`alore_legged_manipulator_tpu_torch/data/arrangement_two_objects.npz`;
this file runs the port alone, as a user would
(`main(["--objects", "2", "--device", "cpu"])`), and holds it to that
record:

* the same visit order, the same task-FSM edge sequence and the same
  delivered flags, every object delivered within tests/test_arrangement.py's
  bounds (0.1 m, p95 0.2 m);
* the first push's front end handed its back end the same FlatTraj bit
  for bit (the approach is host arithmetic; the pushes' noise streams
  differ by design, so later front-end inputs may not);
* the outcomes inside bands of three to four times the JAX-vs-JAX gaps
  seen when the robot's start moves 1e-4 m (the back end is chaotic,
  ROADMAP.md section 3): each final object error within 0.01 m of JAX's
  (gap seen 3.4e-3 m), the worst push p95 within 0.005 m (1.3e-3 m), the
  simulated time within 2 s (0.74 s).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.examples import arrangement_mission
from alore_legged_manipulator_tpu_torch.mission import plan_manager as tpm
from alore_legged_manipulator_tpu_torch.runtime import arrangement as tarr

torch.set_num_threads(1)

RECORD = Path(tarr.__file__).resolve().parents[1] / "data" / \
    "arrangement_two_objects.npz"


def _jax_record():
    with np.load(RECORD) as z:
        summary = json.loads(str(z["summary"]))
        flats = {}
        for k in z.files:
            if k.startswith("flat"):
                i, name = k.split("/")
                flats.setdefault(int(i[4:]), {})[name] = z[k]
    return summary, [flats[i] for i in sorted(flats)]


def test_two_object_mission_matches_jax(monkeypatch):
    ref, ref_flats = _jax_record()
    edges, flats = [], []

    class Fsm(tarr.ObjectFsm):
        def __setattr__(self, key, value):
            if key == "state" and (not edges or edges[-1] != value.name):
                edges.append(value.name)
            super().__setattr__(key, value)

    def frontend(*a, _orig=tpm.plan_frontend, **kw):
        flats.append(_orig(*a, **kw))
        return flats[-1]
    monkeypatch.setattr(tarr, "ObjectFsm", Fsm)
    monkeypatch.setattr(tpm, "plan_frontend", frontend)
    got = arrangement_mission.main(["--objects", "2", "--device", "cpu"])

    assert got["order"] == ref["order"] == [0, 1]
    assert edges == ref["edges"]
    assert got["delivered"] == ref["delivered"] == [True, True]
    assert max(got["final_object_err"]) < 0.1
    assert got["push_tracking_err_p95"] < 0.2
    assert len(flats) == len(ref_flats) == 2
    for name, want in ref_flats[0].items():
        np.testing.assert_array_equal(getattr(flats[0], name).numpy()[0],
                                      want, err_msg=name)
    np.testing.assert_allclose(got["final_object_err"],
                               ref["final_object_err"], rtol=0, atol=0.01)
    assert got["push_tracking_err_p95"] == pytest.approx(
        ref["push_tracking_err_p95"], abs=0.005)
    assert got["sim_time_s"] == pytest.approx(ref["sim_time_s"], abs=2.0)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        arrangement_mission.main(["--objects", "1"])
