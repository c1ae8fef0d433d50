"""The training-and-deploy twin
(`alore_legged_manipulator_tpu_torch/examples/train_and_deploy_highlevel.py`)
at a tiny size on the CPU.

* `--iters 1 --num-envs 30 --csv --ckpt-dir`, with `--physics` (the
  contact plant) and without (the surrogate env): the learning
  curve has the JAX example's columns (the header of its own
  `examples/artifacts/train_physics_6000.csv`) and one row a iteration,
  and the checkpoint is `step_1.npz`.  (30 lanes: both runners take a
  multiple of 3, one lane a class.)
* `--load-ckpt` of that directory restores the trained parameters bit for
  bit and trains nothing.
* `--load-ckpt examples/artifacts/ckpt_physics_6000`, the JAX example's
  orbax artifact, restores the shipped 6000-iteration actor
  (`models/weights/highlevel_physics_6000.npz`); with it the whole
  script runs as the example does (256-lane eval, bus mission) and the
  mission is delivered within the example's 0.5 m.  The 1500-iteration
  artifact has no exported weights and raises.
* The bus mission of the two tiny runs, whose policy has trained one
  iteration, is cut to 50 ticks (it would run its 20000).
* Without a card the twin raises unless asked for the CPU.
"""
import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.examples import (
    train_and_deploy_highlevel as twin)
from alore_legged_manipulator_tpu_torch.models.torch_convert import (
    HIGHLEVEL_PHYSICS_6000, flatten_flax, flax_from_state_dict, load_flax_npz)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "examples" / "artifacts"


def _cut_mission(monkeypatch, ticks):
    orig = twin.bus_mission
    monkeypatch.setattr(twin, "bus_mission",
                        lambda *a, **kw: orig(*a, **kw, max_ticks=ticks))


def _state(params):
    return {f"{name}.{k}": v.clone() for name, m in params.items()
            for k, v in m.state_dict().items()}


@pytest.mark.parametrize("physics", [True, False])
def test_train_csv_checkpoint_and_reload(physics, tmp_path, monkeypatch):
    _cut_mission(monkeypatch, 50)
    csv_path, ckpt = tmp_path / "curve.csv", tmp_path / "ckpt"
    env = ["--physics"] if physics else []
    first = twin.main(["--iters", "1", "--num-envs", "30", "--csv",
                       str(csv_path), "--ckpt-dir", str(ckpt), "--device",
                       "cpu"] + env)
    with open(csv_path) as f:
        rows = list(csv.reader(f))
    with open(ARTIFACTS / "train_physics_6000.csv") as f:
        jax_header = next(csv.reader(f))
    assert rows[0] == jax_header
    assert len(rows) == 2 and rows[1][0] == "0"
    assert np.isfinite([float(x) for x in rows[1][1:]]).all()
    assert float(rows[1][rows[0].index("mean_reward")]) == \
        first["history"][0]["mean_reward"]
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_1.npz"]
    assert np.isfinite(first["eval_err"]).all()
    assert first["mission_ticks"] == 50 and not first["ok"]

    again = twin.main(["--iters", "1", "--load-ckpt", str(ckpt),
                       "--device", "cpu"] + env)
    assert again["history"] == [] and "train_wall_s" not in again
    want, got = _state(first["params"]), _state(again["params"])
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert again["eval_err"] == first["eval_err"]


def test_jax_artifact_restores_the_shipped_actor():
    got = twin.main(["--physics", "--load-ckpt",
                     str(ARTIFACTS / "ckpt_physics_6000"), "--device", "cpu"])
    assert set(got["params"]) == {"actor"}
    flat = flatten_flax(flax_from_state_dict(
        got["params"]["actor"].state_dict()))
    ref = flatten_flax(load_flax_npz(HIGHLEVEL_PHYSICS_6000))
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)
    assert np.isfinite(got["eval_err"]).all()
    assert got["ok"] and got["mission_state"] == "DONE"
    assert got["mission_err"] < 0.5


def test_unexported_artifact_raises():
    with pytest.raises(FileNotFoundError):
        twin.restore(str(ARTIFACTS / "ckpt_physics_1500"), 1500, "cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        twin.main(["--iters", "1", "--num-envs", "30"])
