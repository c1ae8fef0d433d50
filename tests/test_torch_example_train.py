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
  artifact restores its export (`highlevel_physics_1500.npz`): its
  parameters equal the orbax checkpoint's and its mean actions the JAX
  actor's on a seeded batch of contact-plant histories within 1e-5
  (`tests/test_torch_models.py`'s tolerance for the 6000 one).  An
  orbax directory with no export raises.
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


def test_unexported_artifact_raises(tmp_path):
    """An orbax checkpoint the port has no export of (a copy of the 1500
    one under another name) is not a port checkpoint: it raises."""
    import shutil
    other = tmp_path / "ckpt_physics_3000"
    shutil.copytree(ARTIFACTS / "ckpt_physics_1500" / "step_1500",
                    other / "step_3000")
    with pytest.raises(FileNotFoundError):
        twin.restore(str(other), 3000, "cpu")


def test_jax_1500_artifact_restores_the_jax_actor():
    import jax
    import jax.numpy as jnp
    from alore_legged_manipulator_tpu.models.actor_critic import (
        PhysicActorCritic as JAC)
    from alore_legged_manipulator_tpu.models.gnn import (
        build_interaction_graph as j_build)
    from alore_legged_manipulator_tpu_torch.models.gnn import GraphBatch
    from tests.export_highlevel_weights import (checkpoint_path,
                                                restore_params)
    from tests.test_torch_models import _contact_env_inputs

    got, step = twin.restore(str(ARTIFACTS / "ckpt_physics_1500"), 1500,
                             "cpu")
    assert step == 1500 and set(got) == {"actor"}
    jparams = restore_params(checkpoint_path(1500))["actor"]
    flat = flatten_flax(flax_from_state_dict(got["actor"].state_dict()))
    ref = flatten_flax(jparams)
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)
    obs, feats = _contact_env_inputs()
    g = jax.vmap(j_build)(*feats)
    jm, _, jv = (np.asarray(a) for a in
                 JAC().apply(jparams, jnp.asarray(obs), g))
    with torch.no_grad():
        m, _, v = got["actor"](
            torch.as_tensor(obs),
            GraphBatch(torch.as_tensor(np.asarray(g.nodes)),
                       torch.as_tensor(np.asarray(g.edge_attr))))
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-5, atol=1e-5)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        twin.main(["--iters", "1", "--num-envs", "30"])
