"""Port parity: data-parallel PPO training, `train(cfg, mesh=...)`.

The twin of tests/test_train_sharded.py on gloo ranks on the CPU
(tests/torch_dist_worker.py), on that test's `_cfg()` (24 lanes x 6
steps, 2 iterations, 2 minibatches, seed 7), at float64:

* 2 ranks against one process from the same initial parameters and
  seeds: every metric of the history and every parameter within 1e-9
  (the same program, partitioned; only the summation order differs);
* the parameters bit for bit the same on both ranks, each rank stepping
  12 of the 24 lanes, and only rank 0 writing checkpoints;
* on a one-rank mesh, the single-device run to the last bit; the dry
  run's training check (contact plant, f64) on 2 ranks;
* 2 ranks with the JAX package's draws injected (initial states, the
  action noise and fresh episodes of every lane at every step, the
  permutations of each update, from the key sequence of its `train`)
  against the JAX package's `train(_cfg())` itself at float64: the
  history within 1e-9 relative and the parameters within 1e-8, as
  tests/test_torch_runner.py holds one iteration.
"""
import jax
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.rl import runner as jrun
from alore_legged_manipulator_tpu.rl.ppo import PpoConfig as JPpo
from alore_legged_manipulator_tpu_torch.models.torch_convert import (
    state_dict_from_flax)
from tests.test_torch_runner import (_f64, _np, _reset_one, jax_iteration,
                                     port_states)
from tests.torch_dist_worker import launch, run_ranks, train_cfg, train_f64

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """Two ranks training, and one process beside them."""
    tmp = tmp_path_factory.mktemp("train_sharded")
    ranks = launch("train", 2, tmp, over={
        "checkpoint_dir": str(tmp / "ckpt"), "checkpoint_every": 1})
    single = train_f64(train_cfg())
    return ranks.results(), single, tmp


def test_sharded_training_matches_single_process(sharded_run):
    r, (hist, params, lanes, _), _ = sharded_run
    assert lanes == [24, 24]
    for x in r:
        assert len(x["hist"]) == len(hist) == 2
        for h1, h2 in zip(hist, x["hist"]):
            for k in h1:
                np.testing.assert_allclose(h2[k], h1[k], rtol=1e-9,
                                           atol=1e-12, err_msg=k)
        for k in params:
            for n, v in params[k].items():
                np.testing.assert_allclose(x["params"][k][n].numpy(),
                                           v.numpy(), rtol=1e-9, atol=1e-9,
                                           err_msg=f"{k}.{n}")


def test_sharded_training_actually_shards(sharded_run):
    r, _, tmp = sharded_run
    assert [x["lanes"] for x in r] == [[12, 12], [12, 12]]
    for k, sd in r[0]["params"].items():
        for n, v in sd.items():
            assert torch.equal(v, r[1]["params"][k][n]), f"{k}.{n}"
    assert r[0]["saved"] == [1, 2] and r[1]["saved"] == []
    assert sorted(p.name for p in (tmp / "ckpt").iterdir()) == [
        "step_1.npz", "step_2.npz"]


def test_one_rank_mesh_is_the_single_device_run(tmp_path):
    """On one rank the partitioned update is the single device's to the
    last bit (every reduction is a sum and a division on both paths)."""
    (r,) = run_ranks("train_one_rank", 1, tmp_path)
    assert r["mesh"]["lanes"] == r["single"]["lanes"] == [24, 24]
    assert r["mesh"]["hist"] == r["single"]["hist"]
    for k, sd in r["single"]["params"].items():
        for n, v in sd.items():
            assert torch.equal(r["mesh"]["params"][k][n], v), f"{k}.{n}"


def test_dryrun_train_check_on_two_ranks(tmp_path):
    """parallel/dryrun.py's training check (the contact plant at float64,
    the mesh against rank 0 alone), at 6 lanes for one iteration."""
    r = run_ranks("train_check", 2, tmp_path, iterations=1, num_envs=6)
    assert r[0]["history_max_rel_gap"] <= 1e-9
    assert r[0]["params_max_abs_gap"] <= 1e-9
    assert r[0]["rewards"] == r[1]["rewards"]
    assert "history_max_rel_gap" not in r[1]


def jax_draws(cfg):
    """Every draw `train(cfg)` makes, recomputed from its key sequence:
    the initial states, per step of every iteration the action noise and
    the fresh states of every lane, per iteration the permutations."""
    reset = jax.vmap(_reset_one(cfg))
    key = jax.random.PRNGKey(cfg.seed + 1)
    key, sub = jax.random.split(key)
    init = _np(reset(jax.random.split(sub, cfg.num_envs)))
    noise, fresh, perms = [], [], []
    n = cfg.num_envs * cfg.steps_per_env
    for _ in range(cfg.iterations):
        for _ in range(cfg.steps_per_env):
            key, ka, kr = jax.random.split(key, 3)
            noise.append(np.asarray(jax.random.normal(
                ka, (cfg.num_envs, 9), jax.numpy.float64)))
            fresh.append(_np(reset(jax.random.split(kr, cfg.num_envs))))
        key, sub = jax.random.split(key)
        perms.append(np.stack([np.asarray(jax.random.permutation(k, n))
                               for k in jax.random.split(sub,
                                                         cfg.ppo.epochs)]))
    return init, noise, fresh, perms


def test_sharded_training_matches_jax(tmp_path, monkeypatch):
    jcfg = jrun.TrainConfig(num_envs=24, steps_per_env=6, iterations=2,
                            ppo=JPpo(minibatches=2, epochs=1), seed=7)
    _, params = jrun.init_models(jcfg)
    params = _f64(params)
    init, noise, fresh, perms = jax_draws(jcfg)
    draws = tmp_path / "draws.pt"
    torch.save({"params": _np(params), "init": port_states(init),
                "noise": [torch.tensor(x) for x in noise],
                "fresh": [port_states(f) for f in fresh],
                "perms": perms}, draws)
    ranks = launch("train_injected", 2, tmp_path, draws=str(draws))
    jstate, jhist, _, _ = jax_iteration(jcfg, params, monkeypatch)
    r = ranks.results()
    for x in r:
        assert x["lanes"] == [12, 12]
        for hj, hp in zip(jhist, x["hist"]):
            for k, v in hj.items():
                np.testing.assert_allclose(hp[k], v, rtol=1e-9, err_msg=k)
        for k, sd in x["params"].items():
            ref = state_dict_from_flax(_np(jstate.params[k]))
            for n, v in sd.items():
                if not n.endswith("bias_ih_l0"):
                    np.testing.assert_allclose(v.numpy(), ref[n].numpy(),
                                               rtol=0, atol=1e-8,
                                               err_msg=f"{k}.{n}")
