"""Port parity: the training runner (`rl/runner.py`), surrogate env.

One whole training iteration (collection + PPO update) of the JAX
package's `rl/runner.py::train` against the port's, at float64, with
the JAX package's draws injected into the port: the initial env states,
the action noise of every step, the fresh episodes of every lane that
finished, and the update's permutations (the key sequence `train`
splits, recomputed outside it).  The JAX run is `train` itself, made
float64 by handing it float64 initial parameters and float64 resets,
its rollout read out of the compiled iteration by a `jax.debug.callback`
around `ppo_update`.  `tip_vel_limit` is lowered (0.35 m/s; 0.07 with
the WBC, whose realized velocity lags) so that some lanes, not all,
finish inside the 4 steps and are reset.  Held: every rollout
tensor and the last value within 1e-9, every parameter after the
update within 1e-8, the metrics to 1e-9 relative.  This file: the
surrogate env alone and with the frozen low-level WBC in the loop
(`test_torch_runner_physics.py`: the contact plant).

Also: `init_models`' per-layer mean and standard deviation against the
JAX package's flax initialisers over 8 seeds (within 6 standard errors),
the checkpoint round trip, `train(mesh=...)` refusing a mesh that does
not divide the lanes, and the port
learning on its own, as tests/test_rl.py holds the JAX package:
`train(TrainConfig(num_envs=24, steps_per_env=24, iterations=30))`
raises the mean reward by more than 0.2 and lowers the estimator loss.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.models.torch_convert import (
    convert_low_level_actor as j_convert)
from alore_legged_manipulator_tpu.rl import env as jenv
from alore_legged_manipulator_tpu.rl import env_physics as jep
from alore_legged_manipulator_tpu.rl import hierarchy as jhier
from alore_legged_manipulator_tpu.rl import runner as jrun
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.models.torch_convert import (
    flax_from_state_dict, state_dict_from_flax)
from alore_legged_manipulator_tpu_torch.rl import runner as trun
from tests.test_torch_convert import TorchLowAC, _randomize

torch.set_num_threads(2)

N, S = 6, 4


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_cfg(physics_env, hier, tip):
    low = None
    if hier:     # the reference checkpoint's layout, seeded random weights
        low = _f64(j_convert(_randomize(TorchLowAC(), seed=11)))
    return jrun.TrainConfig(num_envs=N, steps_per_env=S, iterations=1,
                            env=jenv.PushEnvConfig(tip_vel_limit=tip),
                            physics_env=physics_env,
                            low_level_params=low)


def _reset_one(cfg):
    dt = jnp.float64
    if cfg.physics_env:
        pcfg = cfg.physics or jep.PhysicsEnvConfig(base=cfg.env)
        env = lambda k: jep.env_reset(k, pcfg, dt)  # noqa: E731
    else:
        env = lambda k: jenv.env_reset(k, cfg.env, dt)  # noqa: E731
    if cfg.low_level_params is None:
        return env
    return lambda k: (env(k), jhier.robot_reset(dt))


def jax_draws(cfg):
    """The draws `train` makes in its first iteration, recomputed from
    its key sequence: initial states, per step the action noise and the
    fresh states of every lane, the update's permutations."""
    reset = jax.vmap(_reset_one(cfg))
    key = jax.random.PRNGKey(cfg.seed + 1)
    key, sub = jax.random.split(key)
    init = _np(reset(jax.random.split(sub, cfg.num_envs)))
    noise, fresh = [], []
    for _ in range(cfg.steps_per_env):
        key, ka, kr = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(ka, (cfg.num_envs, 9),
                                                  jnp.float64)))
        fresh.append(_np(reset(jax.random.split(kr, cfg.num_envs))))
    key, sub = jax.random.split(key)
    n = cfg.num_envs * cfg.steps_per_env
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(sub, cfg.ppo.epochs)])
    return init, noise, fresh, perms


def jax_iteration(cfg, params, monkeypatch):
    """`train(cfg)` for one iteration at float64; returns (ppo_state,
    history, rollout, last_value)."""
    models, _ = jrun.init_models(cfg)
    seen = {}
    real_update = jrun.ppo_update

    def update(state, rollout, last_value, apply_fn, pcfg, key):
        jax.debug.callback(
            lambda r, lv: seen.update(rollout=_np(r), last=np.asarray(lv)),
            rollout, last_value)
        return real_update(state, rollout, last_value, apply_fn, pcfg, key)

    with monkeypatch.context() as m:
        m.setattr(jrun, "init_models", lambda c: (models, params))
        m.setattr(jrun, "env_reset", partial(jenv.env_reset,
                                             dtype=jnp.float64))
        m.setattr(jep, "env_reset", partial(jep.env_reset,
                                            dtype=jnp.float64))
        m.setattr(jrun, "robot_reset", partial(jhier.robot_reset,
                                               dtype=jnp.float64))
        m.setattr(jrun, "ppo_update", update)
        state, hist = jrun.train(cfg)
    return state, hist, seen["rollout"], seen["last"]


def port_states(tree):
    """JAX env states -> the port's; the carried PRNG keys (uint32 in
    the JAX package, never drawn from) become the port's int64 keys."""
    return from_jax_numpy(jax.tree.map(
        lambda x: x.astype(np.int64) if x.dtype == np.uint32 else x, tree))


class InjectedDraws:
    """The JAX package's draws in the port's `Draws` interface."""

    def __init__(self, noise, fresh):
        self.noise_k = [torch.as_tensor(x) for x in noise]
        self.fresh_k = [port_states(f) for f in fresh]
        self.n_reset = 0

    def noise(self, k, mean):
        return self.noise_k[k]

    def reset_done(self, k, states, done):
        idx = torch.nonzero(done)[:, 0]
        self.n_reset += idx.numel()
        if idx.numel() == 0:
            return states
        fresh = trun._tree_map(lambda x: x[idx], self.fresh_k[k])
        return trun.put_lanes(states, idx, fresh)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(ref, float),
                               rtol=0, atol=tol, err_msg=what)


def run_both(physics_env, hier, tip, monkeypatch):
    """One iteration through both packages, lanes whose object moves
    faster than `tip` m/s finishing; holds the rollout, the parameters
    after the update and the metrics.  Returns the largest gaps seen."""
    jcfg = jax_cfg(physics_env, hier, tip)
    _, params = jrun.init_models(jcfg)
    params = _f64(params)
    jstate, jhist, jro, jlast = jax_iteration(jcfg, params, monkeypatch)
    init, noise, fresh, perms = jax_draws(jcfg)

    tcfg = from_jax_numpy(jcfg)
    if hier:
        assert isinstance(tcfg.low_level_params, torch.nn.Module)
    models = trun.load_models(params, device="cpu", dtype=torch.float64)
    tparams = {"actor": models.actor, "critic": models.critic}
    env = trun.make_env(tcfg, torch.float64, "cpu")
    draws = InjectedDraws(noise, fresh)
    states, ro, last = trun.collect(tparams, env, port_states(init), tcfg,
                                    draws)
    gaps = {}
    for f in jro._fields:
        got, ref = getattr(ro, f).numpy(), getattr(jro, f)
        if f == "dones":
            np.testing.assert_array_equal(got, ref)
            continue
        _close(got, ref, 1e-9, f)
        gaps[f] = float(np.max(np.abs(got - ref)))
    _close(last, jlast, 1e-9, "last_value")
    assert 0 < draws.n_reset < N * S, draws.n_reset
    assert int(jro.dones.sum()) == draws.n_reset

    state = trun.ppo_init(tparams, tcfg.ppo)
    state, tm = trun.ppo_update(state, ro, last, trun._apply_all, tcfg.ppo,
                                perms=perms)
    pg = 0.0
    for k, m in state.params.items():
        ref = state_dict_from_flax(_np(jstate.params[k]))
        for name, v in m.state_dict().items():
            if not name.endswith("bias_ih_l0"):
                _close(v.numpy(), ref[name].numpy(), 1e-8, f"{k}.{name}")
                pg = max(pg, float(torch.max(torch.abs(v - ref[name]))))
    gaps["params"] = pg
    for k, v in jhist[0].items():
        np.testing.assert_allclose(float(tm[k]), v, rtol=1e-9, err_msg=k)
    return gaps


@pytest.mark.parametrize("hier,tip", [(False, 0.35), (True, 0.07)],
                         ids=["surrogate", "surrogate_wbc"])
def test_iteration_matches_jax(hier, tip, monkeypatch):
    run_both(False, hier, tip, monkeypatch)


def test_init_distributions_match_flax():
    seeds = range(8)
    jstats, tstats = {}, {}
    for s in seeds:
        _, jp = jrun.init_models(jrun.TrainConfig(seed=s))
        _, tp = trun.init_models(trun.TrainConfig(seed=s), device="cpu")
        for k in ("actor", "critic"):
            ref = state_dict_from_flax(_np(jp[k]))
            for name, v in tp[k].state_dict().items():
                jstats.setdefault((k, name), []).append(ref[name].numpy())
                tstats.setdefault((k, name), []).append(v.numpy())
    assert set(jstats) == set(tstats)
    for key in jstats:
        j = np.concatenate([x.ravel() for x in jstats[key]])
        t = np.concatenate([x.ravel() for x in tstats[key]])
        assert j.shape == t.shape, key
        if np.all(j == j.flat[0]):              # zero biases, std = 1
            np.testing.assert_array_equal(t, j, err_msg=str(key))
            continue
        sd = j.std()
        se = sd / np.sqrt(j.size)
        assert abs(t.mean() - j.mean()) < 6 * np.sqrt(2) * se, key
        assert abs(t.std() / sd - 1) < 6 / np.sqrt(j.size) + 1e-3, key
        if key[1].endswith("weight_hh_l0"):     # orthogonal, per gate
            for w in tstats[key]:
                for blk in np.split(w, 4):
                    np.testing.assert_allclose(blk @ blk.T, np.eye(128),
                                               atol=1e-5)
            continue
        # the same tails (lecun_normal truncates at two deviations)
        assert abs(np.abs(t).max() / np.abs(j).max() - 1) < 0.05, key


def test_checkpoint_round_trip(tmp_path):
    models, params = trun.init_models(trun.TrainConfig(seed=3),
                                      device="cpu")
    state = trun.ppo_init(params, trun.PpoConfig())
    path = trun.save_checkpoint(str(tmp_path), state, 7)
    assert path.endswith("step_7.npz")
    tree = trun.load_checkpoint(str(tmp_path), 7)
    back = trun.load_models(tree, device="cpu")
    for a, b in zip(models, back):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    # the flax layout: a served actor reads it as the exported weights
    assert set(tree["actor"]["params"]) == {
        "physic_estimator", "interactive_gnn", "shared_mlp", "base_head",
        "arm_head", "std"}
    flat = flax_from_state_dict(models.critic.state_dict())
    assert flat["params"]["Dense_0"]["kernel"].shape == (128, 1)


def test_train_with_mesh_raises():
    """A mesh whose size does not divide the lanes is refused before any
    collective (tests/test_torch_train_sharded.py trains on meshes)."""
    from alore_legged_manipulator_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(axis="env", group=None, rank=0, size=2,
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        trun.train(trun.TrainConfig(num_envs=3, iterations=1), mesh=mesh,
                   device="cpu")


def test_port_learns_on_push_env():
    cfg = trun.TrainConfig(num_envs=24, steps_per_env=24, iterations=30)
    state, history = trun.train(cfg, device="cpu")
    first = np.mean([h["mean_reward"] for h in history[:3]])
    last = np.mean([h["mean_reward"] for h in history[-3:]])
    assert last > first + 0.2, f"no learning progress: {first} -> {last}"
    assert history[-1]["estimator_loss"] < history[0]["estimator_loss"]
    assert all(np.isfinite(list(h.values())).all() for h in history)


def test_rollout_tracking_takes_models():
    """rl/eval.py::rollout_tracking takes the runner's `Models` as the
    JAX package's does, and gives what the actor alone gives."""
    from alore_legged_manipulator_tpu_torch.rl.eval import rollout_tracking

    models, _ = trun.init_models(trun.TrainConfig(seed=2), device="cpu")
    a = rollout_tracking(models, 3, 4, seed=1)
    b = rollout_tracking(models.actor, 3, 4, seed=1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_committed_init_equals_jax_seed0():
    """models/weights/train_init_physics_seed0.npz (written by
    tests/export_train_init_weights.py) holds the JAX package's seed-0
    initial parameters leaf for leaf, and loads into the port's models."""
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        TRAIN_INIT_PHYSICS_SEED0, flatten_flax, load_flax_npz)
    from tests.export_train_init_weights import jax_seed0_params

    tree = load_flax_npz(TRAIN_INIT_PHYSICS_SEED0)
    ref = flatten_flax(jax_seed0_params())
    got = flatten_flax(tree)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    models = trun.load_models(tree, device="cpu")
    sd = flax_from_state_dict(models.actor.state_dict())
    np.testing.assert_array_equal(sd["params"]["std"],
                                  tree["actor"]["params"]["std"])
