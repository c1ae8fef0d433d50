"""Port parity: PPO (`rl/ppo.py`).

The JAX package's `rl/ppo.py` against the port's on the same inputs,
drawn from a numpy seed, at float64 (the JAX package's seed-0 initial
parameters of `rl/runner.py::init_models`, cast to float64 on both
sides):

* `gaussian_log_prob` and `compute_gae` within 1e-12;
* the hand-written `clip_by_global_norm_` equal to optax's bit for bit
  at global norms below, at and above `max_norm`;
* one `ppo_update` (5 epochs x 4 minibatches) from the same parameters,
  rollout and permutations (the JAX package's `jax.random.permutation`
  draws injected): every parameter and Adam moment within 1e-9, the lr
  and every metric equal to 1e-12 relative.  Two rollouts: on-policy
  log-probs at lr 1e-7 (the KL stays under half its target, the lr
  grows) and log-probs of other parameters at the default lr (the KL
  exceeds twice its target, the lr is cut);
* a second update from the JAX package's optimizer state after the
  first, carried across by `convert.from_jax_numpy(PpoState)` (optax's
  `ScaleByAdamState` mu, nu, count -> Adam's exp_avg, exp_avg_sq, step),
  to the same tolerances;
* the gradient through the GNN's scatter-max where messages tie (JAX
  splits it equally among the tied maxima, and so does `amax`'s
  backward) within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alore_legged_manipulator_tpu.models.gnn import (
    GraphBatch as JGraph, InteractiveGNN as JGNN)
from alore_legged_manipulator_tpu.rl import ppo as jppo
from alore_legged_manipulator_tpu.rl import runner as jrun
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.models.gnn import (
    GraphBatch, InteractiveGNN)
from alore_legged_manipulator_tpu_torch.models.torch_convert import (
    state_dict_from_flax)
from alore_legged_manipulator_tpu_torch.rl import ppo as tppo
from alore_legged_manipulator_tpu_torch.rl import runner as trun

torch.set_num_threads(2)

S, B = 4, 6
CFG = jppo.PpoConfig()


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.fixture(scope="module")
def jax_setup():
    models, params = jrun.init_models(jrun.TrainConfig(num_envs=6))
    params = _f64(params)
    apply_all = lambda p, oh, nd, ed, co: jrun._apply_all(  # noqa: E731
        models, p, oh, nd, ed, co)
    return models, params, apply_all


def _rollout(apply_all, params, off_policy, seed=0):
    rng = np.random.default_rng(seed)
    oh = rng.normal(0, 0.5, (S, B, 11, 70))
    nodes = rng.normal(0, 0.5, (S, B, 9, 15))
    edges = rng.normal(0, 0.5, (S, B, 26, 7))
    cobs = rng.normal(0, 0.5, (S, B, 161))
    flat = lambda x: x.reshape((S * B,) + x.shape[2:])  # noqa: E731
    src = params
    if off_policy:
        src = jax.tree.map(
            lambda x: x + 0.05 * rng.normal(size=np.shape(x)), params)
    mean, std, value, _ = apply_all(src, flat(oh), flat(nodes), flat(edges),
                                    flat(cobs))
    mean, std = np.asarray(mean), np.asarray(std)
    action = mean + std * rng.normal(size=mean.shape)
    logp = np.asarray(jppo.gaussian_log_prob(mean, std, action))
    unflat = lambda x: np.asarray(x).reshape((S, B) + np.shape(x)[1:])  # noqa
    ro = jppo.Rollout(
        obs_hist=oh, graph_nodes=nodes, graph_edges=edges, critic_obs=cobs,
        actions=unflat(action), log_probs=unflat(logp),
        values=unflat(value), rewards=rng.normal(0.5, 0.5, (S, B)),
        dones=rng.random((S, B)) < 0.15,
        vel_targets=rng.normal(0, 0.3, (S, B, 3)))
    return ro, rng.normal(0, 1.0, (B,))


def _perms(key):
    keys = jax.random.split(key, CFG.epochs)
    return np.stack([np.asarray(jax.random.permutation(k, S * B))
                     for k in keys])


def _port_state(params, lr):
    models = trun.load_models(params, device="cpu", dtype=torch.float64)
    p = {"actor": models.actor, "critic": models.critic}
    return tppo.ppo_init(p, tppo.PpoConfig(lr=lr))


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(ref, float),
                               rtol=0, atol=tol, err_msg=what)


def _same_params(tstate, jparams, tol):
    for k, m in tstate.params.items():
        ref = state_dict_from_flax(jax.tree.map(np.asarray, jparams[k]))
        sd = m.state_dict()
        for name, v in ref.items():
            if name.endswith("bias_ih_l0"):
                continue
            _close(sd[name].numpy(), v.numpy(), tol, f"{k}.{name}")


def _same_moments(tstate, jstate, tol):
    adam = jstate.opt_state[1]
    opt = tstate.opt_state
    for k, m in tstate.params.items():
        mu = state_dict_from_flax(jax.tree.map(np.asarray, adam.mu[k]))
        nu = state_dict_from_flax(jax.tree.map(np.asarray, adam.nu[k]))
        for name, p in m.named_parameters():
            if not p.requires_grad:
                continue
            st = opt.state[p]
            _close(st["exp_avg"].numpy(), mu[name].numpy(), tol, name)
            _close(st["exp_avg_sq"].numpy(), nu[name].numpy(), tol, name)
            assert int(st["step"]) == int(adam.count)


def _same_metrics(tm, jm):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-12,
                                   atol=1e-300, err_msg=k)


def _t(ro):
    return tppo.Rollout(*(torch.as_tensor(np.asarray(x)) for x in ro))


def test_gaussian_log_prob_and_gae():
    rng = np.random.default_rng(1)
    mean, act = rng.normal(size=(2, 7, 9))
    std = rng.uniform(0.2, 2.0, 9)
    _close(tppo.gaussian_log_prob(*map(torch.as_tensor, (mean, std, act))),
           jppo.gaussian_log_prob(mean, std, act), 1e-12, "log_prob")
    r, v = rng.normal(size=(2, 24, 10))
    d = rng.random((24, 10)) < 0.1
    last = rng.normal(size=10)
    ta, tr = tppo.compute_gae(*map(torch.as_tensor, (r, v, d, last)),
                              0.99, 0.95)
    ja, jr = jppo.compute_gae(r, v, d, last, 0.99, 0.95)
    _close(ta, ja, 1e-12, "advantages")
    _close(tr, jr, 1e-12, "returns")


@pytest.mark.parametrize("scale", [0.3, 1.0, 4.0],
                         ids=["below", "at", "above"])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(2)
    if scale == 1.0:    # global norm exactly 1.0
        grads = [np.full((2, 2), 0.5), np.zeros(3), np.array([0.0, -0.0])]
    else:
        grads = [rng.normal(size=s) for s in ((3, 4), (5,), (2, 2, 2))]
        sq = sum(float(np.sum(g * g)) for g in grads)
        grads = [g * scale / np.sqrt(sq) for g in grads]
    ref, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    got = [torch.as_tensor(g.copy()) for g in grads]
    tppo.clip_by_global_norm_(got, 1.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("off_policy,lr", [(False, 1e-7), (True, 1e-3)],
                         ids=["on_policy_small_lr", "off_policy"])
def test_one_update_matches_jax(jax_setup, off_policy, lr):
    models, params, apply_all = jax_setup
    ro, last = _rollout(apply_all, params, off_policy)
    key = jax.random.PRNGKey(3)
    cfg = CFG._replace(lr=lr)
    jstate = jppo.ppo_init(params, cfg)
    jstate, jm = jax.jit(lambda s, r, lv, k: jppo.ppo_update(
        s, r, lv, apply_all, cfg, k))(jstate, ro, last, key)

    tstate = _port_state(params, lr)
    tstate, tm = tppo.ppo_update(tstate, _t(ro), torch.as_tensor(last),
                                 trun._apply_all, tppo.PpoConfig(lr=lr),
                                 perms=torch.as_tensor(_perms(key)))
    _same_params(tstate, jstate.params, 1e-9)
    _same_moments(tstate, jstate, 1e-9)
    _same_metrics(tm, jm)
    if off_policy:
        assert float(jm["lr"]) < lr       # the KL cut the lr
    else:
        assert float(jm["lr"]) > lr       # the KL let it grow


def test_second_update_from_converted_state(jax_setup):
    models, params, apply_all = jax_setup
    ro, last = _rollout(apply_all, params, True, seed=4)
    upd = jax.jit(lambda s, r, lv, k: jppo.ppo_update(s, r, lv, apply_all,
                                                      CFG, k))
    j1, _ = upd(jppo.ppo_init(params, CFG), ro, last, jax.random.PRNGKey(5))
    ro2, last2 = _rollout(apply_all, jax.tree.map(np.asarray, j1.params),
                          False, seed=6)
    key = jax.random.PRNGKey(7)
    j2, jm = upd(j1, ro2, last2, key)

    t1 = from_jax_numpy(jax.tree.map(np.asarray, j1))
    assert isinstance(t1.opt_state, torch.optim.Adam)
    _same_params(t1, j1.params, 0.0)
    _same_moments(t1, j1, 0.0)
    t2, tm = tppo.ppo_update(t1, _t(ro2), torch.as_tensor(last2),
                             trun._apply_all, tppo.PpoConfig(),
                             perms=torch.as_tensor(_perms(key)))
    _same_params(t2, j2.params, 1e-9)
    _same_moments(t2, j2, 1e-9)
    _same_metrics(tm, jm)


def test_gnn_max_gradient_splits_ties():
    """Joints 1-6 send the base node identical messages (same features,
    same edge attributes): a six-way tie in the scatter-max."""
    rng = np.random.default_rng(8)
    nodes = rng.normal(size=(3, 9, 15))
    nodes[:, 1:7] = nodes[:, 1:2]
    edges = rng.normal(size=(3, 26, 7))
    edges[:, 13:19] = edges[:, 13:14]      # reverse star edges (j, 0)
    w = rng.normal(size=(3, 128))
    jg = JGNN()
    jp = _f64(jg.init(jax.random.PRNGKey(0), JGraph(nodes=nodes[:1],
                                                    edge_attr=edges[:1])))
    jgrad = jax.grad(lambda p: jnp.sum(jg.apply(p, JGraph(
        nodes=nodes, edge_attr=edges)) * w))(jp)
    tg = InteractiveGNN().double()
    tg.load_state_dict(state_dict_from_flax(jp))
    out = tg(GraphBatch(nodes=torch.as_tensor(nodes),
                        edge_attr=torch.as_tensor(edges)))
    torch.sum(out * torch.as_tensor(w)).backward()
    ref = state_dict_from_flax(jax.tree.map(np.asarray, jgrad))
    for name, p in tg.named_parameters():
        _close(p.grad.numpy(), ref[name].numpy(), 1e-12, name)
