"""Port parity: the policy models (`models/*`) and the trained weights.

Every model goes through the JAX package (parameters from
`rl/runner.py::init_models` and from `low_level_policy_cfg().init`) and
through the port, whose `state_dict` comes from the same flax tree by
`state_dict_from_flax`.  Inputs are drawn from a numpy seed.  Tolerance:
1e-10 at float64 (parameters cast to float64 on both sides), 1e-5 at
float32.

* `build_interaction_graph` on the JAX env's graph features, the GNN,
  the LSTM estimator, the actor (mean, std, velocity estimate), the
  critic, the low-level policy on its history and on its privileged
  path, and the history encoder alone.
* The reference-checkpoint converters (`models/torch_convert.py`): the
  randomized reference twins of tests/test_torch_convert.py (imported,
  not edited) through the port's `convert_*` give the twins' outputs and
  the JAX converters' to 1e-5.
* The committed weights (`models/weights/highlevel_physics_6000.npz`)
  equal the orbax checkpoint `examples/artifacts/ckpt_physics_6000`
  leaf for leaf, and the port's actor loaded from them gives the JAX
  actor's output on the checkpoint on what the served policy sees: JAX
  contact-plant env states after random actions (float32; its means
  reach +-22 before the env clips them, so 1e-5 relative and absolute).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.models.gnn import (
    GraphBatch as JGraph, build_interaction_graph as j_build)
from alore_legged_manipulator_tpu.models import torch_convert as jtc
from alore_legged_manipulator_tpu.models.low_level import (
    StateHistoryEncoder as JSHE)
from alore_legged_manipulator_tpu.rl import env as jenv
from alore_legged_manipulator_tpu.rl.hierarchy import (
    low_level_policy_cfg as j_low_cfg)
from alore_legged_manipulator_tpu.rl.runner import TrainConfig, init_models
from alore_legged_manipulator_tpu_torch.models import torch_convert as ttc
from alore_legged_manipulator_tpu_torch.models.actor_critic import (
    Critic, PhysicActorCritic)
from alore_legged_manipulator_tpu_torch.models.estimator import (
    PhysicEstimator)
from alore_legged_manipulator_tpu_torch.models.gnn import (
    EDGES, GraphBatch, InteractiveGNN, build_interaction_graph)
from alore_legged_manipulator_tpu_torch.models.low_level import (
    StateHistoryEncoder)
from alore_legged_manipulator_tpu_torch.rl.hierarchy import (
    low_level_policy_cfg)
from tests import test_torch_convert as twins
from tests.export_highlevel_weights import restore_params

torch.set_num_threads(1)

DTYPES = [(np.float64, torch.float64, 1e-10), (np.float32, torch.float32,
                                               1e-5)]
IDS = ["f64", "f32"]
B = 5


def _np(tree):
    return jax.tree.map(np.array, tree)


def _cast(tree, npdt):
    return jax.tree.map(lambda x: np.asarray(x).astype(npdt), tree)


def _load(module, tree, tdt, strict=True):
    sd = ttc.state_dict_from_flax(tree)
    missing, unexpected = module.load_state_dict(sd, strict=strict)
    assert not unexpected
    return module.to(tdt).eval(), missing


@pytest.fixture(scope="module")
def hl():
    models, params = init_models(TrainConfig())
    return models, _np(params)


@pytest.fixture(scope="module")
def low():
    pol = j_low_cfg()
    rng = np.random.default_rng(3)
    prop = jnp.asarray(rng.normal(size=(1, 71)), jnp.float32)
    hist = jnp.asarray(rng.normal(size=(1, 10, 71)), jnp.float32)
    priv = jnp.asarray(rng.normal(size=(1, 18)), jnp.float32)
    p_hist = _np(pol.init(jax.random.PRNGKey(1), prop, hist))
    p_priv = _np(pol.init(jax.random.PRNGKey(2), prop, hist, priv))
    return pol, p_hist, p_priv


def _obs_and_graphs(npdt, seed=0):
    """Observation histories from numpy, graphs from the JAX env's
    features of randomized states."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, 11, 70)).astype(npdt)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    st = jax.vmap(lambda k: jenv.env_reset(k, jenv.PushEnvConfig(),
                                           jnp.dtype(npdt)))(keys)
    st = st._replace(
        arm_q=jnp.asarray(rng.uniform(-1, 1, (B, 6)).astype(npdt)),
        obj_vel=jnp.asarray(rng.normal(size=(B, 3)).astype(npdt)),
        obj_pose=jnp.asarray(rng.normal(size=(B, 3)).astype(npdt)))
    feats = jax.vmap(jenv.graph_features)(st)
    return obs, _np(feats)


@pytest.mark.parametrize("npdt,tdt,tol", DTYPES, ids=IDS)
def test_build_interaction_graph(npdt, tdt, tol):
    _, feats = _obs_and_graphs(npdt)
    gj = _np(jax.vmap(j_build)(*feats))
    gt = build_interaction_graph(*(torch.as_tensor(f) for f in feats))
    np.testing.assert_allclose(gt.nodes.numpy(), gj.nodes, rtol=0, atol=tol)
    np.testing.assert_allclose(gt.edge_attr.numpy(), gj.edge_attr, rtol=0,
                               atol=tol)
    assert gt.nodes.dtype == tdt


@pytest.mark.parametrize("npdt,tdt,tol", DTYPES, ids=IDS)
def test_gnn(hl, npdt, tdt, tol):
    models, params = hl
    p = _cast(params["actor"]["params"]["interactive_gnn"], npdt)
    _, feats = _obs_and_graphs(npdt, seed=1)
    g = jax.vmap(j_build)(*feats)
    from alore_legged_manipulator_tpu.models.gnn import InteractiveGNN as JG
    ref = np.asarray(JG().apply({"params": p}, g))
    mod, _ = _load(InteractiveGNN(), p, tdt)
    got = mod(GraphBatch(torch.as_tensor(np.asarray(g.nodes)),
                         torch.as_tensor(np.asarray(g.edge_attr))))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("npdt,tdt,tol", DTYPES, ids=IDS)
def test_estimator(hl, npdt, tdt, tol):
    _, params = hl
    p = _cast(params["actor"]["params"]["physic_estimator"], npdt)
    obs, _ = _obs_and_graphs(npdt, seed=2)
    from alore_legged_manipulator_tpu.models.estimator import (
        PhysicEstimator as JE)
    ref = np.asarray(JE().apply({"params": p}, jnp.asarray(obs)))
    mod, _ = _load(PhysicEstimator(), p, tdt)
    got = mod(torch.as_tensor(obs)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("npdt,tdt,tol", DTYPES, ids=IDS)
def test_actor(hl, npdt, tdt, tol):
    models, params = hl
    p = _cast(params["actor"], npdt)
    obs, feats = _obs_and_graphs(npdt, seed=4)
    g = jax.vmap(j_build)(*feats)
    mean, std, vel = _np(models.actor.apply(p, jnp.asarray(obs), g))
    mod, _ = _load(PhysicActorCritic(), p, tdt)
    gt = GraphBatch(torch.as_tensor(np.asarray(g.nodes)),
                    torch.as_tensor(np.asarray(g.edge_attr)))
    m, s, v = (x.detach().numpy() for x in mod(torch.as_tensor(obs), gt))
    np.testing.assert_allclose(m, mean, rtol=0, atol=tol)
    np.testing.assert_allclose(v, vel, rtol=0, atol=tol)
    np.testing.assert_array_equal(s, std)


@pytest.mark.parametrize("npdt,tdt,tol", DTYPES, ids=IDS)
def test_critic(hl, npdt, tdt, tol):
    models, params = hl
    p = _cast(params["critic"], npdt)
    x = np.random.default_rng(5).normal(size=(B, 161)).astype(npdt)
    ref = np.asarray(models.critic.apply(p, jnp.asarray(x)))
    mod, _ = _load(Critic(), p, tdt)
    got = mod(torch.as_tensor(x)).detach().numpy()
    assert got.shape == (B,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("path", ["history", "priv"])
@pytest.mark.parametrize("npdt,tdt,tol", DTYPES, ids=IDS)
def test_low_level(low, path, npdt, tdt, tol):
    pol, p_hist, p_priv = low
    p = _cast(p_hist if path == "history" else p_priv, npdt)
    rng = np.random.default_rng(6)
    prop = rng.normal(size=(B, 71)).astype(npdt)
    hist = rng.normal(size=(B, 10, 71)).astype(npdt)
    priv = rng.normal(size=(B, 18)).astype(npdt) if path == "priv" else None
    ref = np.asarray(pol.apply(p, jnp.asarray(prop), jnp.asarray(hist),
                               None if priv is None else jnp.asarray(priv)))
    mod, missing = _load(low_level_policy_cfg(), p, tdt, strict=False)
    unused = "priv_encoder." if path == "history" else "history_encoder."
    assert missing and all(k.startswith(unused) for k in missing)
    got = mod(torch.as_tensor(prop), torch.as_tensor(hist),
              None if priv is None else torch.as_tensor(priv))
    assert got.shape == (B, 18)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("tsteps", [10, 20, 50])
def test_history_encoder_lengths(tsteps):
    rng = np.random.default_rng(tsteps)
    x = rng.normal(size=(3, tsteps, 33))
    jm = JSHE(tsteps=tsteps)
    p = _cast(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), np.float64)
    ref = np.asarray(jm.apply(p, jnp.asarray(x)))
    mod, _ = _load(StateHistoryEncoder(33, tsteps=tsteps), p, torch.float64)
    got = mod(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


# --- reference torch checkpoints through the port's converters ----------

def test_convert_low_level_actor():
    tm = twins.TorchLowAC()
    sd = twins._randomize(tm)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(7, 71 + 18 + 710)).astype(np.float32)
    prop = obs[:, :71]
    hist = obs[:, -710:].reshape(7, 10, 71)
    priv = obs[:, 71:89]
    mod = low_level_policy_cfg()
    mod.load_state_dict(ttc.convert_low_level_actor(sd))
    jp = jtc.convert_low_level_actor(sd)
    for hist_enc in (True, False):
        with torch.no_grad():
            ref = tm.actor(torch.as_tensor(obs), hist_enc).numpy()
            got = mod(torch.as_tensor(prop), torch.as_tensor(hist),
                      None if hist_enc else torch.as_tensor(priv)).numpy()
        jx = np.asarray(j_low_cfg().apply(
            jp, jnp.asarray(prop), jnp.asarray(hist),
            None if hist_enc else jnp.asarray(priv)))
        assert np.abs(got - ref).max() < 1e-5
        assert np.abs(got - jx).max() < 1e-5


def test_convert_physic_estimator():
    tm = twins.TorchPhysicEstimator()
    sd = twins._randomize(tm)
    x = np.random.default_rng(1).normal(size=(5, 11, 44)).astype(np.float32)
    mod = PhysicEstimator(in_dim=44)
    mod.load_state_dict(ttc.convert_physic_estimator(sd, prefix=""))
    with torch.no_grad():
        ref = tm(torch.as_tensor(x)).numpy()
        got = mod(torch.as_tensor(x)).numpy()
    assert np.abs(got - ref).max() < 1e-5


def test_convert_physic_actor_critic():
    tm = twins.TorchPhysicAC()
    sd = twins._randomize(tm)
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(4, 11, 44)).astype(np.float32)
    nodes = rng.normal(size=(4, 9, 15)).astype(np.float32)
    edges = rng.normal(size=(4, EDGES.shape[0], 7)).astype(np.float32)
    mod = PhysicActorCritic(obs_dim=44)
    mod.load_state_dict(ttc.convert_physic_actor_critic(sd))
    crit = Critic()
    crit.load_state_dict(ttc.convert_critic(sd))
    with torch.no_grad():
        ref_mean, ref_vel = tm.act_inference(*(torch.as_tensor(a) for a in
                                               (obs, nodes, edges)))
        mean, std, vel = mod(torch.as_tensor(obs),
                             GraphBatch(torch.as_tensor(nodes),
                                        torch.as_tensor(edges)))
        cobs = rng.normal(size=(4, 161)).astype(np.float32)
        ref_v = tm.critic(torch.as_tensor(cobs)).numpy()[:, 0]
        v = crit(torch.as_tensor(cobs)).numpy()
    assert np.abs(mean.numpy() - ref_mean.numpy()).max() < 1e-5
    assert np.abs(vel.numpy() - ref_vel.numpy()).max() < 1e-5
    np.testing.assert_allclose(std.detach().numpy(), sd["std"], atol=1e-7)
    assert np.abs(v - ref_v).max() < 1e-5
    # the same checkpoint through the JAX converter and flax
    from alore_legged_manipulator_tpu.models.actor_critic import (
        PhysicActorCritic as JAC)
    jm, _, jv = JAC().apply(jtc.convert_physic_actor_critic(sd),
                            jnp.asarray(obs),
                            JGraph(jnp.asarray(nodes), jnp.asarray(edges)))
    assert np.abs(mean.numpy() - np.asarray(jm)).max() < 1e-5
    assert np.abs(vel.numpy() - np.asarray(jv)).max() < 1e-5


# --- the committed trained weights --------------------------------------

@pytest.fixture(scope="module")
def ckpt():
    return restore_params()


def test_npz_equals_the_checkpoint(ckpt):
    flat = ttc.flatten_flax(ckpt["actor"])
    z = np.load(ttc.HIGHLEVEL_PHYSICS_6000)
    assert sorted(z.files) == sorted(flat)
    for k, v in flat.items():
        assert z[k].dtype == np.float32
        np.testing.assert_array_equal(z[k], v, err_msg=k)


def _contact_env_inputs(n=8, steps=12, seed=7):
    """Observation histories and graph features the served policy sees:
    JAX contact-plant env resets, then `steps` random actions."""
    from alore_legged_manipulator_tpu.rl import env_physics as jep
    cfg = jep.PhysicsEnvConfig()
    st = jax.vmap(lambda k: jep.env_reset(k, cfg))(
        jax.random.split(jax.random.PRNGKey(seed), n))
    rng = np.random.default_rng(seed)
    step = jax.jit(jax.vmap(lambda s, a: jep.env_step(s, a, cfg)[0]))
    for _ in range(steps):
        a = jnp.asarray(rng.uniform(-1, 1, (n, 9)), jnp.float32)
        st = step(st, a)
    view = jax.vmap(jep.as_surrogate_view)(st)
    return np.array(view.obs_hist), _np(jax.vmap(jenv.graph_features)(view))


def test_trained_actor_matches_jax(ckpt):
    from alore_legged_manipulator_tpu.models.actor_critic import (
        PhysicActorCritic as JAC)
    obs, feats = _contact_env_inputs()
    g = jax.vmap(j_build)(*feats)
    jm, js, jv = _np(JAC().apply(ckpt["actor"], jnp.asarray(obs), g))
    actor = ttc.load_highlevel_actor(device="cpu")
    with torch.no_grad():
        m, s, v = actor(torch.as_tensor(obs),
                        GraphBatch(torch.as_tensor(np.asarray(g.nodes)),
                                   torch.as_tensor(np.asarray(g.edge_attr))))
    # the trained means reach +-22 before the env clips them to [-1, 1]:
    # float32 holds them to about 1e-6 relative (seen: 1.2e-5 absolute)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), jv, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(s.detach().numpy(), js)


def test_trained_actor_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttc.load_highlevel_actor()
