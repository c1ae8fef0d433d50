"""On-policy training runner (port of rl/runner.py).

Mirrors rsl_rl/on_policy_runner_physic.py: collect 24 steps per env per
iteration, PPO update threading critic observations and the estimator
supervision through; periodic checkpoints.

Collection runs under `torch.no_grad()` (not `inference_mode`: the
rollout tensors are inputs to the update's forward), one batched step
per control tick on the device of the models.  The four modes of the
JAX package map onto the port's env functions:

  * surrogate env: `rl/env.py::env_reset/env_step`;
  * surrogate env + frozen WBC: `rl/hierarchy.py::hierarchical_env_step`
    with `robot_reset`;
  * contact plant: `rl/env_physics.py::env_reset/env_step`, observed
    through `as_surrogate_view`;
  * contact plant + frozen WBC: `rl/env_physics.py::hierarchical_env_step`.

`TrainConfig.low_level_params` holds the frozen `ActorCriticLow` module
itself (its parameters with `requires_grad` off).

Randomness comes from explicit generators: resets from a CPU generator
seeded `seed + 1` (the env resets draw on the host and copy), action
noise from a generator on the models' device.  The JAX package draws
fresh states for every lane at every step and selects them by `done`;
the port draws fresh states for the done lanes only (the same
distribution; one host read of `done` per step instead of a whole-batch
reset and a select per state field).  `Draws` is the hook a parity run
replaces to inject the JAX package's draws.

Checkpoints are the port's own: `step_<n>.npz` of the `{"actor",
"critic"}` parameter trees under the flax names (the format of
`models/weights/*.npz`).  The data-parallel `mesh` of the JAX runner
needs `parallel/`, which the port does not have yet: `train(mesh=...)`
raises `ValueError`.
"""
from __future__ import annotations

import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..models.actor_critic import Critic, PhysicActorCritic
from ..models.gnn import GraphBatch, build_interaction_graph
from ..models.torch_convert import (flax_from_state_dict, load_flax_npz,
                                    save_flax_npz, state_dict_from_flax)
from ..utils.precision import resolve_device, set_precision_policy
from .env import (PushEnvConfig, critic_observation, env_reset, env_step,
                  graph_features)
from .hierarchy import HierarchyConfig, hierarchical_env_step, robot_reset
from .ppo import (PpoConfig, PpoState, Rollout, gaussian_log_prob, ppo_init,
                  ppo_update)


class TrainConfig(NamedTuple):
    num_envs: int = 96           # must be a multiple of 3 (one per class)
    steps_per_env: int = 24
    iterations: int = 100
    ppo: PpoConfig = PpoConfig()
    env: PushEnvConfig = PushEnvConfig()
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str | None = None
    # hierarchy-in-the-loop training (reference mode): when a frozen
    # low-level ActorCriticLow is supplied, every env step runs the WBC
    # decimation loop (rl/hierarchy.py) and the object is pushed by the
    # ROBOT'S REALIZED velocity (env_train.py:438-543)
    low_level_params: object = None
    hierarchy: HierarchyConfig = HierarchyConfig()
    # physics-env training (PhysX-analogue mode): the object moves only
    # through rigid-body contact + the grasp weld (rl/env_physics.py)
    physics_env: bool = False
    physics: object = None       # PhysicsEnvConfig override


class Models(NamedTuple):
    actor: PhysicActorCritic
    critic: Critic


def _graph_of(st):
    return build_interaction_graph(*graph_features(st))


def _apply_all(params, obs_hist, nodes, edges, critic_obs):
    g = GraphBatch(nodes=nodes, edge_attr=edges)
    mean, std, vel_est = params["actor"](obs_hist, g)
    value = params["critic"](critic_obs)
    return mean, std, value, vel_est


# ---------------------------------------------------------------------------
# initialisation: flax's initialisers by distribution
# ---------------------------------------------------------------------------

def _lecun_normal_(w, fan_in, gen):
    """flax `lecun_normal`: a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(w.shape, dtype=torch.float64)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.copy_(t * std)


def _flax_init_(module, gen):
    """Dense and Conv kernels lecun_normal (fan-in), biases zero, the
    LSTM's input kernels lecun_normal and its recurrent kernels
    orthogonal, one matrix per gate (flax's OptimizedLSTMCell)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Linear):
                _lecun_normal_(m.weight, m.in_features, gen)
                m.bias.zero_()
            elif isinstance(m, torch.nn.Conv1d):
                _lecun_normal_(m.weight, m.in_channels * m.kernel_size[0],
                               gen)
                m.bias.zero_()
            elif isinstance(m, torch.nn.LSTM):
                _lecun_normal_(m.weight_ih_l0, m.input_size, gen)
                H = m.hidden_size
                for g in range(4):
                    blk = torch.empty(H, H, dtype=torch.float64)
                    torch.nn.init.orthogonal_(blk, generator=gen)
                    m.weight_hh_l0[g * H:(g + 1) * H] = blk
                m.bias_ih_l0.zero_()
                m.bias_hh_l0.zero_()


def init_models(cfg: TrainConfig = TrainConfig(), device=None):
    """Fresh float32 actor and critic with flax's initialisers, drawn
    from a CPU generator seeded `cfg.seed`, on `device` (None: the card).
    Returns (models, params): params is `{"actor", "critic"}` over the
    same modules, the tree `ppo_init` and `_apply_all` take."""
    dev = resolve_device(device)
    set_precision_policy()
    gen = torch.Generator().manual_seed(cfg.seed)
    actor, critic = PhysicActorCritic(), Critic()
    _flax_init_(actor, gen)
    _flax_init_(critic, gen)
    models = Models(actor=actor.to(dev), critic=critic.to(dev))
    return models, {"actor": models.actor, "critic": models.critic}


def load_models(tree, device=None, dtype=torch.float32):
    """`Models` holding a `{"actor", "critic"}` flax parameter tree (numpy
    leaves, as `load_checkpoint` or `load_flax_npz` return it), on
    `device` (None: the card)."""
    dev = resolve_device(device)
    set_precision_policy()
    actor = PhysicActorCritic().to(device=dev, dtype=dtype)
    critic = Critic().to(device=dev, dtype=dtype)
    actor.load_state_dict(state_dict_from_flax(tree["actor"]))
    critic.load_state_dict(state_dict_from_flax(tree["critic"]))
    return Models(actor=actor, critic=critic)


# ---------------------------------------------------------------------------
# the env of each mode, batched
# ---------------------------------------------------------------------------

class EnvFns(NamedTuple):
    reset: object      # (gen, n) -> n fresh states
    step: object       # (states, action) -> (states, hist, reward, done)
    push_of: object    # states -> the surrogate view (PushEnvState)


def make_env(cfg: TrainConfig, dtype=torch.float32, device=None) -> EnvFns:
    """The batched reset / step / view of the mode `cfg` selects."""
    dev = resolve_device(device)
    low = cfg.low_level_params
    if cfg.physics_env:
        from . import env_physics as ep
        pcfg = cfg.physics or ep.PhysicsEnvConfig(base=cfg.env)
        if low is not None:
            # the COMPLETE stack: frozen WBC inside the contact loop
            def reset(gen, n):
                return (ep.env_reset(gen, pcfg, dtype, n_envs=n, device=dev),
                        robot_reset(dtype, n, dev))

            def step(s, a):
                st, rs, hist, r, d = ep.hierarchical_env_step(
                    s[0], s[1], a, low, pcfg, cfg.hierarchy)
                return (st, rs), hist, r, d

            return EnvFns(reset, step, lambda s: ep.as_surrogate_view(s[0]))
        return EnvFns(
            lambda gen, n: ep.env_reset(gen, pcfg, dtype, n_envs=n,
                                        device=dev),
            lambda s, a: ep.env_step(s, a, pcfg), ep.as_surrogate_view)
    if low is not None:
        def reset(gen, n):
            return (env_reset(gen, cfg.env, dtype, n_envs=n, device=dev),
                    robot_reset(dtype, n, dev))

        def step(s, a):
            st, rs, hist, r, d = hierarchical_env_step(
                s[0], s[1], a, low, cfg.env, cfg.hierarchy)
            return (st, rs), hist, r, d

        return EnvFns(reset, step, lambda s: s[0])
    return EnvFns(
        lambda gen, n: env_reset(gen, cfg.env, dtype, n_envs=n, device=dev),
        lambda s, a: env_step(s, a, cfg.env), lambda s: s)


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return t0


def put_lanes(states, idx, fresh):
    """`states` with lanes `idx` replaced by the lanes of `fresh`."""
    return _tree_map(lambda x, f: x.index_copy(0, idx, f.to(x.device)),
                     states, fresh)


class Draws:
    """The runner's random draws: action noise from `dev_gen` (a
    generator on the models' device) and, for the lanes that finished,
    fresh episodes drawn from the CPU generator `gen`."""

    def __init__(self, env: EnvFns, gen: torch.Generator,
                 dev_gen: torch.Generator):
        self.env, self.gen, self.dev_gen = env, gen, dev_gen

    def noise(self, k: int, mean):
        return torch.randn(mean.shape, generator=self.dev_gen,
                           dtype=mean.dtype, device=mean.device)

    def reset_done(self, k: int, states, done):
        idx = torch.nonzero(done)[:, 0]
        if idx.numel() == 0:
            return states
        return put_lanes(states, idx, self.env.reset(self.gen, idx.numel()))


def collect(params, env: EnvFns, env_states, cfg: TrainConfig,
            draws: Draws):
    """`cfg.steps_per_env` stochastic steps of every lane.  Returns
    (env_states, rollout (S, B, ...), last_value (B,))."""
    steps = []
    with torch.no_grad():
        for k in range(cfg.steps_per_env):
            push = env.push_of(env_states)
            g = _graph_of(push)
            cobs = critic_observation(push, cfg.env)
            mean, std, value, _ = _apply_all(params, push.obs_hist, g.nodes,
                                             g.edge_attr, cobs)
            action = mean + std * draws.noise(k, mean)
            logp = gaussian_log_prob(mean, std, action)
            new_states, _, reward, done = env.step(env_states, action)
            steps.append(Rollout(
                obs_hist=push.obs_hist, graph_nodes=g.nodes,
                graph_edges=g.edge_attr, critic_obs=cobs, actions=action,
                log_probs=logp, values=value, rewards=reward, dones=done,
                vel_targets=push.obj_vel))
            # auto-reset finished envs
            env_states = draws.reset_done(k, new_states, done)
        push = env.push_of(env_states)
        g = _graph_of(push)
        cobs = critic_observation(push, cfg.env)
        _, _, last_value, _ = _apply_all(params, push.obs_hist, g.nodes,
                                         g.edge_attr, cobs)
    rollout = Rollout(*(torch.stack(f) for f in zip(*steps)))
    return env_states, rollout, last_value


def train(cfg: TrainConfig = TrainConfig(), progress=None, mesh=None,
          device=None, models: Models = None, timings=None):
    """Run PPO training on `device` (None: the card); returns (ppo_state,
    history of metrics).

    models: optional initial `Models` (their device and dtype win);
    None: `init_models(cfg)`.  timings: optional list that receives,
    per iteration, the wall seconds of the collection and of the update
    (each ended by a device synchronize).
    mesh: data-parallel training needs `parallel/`, not ported yet: a
    mesh raises ValueError.
    """
    if mesh is not None:
        raise ValueError(
            "train(mesh=...) needs the data-parallel layer parallel/ "
            "(mesh.py, scaling.py), which the port does not have yet; "
            "train on one device with mesh=None")
    assert cfg.num_envs % 3 == 0, "num_envs must be a multiple of 3"
    if models is None:
        models, _ = init_models(cfg, device=device)
    p = next(models.actor.parameters())
    dev, dtype = p.device, p.dtype
    params = {"actor": models.actor, "critic": models.critic}
    ppo_state = ppo_init(params, cfg.ppo)

    gen = torch.Generator().manual_seed(cfg.seed + 1)
    dev_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    env = make_env(cfg, dtype, dev)
    env_states = env.reset(gen, cfg.num_envs)
    draws = Draws(env, gen, dev_gen)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history = []
    for it in range(cfg.iterations):
        t0 = time.perf_counter()
        env_states, rollout, last_value = collect(params, env, env_states,
                                                  cfg, draws)
        sync()
        t1 = time.perf_counter()
        ppo_state, metrics = ppo_update(ppo_state, rollout, last_value,
                                        _apply_all, cfg.ppo, gen=gen)
        history.append({k: float(v) for k, v in metrics.items()})
        t2 = time.perf_counter()
        if timings is not None:
            timings.append((t1 - t0, t2 - t1))
        if progress is not None:
            progress(it, history[-1])
        if cfg.checkpoint_dir and (it + 1) % cfg.checkpoint_every == 0:
            save_checkpoint(cfg.checkpoint_dir, ppo_state, it + 1)

    return ppo_state, history


def save_checkpoint(path: str, ppo_state: PpoState, step: int):
    """`<path>/step_<step>.npz`: the `{"actor", "critic"}` parameter
    trees under the flax names, in the parameters' dtype (the runner's
    save/load analogue; like the JAX package, parameters only)."""
    os.makedirs(os.path.abspath(path), exist_ok=True)
    tree = {k: flax_from_state_dict(m.state_dict())
            for k, m in ppo_state.params.items()}
    p = next(next(iter(ppo_state.params.values())).parameters())
    dt = np.dtype(str(p.dtype).removeprefix("torch."))
    out = os.path.join(os.path.abspath(path), f"step_{step}.npz")
    save_flax_npz(out, tree, dtype=dt)
    return out


def load_checkpoint(path: str, step: int):
    """The `{"actor", "critic"}` flax trees (numpy leaves) saved by
    `save_checkpoint`; `load_models` or `state_dict_from_flax` turn them
    into modules."""
    return load_flax_npz(os.path.join(os.path.abspath(path),
                                      f"step_{step}.npz"))
