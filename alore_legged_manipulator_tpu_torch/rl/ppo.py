"""PPO with physics-estimator supervision (port of rl/ppo.py).

Mirrors rsl_rl/Physic_ppo.py + the standard rsl_rl PPO it extends:
clipped surrogate + clipped value loss, GAE(gamma=0.99, lam=0.95),
entropy bonus, adaptive learning rate on the KL divergence (desired KL
0.01), gradient clipping -- and the estimator head trained by MSE against
the privileged object velocities inside the same update
(Physic_ppo.py:62-77, agents/rsl_rl_ppo_cfg.py:20-41).

The parameters live in `torch.nn` modules: `PpoState.params` is a dict
of modules (`{"actor": PhysicActorCritic, "critic": Critic}` in the
runner), updated in place.  optax's chain becomes:

  * `clip_by_global_norm_`: optax's clip written out over every trainable
    parameter of every module together (`t / g_norm * max_norm` when
    `g_norm >= max_norm`, no epsilon; `torch.nn.utils.clip_grad_norm_`
    divides by `g_norm + 1e-6` instead), with no host read;
  * `torch.optim.Adam` (b1 0.9, b2 0.999, eps 1e-8, no weight decay):
    `scale_by_adam`'s update up to rounding;
  * the adaptive learning rate multiplies the Adam update, so it is the
    optimizer's `lr`, set once per epoch from the epoch's mean KL (one
    host read an epoch), clamped to [1e-5, 1e-2].

Minibatches are slices of one permutation per epoch, drawn from a CPU
`torch.Generator` or given (`perms`, (epochs, n)), so that a parity run
can inject the JAX package's `jax.random.permutation` draws.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

LOG_2PI = math.log(2 * math.pi)
ENTROPY_CONST = 0.5 * math.log(2 * math.pi * math.e)


class PpoConfig(NamedTuple):
    lr: float = 1.0e-3
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    value_clip: float = 0.2
    entropy_coef: float = 0.008
    value_coef: float = 1.0
    estimator_coef: float = 1.0
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    epochs: int = 5
    minibatches: int = 4


class PpoState(NamedTuple):
    params: Any          # {name: nn.Module}, updated in place
    opt_state: Any       # torch.optim.Adam over their trainable parameters
    lr: float


class Rollout(NamedTuple):
    obs_hist: torch.Tensor     # (S, B, T, D)
    graph_nodes: torch.Tensor  # (S, B, 9, 15)
    graph_edges: torch.Tensor  # (S, B, E, 7)
    critic_obs: torch.Tensor   # (S, B, C)
    actions: torch.Tensor      # (S, B, A)
    log_probs: torch.Tensor    # (S, B)
    values: torch.Tensor       # (S, B)
    rewards: torch.Tensor      # (S, B)
    dones: torch.Tensor        # (S, B)
    vel_targets: torch.Tensor  # (S, B, 3) privileged object velocities


def gaussian_log_prob(mean, std, action):
    var = std ** 2
    return torch.sum(-0.5 * ((action - mean) ** 2 / var)
                     - torch.log(std) - 0.5 * LOG_2PI, dim=-1)


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """values/rewards/dones: (S, B); returns (advantages, returns)."""
    d = dones.to(rewards.dtype)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    adv = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        nonterminal = 1.0 - d[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    adv = torch.stack(adv)
    return adv, adv + values


def trainable_parameters(params):
    """The trainable parameters of a dict of modules, in a fixed order
    (the LSTM's input-side bias, which flax does not have, is frozen)."""
    return [p for m in params.values() for p in m.parameters()
            if p.requires_grad]


def clip_by_global_norm_(grads, max_norm: float):
    """optax.clip_by_global_norm in place on a list of gradients: scaled
    by `max_norm / g_norm` (as `t / g_norm * max_norm`) when `g_norm >=
    max_norm`, untouched below; the selection is arithmetic, so nothing
    is read back to the host.  Returns g_norm."""
    sq = torch._foreach_mul(grads, grads)
    g_norm = torch.sqrt(sum(torch.sum(s) for s in sq))
    below = g_norm < max_norm
    keep = below.to(g_norm.dtype)
    scaled = torch._foreach_div(grads, torch.where(below, 1.0, g_norm))
    torch._foreach_mul_(scaled, max_norm * (1.0 - keep))
    torch._foreach_mul_(grads, keep)
    torch._foreach_add_(grads, scaled)
    return g_norm


def ppo_init(params, cfg: PpoConfig = PpoConfig()) -> PpoState:
    opt = torch.optim.Adam(trainable_parameters(params), lr=cfg.lr,
                           betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    return PpoState(params=params, opt_state=opt, lr=float(cfg.lr))


def _loss(params, flat, adv_f, ret_f, idx, apply_fn, cfg: PpoConfig):
    mean, std, value, vel_est = apply_fn(
        params, flat.obs_hist[idx], flat.graph_nodes[idx],
        flat.graph_edges[idx], flat.critic_obs[idx])
    old_logp = flat.log_probs[idx]
    logp = gaussian_log_prob(mean, std, flat.actions[idx])
    ratio = torch.exp(logp - old_logp)
    a = adv_f[idx]
    surr = torch.minimum(ratio * a,
                         torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * a)
    policy_loss = -torch.mean(surr)

    v_old = flat.values[idx]
    ret = ret_f[idx]
    v_clip = v_old + torch.clamp(value - v_old, -cfg.value_clip,
                                 cfg.value_clip)
    v_loss = torch.mean(torch.maximum((value - ret) ** 2,
                                      (v_clip - ret) ** 2))
    ent = torch.sum(torch.log(std) + ENTROPY_CONST, dim=-1)
    entropy = torch.mean(ent) if std.ndim else ent
    est_loss = torch.mean((vel_est - flat.vel_targets[idx]) ** 2)
    kl = torch.mean(old_logp - logp)
    total = (policy_loss + cfg.value_coef * v_loss
             - cfg.entropy_coef * entropy
             + cfg.estimator_coef * est_loss)
    return total, (policy_loss, v_loss, est_loss, kl)


def draw_permutations(n: int, epochs: int, gen: torch.Generator):
    """One permutation of range(n) per epoch, from the CPU generator."""
    return torch.stack([torch.randperm(n, generator=gen)
                        for _ in range(epochs)])


def ppo_update(state: PpoState, rollout: Rollout, last_value, apply_fn,
               cfg: PpoConfig = PpoConfig(), gen: torch.Generator = None,
               perms=None):
    """One PPO learning phase over a rollout, on the rollout's device.

    apply_fn(params, obs_hist, nodes, edges, critic_obs) ->
      (mean, std, value, vel_est).
    perms: optional (epochs, S*B) permutations; else drawn from `gen`
    (None: a generator seeded 0).
    Returns (new_state, metrics dict of 0-d tensors); the modules of
    `state.params` and the optimizer are updated in place.
    """
    S, B = rollout.rewards.shape
    dev = rollout.rewards.device
    with torch.no_grad():
        adv, returns = compute_gae(rollout.rewards, rollout.values,
                                   rollout.dones, last_value,
                                   cfg.gamma, cfg.lam)
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    flat = Rollout(*(x.reshape((S * B,) + x.shape[2:]) for x in rollout))
    adv_f = adv_n.reshape(-1)
    ret_f = returns.reshape(-1)

    n = S * B
    mb = n // cfg.minibatches
    if perms is None:
        perms = draw_permutations(
            n, cfg.epochs, gen if gen is not None
            else torch.Generator().manual_seed(0))
    perms = torch.as_tensor(perms).to(device=dev, dtype=torch.long)

    opt = state.opt_state
    params = trainable_parameters(state.params)
    lr = state.lr
    auxs = []
    for e in range(cfg.epochs):
        for group in opt.param_groups:
            group["lr"] = lr
        kl_sum = 0.0
        for k in range(cfg.minibatches):
            idx = perms[e, k * mb:(k + 1) * mb]
            opt.zero_grad(set_to_none=True)
            total, aux = _loss(state.params, flat, adv_f, ret_f, idx,
                               apply_fn, cfg)
            total.backward()
            with torch.no_grad():
                clip_by_global_norm_([p.grad for p in params],
                                     cfg.max_grad_norm)
            opt.step()
            aux = torch.stack([x.detach() for x in aux])
            auxs.append(aux)
            kl_sum = kl_sum + aux[3]
        # adaptive LR on mean KL (rsl_rl schedule)
        kl_mean = abs(float(kl_sum / cfg.minibatches))
        if kl_mean > cfg.desired_kl * 2.0:
            lr = max(lr / 1.5, 1e-5)
        elif kl_mean < cfg.desired_kl / 2.0:
            lr = min(lr * 1.5, 1e-2)

    m = torch.stack(auxs).mean(dim=0)
    metrics = {
        "policy_loss": m[0],
        "value_loss": m[1],
        "estimator_loss": m[2],
        "kl": m[3],
        "lr": torch.tensor(lr, dtype=torch.float64),
        "mean_reward": torch.mean(rollout.rewards),
    }
    return PpoState(params=state.params, opt_state=opt, lr=lr), metrics
