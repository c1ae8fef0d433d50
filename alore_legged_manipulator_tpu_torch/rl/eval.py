"""Evaluation of the high-level policy (port of rl/eval.py).

Rebuild of env_train.py's offline-analysis loggers
(log_vel_tracking_result :1238-1290, log_joint_effort/-position
:1292-1400): roll a policy over a batch of eval envs and record, per
step and per env, the commanded vs realized object velocity (vx, vy,
omega) plus rewards, then write one CSV per environment for offline
tracking-accuracy analysis.  The rollout runs on the device of the
policy, one batched step per control tick; only the final arrays come
to the host.

`rollout_tracking` takes the actor: a `PhysicActorCritic`, or the
training runner's `Models` (`rl/runner.py`), whose modules hold their
parameters (the JAX package takes the runner's models and parameters
apart).  `steady_state_tracking` is the served
policy's fixed-command eval of examples/train_and_deploy_highlevel.py
(lines 124-156) on the contact-plant env it was trained on.
"""
from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from ..models.gnn import build_interaction_graph
from .env import PushEnvConfig, env_reset, env_step, graph_features


def actor_mean(actor, views):
    """Deterministic (mean) action of `actor` on a batch of surrogate
    views: the interaction graphs are built from the views' features."""
    g = build_interaction_graph(*graph_features(views))
    mean, _, _ = actor(views.obs_hist, g)
    return mean


def rollout_tracking(actor, n_envs: int, n_steps: int,
                     cfg: PushEnvConfig = PushEnvConfig(), seed: int = 0,
                     states=None):
    """Deterministic (mean-action) eval rollout on the surrogate env, on
    the actor's device and in its dtype; resets drawn from a generator
    seeded `seed`, or `states` (n_envs lanes) given.  `actor`: a
    `PhysicActorCritic` or the runner's `Models`.

    Returns dict of (n_steps, n_envs, ...) numpy arrays: commanded and
    realized object velocity, reward, done.
    """
    actor = getattr(actor, "actor", actor)
    p = next(actor.parameters())
    st = states
    if st is None:
        st = env_reset(torch.Generator().manual_seed(seed), cfg, p.dtype,
                       n_envs=n_envs, device=p.device)
    log = {k: [] for k in ("cmd", "vel", "reward", "done")}
    with torch.no_grad():
        for _ in range(n_steps):
            action = actor_mean(actor, st)
            st, _, reward, done = env_step(st, action, cfg)
            log["cmd"].append(action[:, :3])
            log["vel"].append(st.obj_vel)
            log["reward"].append(reward)
            log["done"].append(done)
    return {k: torch.stack(v).cpu().numpy() for k, v in log.items()}


def steady_state_tracking(actor, cmds, n_steps: int = 100, settle: int = 50,
                          cfg=None, seed: int = 0, states=None,
                          step_times=None):
    """Fixed-command tracking eval on the contact-plant env
    (examples/train_and_deploy_highlevel.py:124-156, `--physics`): one
    lane per row of `cmds` (B, 3), each reset from a generator seeded
    `seed` (or `states`, B lanes, given), its command overwritten;
    `n_steps` policy steps under `cfg` (a PhysicsEnvConfig; None: the
    default).  Returns the mean |realized - commanded| object velocity
    per axis over the steps after `settle`, a (3,) numpy array.
    step_times: optional list that receives each step's wall seconds
    (ended by a device synchronize)."""
    from . import env_physics as ep

    cfg = cfg or ep.PhysicsEnvConfig()
    p = next(actor.parameters())
    dev, dtype = p.device, p.dtype
    cmds = torch.as_tensor(np.asarray(cmds)).to(dtype=dtype, device=dev)
    st = states if states is not None else ep.env_reset(
        torch.Generator().manual_seed(seed), cfg, dtype,
        n_envs=cmds.shape[0], device=dev)
    st = st._replace(cmd=cmds)
    err = torch.zeros(3, dtype=dtype, device=dev)
    with torch.no_grad():
        for k in range(n_steps):
            t0 = time.perf_counter()
            st = ep.env_step(st, actor_mean(actor, ep.as_surrogate_view(st)),
                             cfg)[0]
            if k >= settle:
                vel = ep.as_surrogate_view(st).obj_vel
                err = err + torch.mean(torch.abs(vel - cmds), dim=0)
            if step_times is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                step_times.append(time.perf_counter() - t0)
    return (err / (n_steps - settle)).cpu().numpy()


def write_tracking_csvs(log, out_dir: str):
    """One CSV per env: step, cmd_vx, cmd_vy, cmd_wz, vx, vy, wz,
    reward, done (the log_vel_tracking_result file layout)."""
    os.makedirs(out_dir, exist_ok=True)
    n_steps, n_envs = log["reward"].shape
    paths = []
    for e in range(n_envs):
        path = os.path.join(out_dir, f"vel_tracking_env{e:03d}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", "cmd_vx", "cmd_vy", "cmd_wz",
                        "vx", "vy", "wz", "reward", "done"])
            for t in range(n_steps):
                w.writerow([t, *log["cmd"][t, e].tolist(),
                            *log["vel"][t, e].tolist(),
                            float(log["reward"][t, e]),
                            int(log["done"][t, e])])
        paths.append(path)
    return paths


def tracking_summary(log):
    """Aggregate tracking-accuracy metrics (the offline analysis the
    reference performs on its CSVs)."""
    err = log["cmd"] - log["vel"]
    rms = np.sqrt((err ** 2).mean(axis=(0, 1)))
    return {
        "rms_err_vx": float(rms[0]),
        "rms_err_vy": float(rms[1]),
        "rms_err_wz": float(rms[2]),
        "mean_reward": float(log["reward"].mean()),
        "done_rate": float(log["done"].mean()),
    }
