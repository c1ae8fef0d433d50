"""Train the high-level pushing policy, then deploy it (twin of
examples/train_and_deploy_highlevel.py).

  1. PPO-train PhysicActorCritic on the batched push env (`rl/runner.py`
     `train`), or restore its parameters (`--load-ckpt`);
  2. evaluate open-loop velocity-command tracking: 256 lanes x 100 steps,
     128 at command (0.5, 0, 0) and 128 at (0.3, 0, 0.8), the mean
     |realized - commanded| object velocity over the last 50 steps;
  3. drive the perception -> FSM -> policy-controller mission over the
     MessageBus with the policy in the loop (item (2, 0.5) to target
     (4, 2)),

on `--device`.  `--ckpt-dir` writes and `--load-ckpt` reads the port's
checkpoints, `<dir>/step_<iters>.npz` (`rl/runner.py::save_checkpoint`).
The port cannot read orbax: the JAX example's own artifacts
`examples/artifacts/ckpt_physics_6000` and `ckpt_physics_1500` resolve to
their exported actors, `models/weights/highlevel_physics_6000.npz` and
`highlevel_physics_1500.npz`, at step 6000 or 1500 whatever `--iters`
says.

    python -m alore_legged_manipulator_tpu_torch.examples.train_and_deploy_highlevel \
        [--iters N] [--num-envs B] [--physics] [--csv PATH] \
        [--ckpt-dir DIR] [--load-ckpt DIR] [--device cpu]

Exits 0 when the mission is delivered, else 1.
"""
from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np
import torch

from ..mission.object_fsm import FsmState
from ..models.torch_convert import HIGHLEVEL_PHYSICS, load_highlevel_actor
from ..rl.env import env_reset, env_step
from ..rl.eval import actor_mean, steady_state_tracking
from ..rl.ppo import PpoState
from ..rl.runner import (TrainConfig, load_checkpoint, load_models,
                         save_checkpoint, train)
from ..runtime.bus_mission import MissionFsmNode, PerceptionNode, WorldState
from ..runtime.deploy import MessageBus
from ..runtime.highlevel_controller import (HighLevelControllerNode,
                                            make_actor_policy)
from ..utils.precision import resolve_device

# the JAX example's orbax checkpoints (directory name -> step and the
# port's export of its actor)
ORBAX_ARTIFACTS = {f"ckpt_physics_{step}": (step, npz)
                   for step, npz in HIGHLEVEL_PHYSICS.items()}
EVAL_SEED = 123


def restore(path: str, step: int, device):
    """({"actor"[, "critic"]: module}, step) from a port checkpoint
    directory, or from one of the JAX example's orbax artifacts through
    its exported actor."""
    d = Path(path)
    known = ORBAX_ARTIFACTS.get(d.name)
    if known is not None and (d / f"step_{known[0]}").is_dir():
        art_step, npz = known
        return {"actor": load_highlevel_actor(device, npz)}, art_step
    models = load_models(load_checkpoint(path, step), device=device)
    return {"actor": models.actor, "critic": models.critic}, step


def eval_commands(n: int = 256):
    h = n // 2
    return np.concatenate([np.tile([[0.5, 0.0, 0.0]], (h, 1)),
                           np.tile([[0.3, 0.0, 0.8]], (n - h, 1))]
                          ).astype(np.float32)


def tracking_eval(actor, env_cfg, physics: bool, n: int = 256,
                  n_steps: int = 100, settle: int = 50):
    """Steady-state |velocity error| per axis (3,) of the deterministic
    policy under fixed commands, on the env it was trained on."""
    cmds = eval_commands(n)
    if physics:
        from ..rl.env_physics import PhysicsEnvConfig
        return steady_state_tracking(actor, cmds, n_steps, settle,
                                     cfg=PhysicsEnvConfig(base=env_cfg),
                                     seed=EVAL_SEED)
    p = next(actor.parameters())
    c = torch.as_tensor(cmds).to(dtype=p.dtype, device=p.device)
    st = env_reset(torch.Generator().manual_seed(EVAL_SEED), env_cfg,
                   p.dtype, n_envs=n, device=p.device)._replace(cmd=c)
    err = torch.zeros(3, dtype=p.dtype, device=p.device)
    with torch.no_grad():
        for k in range(n_steps):
            st = env_step(st, actor_mean(actor, st), env_cfg)[0]
            if k >= settle:
                err = err + torch.mean(torch.abs(st.obj_vel - c), dim=0)
    return (err / (n_steps - settle)).cpu().numpy()


def bus_mission(actor, physics: bool, device, max_ticks: int = 20000):
    """The perception -> FSM -> policy mission; returns (FSM node, ticks,
    final object error, wall s)."""
    items = [(2.0, 0.5, 0.0)]
    targets = [(4.0, 2.0, 0.0)]
    bus = MessageBus()
    world = WorldState(robot=np.zeros(3),
                       objects=[np.asarray(items[0], float).copy()]
                       + [np.zeros(3)] * 3)
    percept = PerceptionNode(bus, seed=7)
    fsm_node = MissionFsmNode(bus, items, targets, order=[0], dt=0.02)
    ctrl = HighLevelControllerNode(bus, world, make_actor_policy(actor),
                                   physics=physics, device=device)
    t0 = time.time()
    ticks = 0
    while fsm_node.fsm.state != FsmState.DONE and ticks < max_ticks:
        percept.tick(world)
        fsm_node.tick()
        ctrl.tick(dt=0.02)
        ticks += 1
    wall = time.time() - t0
    err = float(np.linalg.norm(world.objects[0][:2]
                               - np.asarray(targets[0])[:2]))
    return fsm_node, ticks, err, wall


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--num-envs", type=int, default=1536)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--physics", action="store_true")
    ap.add_argument("--csv", type=str, default=None)
    ap.add_argument("--load-ckpt", type=str, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("devices:", [torch.cuda.get_device_name(device)]
          if device.type == "cuda" else ["cpu"])
    cfg = TrainConfig(num_envs=args.num_envs, steps_per_env=24,
                      iterations=args.iters, physics_env=args.physics,
                      checkpoint_dir=args.ckpt_dir)

    t0 = time.time()
    log_every = max(args.iters // 10, 1)

    def progress(it, m):
        if (it + 1) % log_every == 0:
            print(f"  iter {it+1:4d}  reward {m['mean_reward']:7.3f}  "
                  f"est_loss {m.get('estimator_loss', float('nan')):7.4f}  "
                  f"kl {m.get('kl', float('nan')):.4f}", flush=True)

    out = {}
    if args.load_ckpt:
        params, step = restore(args.load_ckpt, args.iters, device)
        ppo_state = PpoState(params=params, opt_state=None, lr=0.0)
        history = []
        print(f"restored params from {args.load_ckpt} (step {step})")
    else:
        ppo_state, history = train(cfg, progress=progress, device=device)
        t_train = time.time() - t0
        steps = args.iters * args.num_envs * cfg.steps_per_env
        print(f"trained {steps:.2e} env steps in {t_train:.1f} s "
              f"({steps / t_train:.0f} steps/s)")
        print(f"reward {history[0]['mean_reward']:.3f} -> "
              f"{history[-1]['mean_reward']:.3f}")
        out.update(train_wall_s=t_train, env_steps_per_s=steps / t_train)

    if args.csv:
        Path(args.csv).parent.mkdir(parents=True, exist_ok=True)
        keys = sorted({k for m in history for k in m})
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["iter"] + keys)
            for i, m in enumerate(history):
                w.writerow([i] + [float(m.get(k, float("nan")))
                                  for k in keys])
        print("learning curve ->", args.csv)

    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, ppo_state, args.iters)
        print("checkpoint saved to", args.ckpt_dir)

    # ---- open-loop tracking eval: fixed commands, measure realized vel
    actor = ppo_state.params["actor"]
    t0 = time.time()
    err = tracking_eval(actor, cfg.env, args.physics)
    out["eval_wall_s"] = time.time() - t0
    print(f"steady-state |vel err| per axis: vx {err[0]:.3f}  "
          f"vy {err[1]:.3f}  wz {err[2]:.3f}  (m/s, m/s, rad/s)")

    # ---- mission with the policy in the loop (host loop + the policy and
    # env on the device)
    fsm_node, ticks, errm, t_mission = bus_mission(actor, args.physics,
                                                   device)
    print(f"mission: state={fsm_node.fsm.state.name} ticks={ticks} "
          f"({t_mission:.1f} s wall)  final object error {errm*100:.1f} cm")
    ok = fsm_node.fsm.state == FsmState.DONE and errm < 0.5
    print("TRAINED-POLICY MISSION", "DELIVERED" if ok else "FAILED")
    out.update(ok=ok, history=history, params=ppo_state.params,
               eval_err=err.tolist(), mission_state=fsm_node.fsm.state.name,
               mission_ticks=ticks, mission_err=errm,
               mission_wall_s=t_mission)
    return out


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
