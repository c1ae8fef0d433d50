"""Count the PyTorch operations the training iteration and the camera
frame dispatch, on the CPU at a small width (the count does not depend
on the width): what a launch-bound path pays for on any device, the
basis of the card-time predictions in PERF.md.

    python tests/train_dispatch_counts.py

Prints one JSON object: one contact-plant env step; the rest of one
collection step (graph, critic observation, actor and critic forward,
noise, log-probability); the auto-reset of the finished lanes drawn the
JAX package's way (fresh states for every lane, selected by `done`
field by field) and the port's way (fresh states for the done lanes
only: with none done, and with one done); one PPO update of one
minibatch (GAE, normalisation, forward, backward, clip, one Adam step);
a whole iteration (24 steps, 20 minibatches); one camera frame of the
perception node (render, color, masks).
"""
import json
import pathlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = pathlib.Path(__file__).resolve().parent.parent


def count(fn, grad=False) -> int:
    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count(), torch.set_grad_enabled(grad):
        fn()
    return Count.n


def main():
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        TRAIN_INIT_PHYSICS_SEED0, load_flax_npz)
    from alore_legged_manipulator_tpu_torch.rl import ppo as pp
    from alore_legged_manipulator_tpu_torch.rl import registry
    from alore_legged_manipulator_tpu_torch.rl import runner as rn
    from alore_legged_manipulator_tpu_torch.runtime import (
        camera_perception as cp)
    from alore_legged_manipulator_tpu_torch.runtime.deploy import MessageBus

    torch.set_num_threads(2)
    B = 12
    cfg = registry.make("Alore-Push-Flat-v0", num_envs=B, steps_per_env=24,
                        physics_env=True)
    models = rn.load_models(load_flax_npz(TRAIN_INIT_PHYSICS_SEED0),
                            device="cpu")
    params = {"actor": models.actor, "critic": models.critic}
    env = rn.make_env(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    st = env.reset(gen, B)
    draws = rn.Draws(env, gen, torch.Generator().manual_seed(1))
    a = torch.zeros(B, 9)
    out = {"env_step": count(lambda: env.step(st, a))}
    per_step = count(lambda: rn.collect(
        params, env, st, cfg._replace(steps_per_env=2), draws)) \
        - count(lambda: rn.collect(params, env, st,
                                   cfg._replace(steps_per_env=1), draws))
    out["collect_step_rest"] = per_step - out["env_step"]
    none = torch.zeros(B, dtype=torch.bool)
    lane = none.clone()
    lane[3] = True

    def reset_all():
        fresh = env.reset(gen, B)
        rn._tree_map(lambda f, x: torch.where(
            lane.view((-1,) + (1,) * (x.ndim - 1)), f, x), fresh, st)
    out["reset_all_lanes_select"] = count(reset_all)
    out["reset_done_lanes_none_done"] = count(
        lambda: draws.reset_done(0, st, none))
    out["reset_done_lanes_one_done"] = count(
        lambda: draws.reset_done(0, st, lane))
    _, ro, last = rn.collect(params, env, st, cfg._replace(steps_per_env=2),
                             draws)
    mb1 = pp.PpoConfig(epochs=1, minibatches=1)
    out["update_one_minibatch"] = count(lambda: pp.ppo_update(
        pp.ppo_init(params, mb1), ro, last, rn._apply_all, mb1), grad=True)
    out["collect_iteration"] = count(lambda: rn.collect(params, env, st, cfg,
                                                        draws))
    _, ro, last = rn.collect(params, env, st, cfg, draws)
    out["update_iteration"] = count(lambda: pp.ppo_update(
        pp.ppo_init(params, cfg.ppo), ro, last, rn._apply_all, cfg.ppo),
        grad=True)
    node = cp.CameraPerceptionNode(MessageBus(), n_objects=2, device="cpu")
    node._ensure_render()
    args = (np.zeros(3, np.float32), np.asarray([[3.0, 0.5], [3.0, -1.0]],
                                                np.float32),
            np.zeros(2, np.float32))
    out["camera_frame"] = count(lambda: node._render(*args))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
