"""High-level policy controller node: the Isaac runtime twin (port of
runtime/highlevel_controller.py).

Rebuild of Simulation/isaac_b2_controller/b2z1_highlevel_controller.py:
the process that loads the trained high-level policy, subscribes the
mission FSM's 15-float `/env_control_data` (env_control_callback
:92-100), steps the environment with the policy's actions
(`actions = policy(obs, critic_obs); env.step(actions)` :233-235), and
publishes the robot+object poses on `/env_obs` (publish_obs_data
:103-111, 230).

The environment is the surrogate (rl/env.py) or, with `physics=True`,
the contact plant (rl/env_physics.py), one lane on `device` (None: the
card); the policy is the port's `PhysicActorCritic` (for example
`models/torch_convert.load_highlevel_actor()`, the trained contact-plant
checkpoint).  The node honors the task-state gating the reference FSM
relies on:

  * ROBOT_TRACKING / GRASPING -- the robot base tracks robot_vel_cmd
    kinematically;
  * OBJECT_TRACKING -- the POLICY is in the loop: `/env_control_data`'s
    object_vel_cmd becomes the env command, the policy produces the
    9-d action from its observation history + interaction graph, and
    the env step advances the pushed object; the robot stays attached
    behind the object;
  * other states -- commands idle, the object coasts to rest.

As in the JAX package, the env is reset in float32, and the FSM's
command, the action and the anchored object pose cross into it as
float32.  Anchor resets draw from a
generator seeded `seed + 7919 * obj_id` (the JAX package seeds a PRNG
key the same way; the streams differ).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..rl.env import PushEnvConfig, PushEnvState, env_reset, env_step
from ..rl.eval import actor_mean
from ..utils.precision import resolve_device
from .bus_mission import TOPIC_CTRL, TOPIC_OBS, WorldState
from .contracts import EnvControlData, EnvObs, TaskState
from .deploy import MessageBus, _host

ATTACH_DIST = 0.55   # robot base behind the pushed object (FSM grasp servo)


def make_actor_policy(actor) -> Callable:
    """Inference policy from a `PhysicActorCritic` (runner
    get_inference_policy analogue): deterministic mean action.

    policy_fn(obs_hist (11, 70), env_state (one-lane surrogate view))
    -> (9,) tensor on the actor's device.  The interaction graph is
    built on the device inside the call; nothing is read back to the
    host."""

    def policy_fn(obs_hist, env_state: PushEnvState):
        with torch.no_grad():
            return actor_mean(actor, env_state._replace(
                obs_hist=obs_hist[None]))[0]

    return policy_fn


def make_oracle_policy(cfg: PushEnvConfig = PushEnvConfig()) -> Callable:
    """Perfect-tracking stand-in policy for tests/demos without a trained
    checkpoint: reads the commanded velocity out of its OWN observation
    (the commands block at slots 50:53 of the newest obs row, scaled by
    commands_scale -- rl/obs_layout actor layout) and emits the action
    that requests exactly that velocity (host numpy, float32)."""
    from ..rl.obs_layout import COMMANDS_SCALE
    scales = np.array([cfg.action_scale_lin, cfg.action_scale_lin,
                       cfg.action_scale_ang], np.float32)
    cmd_scale = np.asarray(COMMANDS_SCALE, np.float32)

    def policy_fn(obs_hist, env_state: PushEnvState):
        cmd = _host(obs_hist[-1, 50:53]) / cmd_scale
        a = np.zeros(9, np.float32)
        a[:3] = np.clip(cmd / scales, -1.0, 1.0)
        return a

    return policy_fn


@dataclass
class HighLevelControllerNode:
    """`/env_control_data` -> policy -> env step -> `/env_obs` world update.

    Mutates `world` (the shared ground truth the perception node
    observes), mirroring how the Isaac process owns the scene state.
    """

    bus: MessageBus
    world: WorldState
    policy_fn: Callable                # (obs_hist, env_state) -> action (9,)
    env_cfg: PushEnvConfig = field(default_factory=PushEnvConfig)
    seed: int = 0
    # True: step the CONTACT-PLANT env (rl/env_physics) instead of the
    # surrogate -- required when the deployed policy was trained on it
    physics: bool = False
    device: Optional[object] = None

    def __post_init__(self):
        self._latest: Optional[EnvControlData] = None
        self._active_obj: Optional[int] = None
        self._dev = resolve_device(self.device)
        gen = torch.Generator().manual_seed(self.seed)
        if self.physics:
            from ..rl import env_physics as ep
            pcfg = ep.PhysicsEnvConfig(base=self.env_cfg)
            self._phys_cfg = pcfg
            self.env_state = ep.env_reset(gen, pcfg, device=self._dev)
            self._step = lambda st, a: ep.env_step(st, a, pcfg)
            self._view = ep.as_surrogate_view
        else:
            self.env_state = env_reset(gen, self.env_cfg, device=self._dev)
            self._step = lambda st, a: env_step(st, a, self.env_cfg)
            self._view = lambda s: s
        self.bus.subscribe(TOPIC_CTRL, self._on_ctrl)

    def _on_ctrl(self, data):
        self._latest = EnvControlData.unpack(data)

    def _f32(self, x):
        return torch.as_tensor(_host(x).astype(np.float32),
                               device=self._dev)

    def reset_physics(self, obj_id: int, pose32):
        """A fresh docked contact scene at the object's pose (float32
        (3,) tensor): robot at the grasp anchor, weld active,
        class-consistent geometry."""
        from ..rl import env_physics as ep
        gen = torch.Generator().manual_seed(self.seed + 7919 * obj_id)
        return ep.env_reset(gen, self._phys_cfg, obj_type=obj_id % 3,
                            obj_pose=pose32, device=self._dev)

    def _anchor_env_to(self, obj_id: int):
        """Re-anchor the env to the object being pushed (object_type slot
        of /env_control_data selects it; env class = id mod 3)."""
        pose = self._f32(self.world.objects[obj_id])
        if self.physics:
            self.env_state = self.reset_physics(obj_id, pose)
        else:
            self.env_state = self.env_state._replace(
                obj_pose=pose[None],
                obj_vel=torch.zeros(1, 3, dtype=torch.float32,
                                    device=self._dev),
                obj_type=torch.full((1,), obj_id % 3, dtype=torch.int64,
                                    device=self._dev))
        self._active_obj = obj_id

    def tick(self, dt: float = 0.02):
        if self._latest is None:
            return
        cmd = self._latest
        w = self.world
        st_task = cmd.task_state

        if st_task in (TaskState.ROBOT_TRACKING, TaskState.GRASPING):
            v = cmd.robot_vel_cmd
            w.robot[0] += v[0] * np.cos(w.robot[2]) * dt
            w.robot[1] += v[0] * np.sin(w.robot[2]) * dt
            w.robot[2] += v[2] * dt
            w.grasped = None
        elif st_task == TaskState.OBJECT_TRACKING:
            obj_id = int(cmd.object_type)
            if self._active_obj != obj_id:
                self._anchor_env_to(obj_id)
            w.grasped = obj_id
            # the FSM's commanded object velocity becomes the env command
            es = self.env_state._replace(cmd=self._f32(cmd.object_vel_cmd)[None])
            vw = self._view(es)
            action = self.policy_fn(vw.obs_hist[0], vw)
            es, _, _, _ = self._step(es, self._f32(action)[None])
            self.env_state = es
            pose = _host(self._view(es).obj_pose[0]).astype(float)
            w.objects[obj_id][:] = pose
            # robot attached behind the object (bus_mission convention)
            w.robot[:] = [pose[0] - ATTACH_DIST * np.cos(pose[2]),
                          pose[1] - ATTACH_DIST * np.sin(pose[2]), pose[2]]
        else:
            # idle states: active object coasts to rest under zero command
            if self._active_obj is not None and w.grasped is not None:
                es = self.env_state._replace(cmd=torch.zeros(
                    1, 3, dtype=torch.float32, device=self._dev))
                es, _, _, _ = self._step(es, torch.zeros(
                    1, 9, dtype=torch.float32, device=self._dev))
                self.env_state = es
                w.objects[w.grasped][:] = _host(
                    self._view(es).obj_pose[0]).astype(float)

    def publish_obs(self):
        """publish_obs_data twin: robot + object rows on /env_obs."""
        obs = EnvObs()
        obs.robot.xyz[:2] = self.world.robot[:2]
        obs.robot.yaw = float(self.world.robot[2])
        for i, p in enumerate(self.world.objects[:4]):
            obs.objects[i].xyz[:2] = p[:2]
            obs.objects[i].yaw = float(p[2])
        self.bus.publish(TOPIC_OBS, obs.pack())
        return obs
