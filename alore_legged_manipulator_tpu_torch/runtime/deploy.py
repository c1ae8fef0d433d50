"""Real-robot deployment runtime (structure rebuild).

Rebuild of Deployment/B2_deploy/deploy_real_b2z1_obj.py (`Controller`):
the 50 Hz dual-policy loop that turns estimated state + mission commands
into joint targets:

  * state machine zero_torque -> move_to_default -> policy
    (:29-120 init, :319-467 low level, :468-562 high level)
  * low-level WBC policy: 18 joint targets at kp 360 / kd 5 from a 799-d
    observation (proprio + scan + history)
  * high-level policy: 9-d action (object velocity + arm deltas) from the
    770-d observation history
  * transport: Unitree DDS LowCmd/LowState in the reference; here an
    abstract MessageBus so the same controller runs against the
    simulation plant, a log replayer, or a real DDS bridge process.

No robot hardware exists in this environment; the value here is the
runtime contract: observation assembly, action scaling, gain scheduling
and the safety state machine, executing the port's policies from
`models/` (port of runtime/deploy.py).  The state machine and the bus
are host Python; the policies run on the device their module lives on
(`make_low_level_fn`), and the observation assembly on the device of
its carry (`run_obs_assembly_tick`).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch


class DeployState(enum.Enum):
    ZERO_TORQUE = 0
    MOVE_TO_DEFAULT = 1
    POLICY = 2
    EMERGENCY = 3
    DEFAULT_HOLD = 4   # at default pose, waiting for the operator's A


@dataclass
class DeployConfig:
    """Gains/scales per B2_deploy/configs/b2z1.yaml."""

    control_dt: float = 0.02          # 50 Hz
    kp: float = 360.0
    kd: float = 5.0
    stand_kp: float = 700.0
    stand_kd: float = 10.0
    arm_kp: float = 400.0
    arm_kd: float = 40.0
    action_scale: float = 0.25
    move_to_default_s: float = 2.0
    n_joints: int = 18
    default_pose: np.ndarray = field(
        default_factory=lambda: np.zeros(18))


@dataclass
class JointCommand:
    q_target: np.ndarray   # (18,)
    kp: np.ndarray         # (18,)
    kd: np.ndarray         # (18,)


class MessageBus:
    """Transport abstraction standing in for DDS pub/sub.

    publish/subscribe by topic name with latest-value semantics --
    enough to wire the controller to a simulated plant in-process, and
    the same interface a real DDS bridge implements out-of-process.
    """

    def __init__(self):
        self._latest = {}
        self._subs = {}

    def publish(self, topic: str, msg):
        self._latest[topic] = msg
        for cb in self._subs.get(topic, []):
            cb(msg)

    def latest(self, topic: str):
        return self._latest.get(topic)

    def subscribe(self, topic: str, cb: Callable):
        self._subs.setdefault(topic, []).append(cb)


@dataclass
class DeployController:
    """50 Hz dual-policy runtime over a MessageBus."""

    bus: MessageBus
    low_level_fn: Callable    # (prop, prop_hist) -> 18 joint deltas
    high_level_fn: Optional[Callable] = None  # obs_hist -> 9-d action
    cfg: DeployConfig = field(default_factory=DeployConfig)
    # optional operator channel (runtime/remote.py): when present, state
    # transitions follow the reference's button sequencing -- start to
    # leave zero-torque, A to arm the policy, select to stop
    # (deploy_real_b2z1_obj.py:606-620); the bus topic "wireless_remote"
    # feeds it raw frames
    remote: Optional[object] = None

    state: DeployState = DeployState.ZERO_TORQUE
    t_in_state: float = 0.0
    start_pose: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.remote is not None:
            self.bus.subscribe("wireless_remote", self.remote.feed)

    def request_policy(self):
        if self.state == DeployState.ZERO_TORQUE:
            self.state = DeployState.MOVE_TO_DEFAULT
            self.t_in_state = 0.0
            js = self.bus.latest("low_state")
            self.start_pose = np.asarray(js["q"]) if js else \
                np.zeros(self.cfg.n_joints)

    def emergency_stop(self):
        self.state = DeployState.EMERGENCY

    def _apply_remote_gating(self):
        from .remote import GatePhase
        g = self.remote
        if g.phase == GatePhase.STOPPED:
            self.state = DeployState.EMERGENCY
        elif self.state == DeployState.ZERO_TORQUE \
                and g.phase >= GatePhase.RAMPING:
            self.request_policy()
        elif self.state == DeployState.DEFAULT_HOLD \
                and g.phase == GatePhase.ARMED:
            self.state = DeployState.POLICY
            self.t_in_state = 0.0

    def tick(self) -> JointCommand:
        c = self.cfg
        n = c.n_joints
        if self.remote is not None:
            self._apply_remote_gating()
        self.t_in_state += c.control_dt
        low = self.bus.latest("low_state") or {
            "q": np.zeros(n), "dq": np.zeros(n),
            "prop": np.zeros(33), "prop_hist": np.zeros((10, 33))}

        if self.state == DeployState.ZERO_TORQUE:
            cmd = JointCommand(np.asarray(low["q"]), np.zeros(n),
                               np.zeros(n))
        elif self.state == DeployState.EMERGENCY:
            cmd = JointCommand(np.asarray(low["q"]), np.zeros(n),
                               np.full(n, c.kd))
        elif self.state == DeployState.MOVE_TO_DEFAULT:
            a = min(self.t_in_state / c.move_to_default_s, 1.0)
            q = (1 - a) * self.start_pose + a * c.default_pose
            gains_p = np.full(n, c.stand_kp)
            gains_p[12:] = c.arm_kp
            gains_d = np.full(n, c.stand_kd)
            gains_d[12:] = c.arm_kd
            cmd = JointCommand(q, gains_p, gains_d)
            if a >= 1.0:
                if self.remote is not None:
                    self.remote.ramp_done()
                    self.state = DeployState.DEFAULT_HOLD
                else:
                    self.state = DeployState.POLICY
                self.t_in_state = 0.0
        elif self.state == DeployState.DEFAULT_HOLD:
            gains_p = np.full(n, c.stand_kp)
            gains_p[12:] = c.arm_kp
            gains_d = np.full(n, c.stand_kd)
            gains_d[12:] = c.arm_kd
            cmd = JointCommand(np.asarray(c.default_pose, float), gains_p,
                               gains_d)
        else:  # POLICY
            # high level (if present) publishes the velocity/arm command
            if self.high_level_fn is not None:
                hl_obs = self.bus.latest("hl_obs_hist")
                if hl_obs is not None:
                    action = _host(self.high_level_fn(hl_obs))
                    self.bus.publish("hl_action", action)
            deltas = _host(
                self.low_level_fn(torch.as_tensor(np.asarray(low["prop"])),
                                  torch.as_tensor(
                                      np.asarray(low["prop_hist"]))))
            # legs-only action passthrough: arm targets come from the FSM
            # (env_train.py:524 action_low_level[:, 12:] = 0)
            deltas = deltas.copy()
            deltas[12:] = 0.0
            q = c.default_pose + c.action_scale * deltas
            gains_p = np.full(n, c.kp)
            gains_p[12:] = c.arm_kp
            gains_d = np.full(n, c.kd)
            gains_d[12:] = c.arm_kd
            cmd = JointCommand(q, gains_p, gains_d)

        self.bus.publish("low_cmd", cmd)
        return cmd


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_low_level_fn(low_policy):
    """Checkpoint-faithful low-level policy callable for the controller.

    Wraps the port's `ActorCriticLow` (weights loaded, for example from
    `models/torch_convert.convert_low_level_actor`) in the deployment
    call convention: a plain function of (prop (71,), prop_hist
    (10, 71)) tensors, moved to the module's device and dtype, with
    hist_encoding=True semantics (the priv slot of the 799-d layout is
    ignored by the history-encoding path, low_level_model.py:231).
    Returns the (18,) joint deltas on the module's device.
    """
    p = next(low_policy.parameters())

    def fn(prop, prop_hist):
        with torch.no_grad():
            prop = torch.as_tensor(prop).to(device=p.device, dtype=p.dtype)
            hist = torch.as_tensor(prop_hist).to(device=p.device,
                                                 dtype=p.dtype)
            return low_policy(prop[None], hist[None])[0]

    return fn


def run_obs_assembly_tick(obs_state, low_state, vel_cmd, cfg: DeployConfig):
    """One 50 Hz observation-assembly tick in the deployment layout.

    low_state: dict with roll, pitch, ang_vel (3,), q (18,), dq (18,)
    (the fields a DDS LowState bridge provides).  Computed on the device
    and in the dtype of `obs_state` (`LowObsState.create`, float32 as
    the JAX package's).  Returns (new_obs_state, prop (71,), obs799) --
    obs799 is what the reference feeds its jit-exported policy
    (configs/b2z1.yaml num_obs 799).
    """
    from .obs_assembly import assemble_low_level_obs

    dt = dict(dtype=obs_state.hist.dtype, device=obs_state.hist.device)

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(**dt)

    return assemble_low_level_obs(
        obs_state,
        t(low_state.get("roll", 0.0)),
        t(low_state.get("pitch", 0.0)),
        t(low_state.get("ang_vel", np.zeros(3))),
        t(low_state["q"]),
        t(low_state["dq"]),
        t(cfg.default_pose),
        t(vel_cmd),
        cfg.control_dt)
