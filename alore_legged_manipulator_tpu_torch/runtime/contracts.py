"""Typed runtime message contracts + synthetic mocap perception.

The port's own copy of the JAX package's module of the same name (host
numpy only), so that the port imports nothing of that package.

The reference wires its mission layer over two Float32MultiArray topics
plus the carstatemsgs package; round-1 VERDICT flagged that none of
these schemas existed here.  This module defines them as typed records
with exact pack/unpack layouts:

  * EnvControlData -- the 15-float `/env_control_data` downlink
    (Simulation/isaac_b2_controller/b2z1_highlevel_controller.py:92-100):
    robot_vel_cmd[3], object_vel_cmd[3], joint_cmd[7], task_state,
    object_type.
  * EnvObs -- the `/env_obs` uplink as the mocap perception publishes it
    (Deployment/perception/env_perception_mocap.py:16-19, 29-30): one
    robot row + 4 object rows, each 8 floats (x, y, z, yaw, qx, qy, qz,
    qw), flattened robot-first.
  * CarState / CarControl / SimulatedCarState -- the carstatemsgs
    contracts (utils/carstatemsgs/msg/*.msg) used between simulator,
    EKF and controllers.
  * MocapPerception -- a synthetic rigid-body source standing in for the
    VRPN client: true world poses + Gaussian noise -> EnvObs, including
    the reference's +90 deg x-axis quaternion correction
    (env_perception_mocap.py:41-50).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

N_OBJECTS = 4  # the mocap node tracks 4 rigid bodies (mocap.py:17)


class TaskState(enum.IntEnum):
    """b2z1_highlevel_controller.py:77-85 task_state_mapping."""

    WAIT_TASK_PLANNING = 0
    WAIT_ROBOT_PATH = 1
    ROBOT_TRACKING = 2
    GRASPING = 3
    WAIT_OBJECT_PATH = 4
    OBJECT_TRACKING = 5
    RELEASING = 6


@dataclass
class EnvControlData:
    """The 15-float `/env_control_data` message."""

    robot_vel_cmd: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))   # vx, vy, wz
    object_vel_cmd: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))   # vx, vy, wz
    joint_cmd: np.ndarray = field(
        default_factory=lambda: np.zeros(7, np.float32))   # 6 arm + gripper
    task_state: TaskState = TaskState.WAIT_TASK_PLANNING
    object_type: float = 0.0

    SIZE = 15

    def pack(self) -> np.ndarray:
        out = np.empty(self.SIZE, np.float32)
        out[0:3] = self.robot_vel_cmd
        out[3:6] = self.object_vel_cmd
        out[6:13] = self.joint_cmd
        out[13] = float(int(self.task_state))
        out[14] = self.object_type
        return out

    @classmethod
    def unpack(cls, data) -> "EnvControlData":
        data = np.asarray(data, np.float32)
        assert data.shape == (cls.SIZE,), data.shape
        return cls(robot_vel_cmd=data[0:3].copy(),
                   object_vel_cmd=data[3:6].copy(),
                   joint_cmd=data[6:13].copy(),
                   task_state=TaskState(int(round(float(data[13])))),
                   object_type=float(data[14]))


@dataclass
class RigidBodyPose:
    """One mocap row: position + yaw + quaternion (8 floats)."""

    xyz: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = 0.0
    quat_xyzw: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32))

    def row(self) -> np.ndarray:
        return np.concatenate([
            np.asarray(self.xyz, np.float32), [np.float32(self.yaw)],
            np.asarray(self.quat_xyzw, np.float32)])

    @classmethod
    def from_row(cls, row) -> "RigidBodyPose":
        row = np.asarray(row, np.float32)
        return cls(xyz=row[0:3].copy(), yaw=float(row[3]),
                   quat_xyzw=row[4:8].copy())


@dataclass
class EnvObs:
    """The `/env_obs` message: robot row + N_OBJECTS object rows."""

    robot: RigidBodyPose = field(default_factory=RigidBodyPose)
    objects: List[RigidBodyPose] = field(
        default_factory=lambda: [RigidBodyPose() for _ in range(N_OBJECTS)])

    SIZE = 8 * (1 + N_OBJECTS)

    def pack(self) -> np.ndarray:
        rows = [self.robot.row()] + [o.row() for o in self.objects]
        return np.concatenate(rows).astype(np.float32)

    @classmethod
    def unpack(cls, data) -> "EnvObs":
        data = np.asarray(data, np.float32).reshape(1 + N_OBJECTS, 8)
        return cls(robot=RigidBodyPose.from_row(data[0]),
                   objects=[RigidBodyPose.from_row(r) for r in data[1:]])


@dataclass
class CarState:
    """carstatemsgs/CarState.msg: pose + rates + derivatives."""

    x: float = 0.0
    y: float = 0.0
    yaw: float = 0.0
    s: float = 0.0
    v: float = 0.0
    omega: float = 0.0
    a: float = 0.0
    alpha: float = 0.0
    js: float = 0.0
    jyaw: float = 0.0

    def pack(self) -> np.ndarray:
        return np.array([self.x, self.y, self.yaw, self.s, self.v,
                         self.omega, self.a, self.alpha, self.js,
                         self.jyaw], np.float32)

    @classmethod
    def unpack(cls, d) -> "CarState":
        d = np.asarray(d, np.float32)
        return cls(*[float(v) for v in d])


@dataclass
class CarControl:
    """carstatemsgs/CarControl.msg: left/right wheel speeds."""

    left_wheel_speed: float = 0.0
    right_wheel_speed: float = 0.0

    def pack(self) -> np.ndarray:
        return np.array([self.left_wheel_speed, self.right_wheel_speed],
                        np.float32)

    @classmethod
    def unpack(cls, d) -> "CarControl":
        d = np.asarray(d, np.float32)
        return cls(float(d[0]), float(d[1]))


@dataclass
class KinematicState:
    """carstatemsgs/KinematicState.msg: constraint-monitoring telemetry
    the simulator publishes per tick (simulator.h:350-360) -- the moment
    4-plane surrogate and the centripetal acceleration, each with their
    bounds."""

    moment: float = 0.0
    max_moment: float = 0.0
    min_moment: float = 0.0
    centripetal_acc: float = 0.0
    max_centripetal_acc: float = 0.0
    min_centripetal_acc: float = 0.0

    @classmethod
    def from_rates(cls, v: float, omega: float, max_v: float,
                   max_omega: float,
                   max_centripetal_acc: float) -> "KinematicState":
        """The reference's exact formulas (simulator.h:353-359):
        moment = |v|*max_omega + |omega|*max_v, centripetal = omega*v."""
        return cls(
            moment=abs(v) * max_omega + abs(omega) * max_v,
            max_moment=max_v * max_omega,
            min_moment=-max_v * max_omega,
            centripetal_acc=omega * v,
            max_centripetal_acc=max_centripetal_acc,
            min_centripetal_acc=-max_centripetal_acc)

    def pack(self) -> np.ndarray:
        return np.array([self.moment, self.max_moment, self.min_moment,
                         self.centripetal_acc, self.max_centripetal_acc,
                         self.min_centripetal_acc], np.float32)

    @classmethod
    def unpack(cls, d) -> "KinematicState":
        d = np.asarray(d, np.float32)
        return cls(*[float(v) for v in d])

    def within_bounds(self) -> bool:
        return (self.min_moment <= self.moment <= self.max_moment
                and self.min_centripetal_acc <= self.centripetal_acc
                <= self.max_centripetal_acc)


@dataclass
class SimulatedCarState(CarState):
    """carstatemsgs/SimulatedCarState.msg: CarState + true vx/vy + ICR."""

    vx: float = 0.0
    vy: float = 0.0
    icr_yr: float = 0.0
    icr_yl: float = 0.0
    icr_xv: float = 0.0

    def pack(self) -> np.ndarray:
        return np.concatenate([
            super().pack(),
            np.array([self.vx, self.vy, self.icr_yr, self.icr_yl,
                      self.icr_xv], np.float32)])

    @classmethod
    def unpack(cls, d) -> "SimulatedCarState":
        d = np.asarray(d, np.float32)
        return cls(*[float(v) for v in d])


def yaw_to_quat_xyzw(yaw: float) -> np.ndarray:
    return np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)],
                    np.float32)


def quat_xyzw_to_yaw(q) -> float:
    x, y, z, w = [float(v) for v in q]
    return float(np.arctan2(2.0 * (w * z + x * y),
                            1.0 - 2.0 * (y * y + z * z)))


def _quat_mul_xyzw(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], np.float32)


# +90 deg about local x (env_perception_mocap.py:44-50): q' = q * q_x(90)
_ROLL90 = np.array([np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)],
                   np.float32)


@dataclass
class MocapPerception:
    """Synthetic VRPN source: true poses + noise -> `/env_obs`.

    Mirrors env_perception_mocap.py: per-body yaw extracted from the
    (noisy) quaternion, stored quaternion rotated +90 deg about the local
    x axis (the mocap frame correction), published at 100 Hz.
    """

    noise_pos: float = 0.002
    noise_yaw: float = 0.004
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def _observe(self, pose3) -> RigidBodyPose:
        x, y, yaw = [float(v) for v in pose3]
        x += self._rng.normal(0.0, self.noise_pos)
        y += self._rng.normal(0.0, self.noise_pos)
        yaw += self._rng.normal(0.0, self.noise_yaw)
        q = yaw_to_quat_xyzw(yaw)
        return RigidBodyPose(
            xyz=np.array([x, y, 0.0], np.float32),
            yaw=quat_xyzw_to_yaw(q),
            quat_xyzw=_quat_mul_xyzw(q, _ROLL90))

    def observe(self, robot_pose3, object_poses3) -> EnvObs:
        objs = [self._observe(p) for p in object_poses3]
        while len(objs) < N_OBJECTS:
            objs.append(RigidBodyPose())
        return EnvObs(robot=self._observe(robot_pose3),
                      objects=objs[:N_OBJECTS])
