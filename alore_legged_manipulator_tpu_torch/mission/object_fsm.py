"""Object-rearrangement task FSM.

Rebuild of the mission executive that sequences grasp -> push -> release
cycles (Simulation/isaac_b2_controller/b2z1/b2z1_object_fsm.py
MovingBotController, mirrored on the real robot by
Deployment/object_arrangement_fsm.py):

  WAIT_TASK_PLANNING -> (visit order) -> WAIT_ROBOT_PATH -> ROBOT_TRACKING
  -> GRASPING -> WAIT_OBJECT_PATH -> OBJECT_TRACKING -> RELEASING -> next

Control laws preserved from the reference:
  * robot path tracking: waypoint pure-pursuit with Kp_yaw = 2.0,
    omega clamped to +-0.6, vx = 0.5 gated on |yaw err| < 15 deg,
    waypoint reach threshold 0.3 m (0.15 at the final point)
    (robot_tracking_controller :575-641)
  * final alignment: rotate in place toward the object until within 5 deg
  * grasp: distance servo toward the configured grasp distance + arm ramp
    (object_grasp :643-751)
  * release: arm ramp out, task counter advance (:824-841)

The object push segment delegates to the planner/NMPC stack: the FSM
requests an object path from a PlanManager and forwards its Polynome;
in simulation-only tests a kinematic follower stands in for the tracking
controller.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class FsmState(enum.Enum):
    WAIT_TASK_PLANNING = 0
    WAIT_ROBOT_PATH = 1
    ROBOT_TRACKING = 2
    GRASPING = 3
    WAIT_OBJECT_PATH = 4
    OBJECT_TRACKING = 5
    RELEASING = 6
    DONE = 7


@dataclass
class FsmConfig:
    max_vx: float = 0.5
    max_wz: float = 0.6
    kp_yaw: float = 2.0
    reach_threshold: float = 0.3
    final_reach_threshold: float = 0.15
    yaw_gate_deg: float = 15.0
    final_yaw_gate_deg: float = 5.0
    grasp_distance: float = 0.55      # config.yaml grasp_cfg[0] style
    grasp_ramp_steps: int = 25
    release_ramp_steps: int = 25
    target_reach_dist: float = 0.3
    # liveness watchdog: the grasp distance servo only drives body-x
    # (object_grasp :643-751), so if a perception outage left the
    # approach badly placed (object beside/behind the robot) it can
    # diverge forever.  After this many GRASPING ticks without closing,
    # re-enter WAIT_ROBOT_PATH and re-approach from current estimates
    # (the replan-rather-than-hang behavior; tests/test_faults.py).
    grasp_timeout_ticks: int = 600


@dataclass
class ObjectFsm:
    """Host-side mission executive; tick() advances one control step."""

    items: List[np.ndarray]            # item poses (3,)
    targets: List[np.ndarray]          # target poses (3,)
    order: List[int]                   # visit order over item indices
    cfg: FsmConfig = field(default_factory=FsmConfig)

    state: FsmState = FsmState.WAIT_TASK_PLANNING
    task_idx: int = 0
    robot_path: Optional[List[np.ndarray]] = None
    path_index: int = 0
    grasp_count: int = 0
    release_count: int = 0
    _grasp_ticks: int = 0
    robot_vel_cmd: np.ndarray = field(
        default_factory=lambda: np.zeros(3))
    object_vel_cmd: np.ndarray = field(
        default_factory=lambda: np.zeros(3))
    arm_ratio: float = 0.0             # 0 = stowed, 1 = grasp posture

    # --- interfaces the runtime provides -------------------------------
    def current_item(self):
        return self.items[self.order[self.task_idx]]

    def current_target(self):
        return self.targets[self.order[self.task_idx]]

    def set_robot_path(self, path: List[np.ndarray]):
        self.robot_path = [np.asarray(p, float) for p in path]
        self.path_index = 0
        if self.state == FsmState.WAIT_ROBOT_PATH:
            self.state = FsmState.ROBOT_TRACKING

    def object_path_ready(self):
        if self.state == FsmState.WAIT_OBJECT_PATH:
            self.state = FsmState.OBJECT_TRACKING

    # --- control laws ---------------------------------------------------
    def _track_robot_path(self, robot_pose, object_pos) -> bool:
        c = self.cfg
        x, y, yaw = robot_pose

        if self.path_index >= len(self.robot_path):
            # final alignment toward the object
            dx, dy = object_pos[0] - x, object_pos[1] - y
            yaw_err = (math.atan2(dy, dx) - yaw + math.pi) \
                % (2 * math.pi) - math.pi
            if abs(yaw_err) > math.radians(c.final_yaw_gate_deg):
                w = float(np.clip(c.kp_yaw * yaw_err, -c.max_wz, c.max_wz))
                self.robot_vel_cmd = np.array([0.0, 0.0, w])
                return False
            self.robot_vel_cmd = np.zeros(3)
            return True

        target = self.robot_path[self.path_index]
        dx, dy = target[0] - x, target[1] - y
        dist = math.hypot(dx, dy)
        is_final = self.path_index == len(self.robot_path) - 1
        thr = c.final_reach_threshold if is_final else c.reach_threshold
        if dist < thr:
            self.path_index += 1
            return False
        yaw_err = (math.atan2(dy, dx) - yaw + math.pi) \
            % (2 * math.pi) - math.pi
        vx = 0.0 if abs(yaw_err) > math.radians(c.yaw_gate_deg) else c.max_vx
        w = float(np.clip(c.kp_yaw * yaw_err, -c.max_wz, c.max_wz))
        self.robot_vel_cmd = np.array([vx, 0.0, w])
        return False

    def _grasp(self, robot_pose, object_pos) -> bool:
        c = self.cfg
        dist = float(np.linalg.norm(np.asarray(robot_pose[:2])
                                    - np.asarray(object_pos[:2])))
        gap = dist - c.grasp_distance
        if abs(gap) > 0.05:
            # distance servo straight toward/away from the object
            self.robot_vel_cmd = np.array(
                [float(np.clip(1.0 * gap, -0.2, 0.2)), 0.0, 0.0])
            return False
        self.robot_vel_cmd = np.zeros(3)
        self.grasp_count += 1
        self.arm_ratio = min(1.0, self.grasp_count / c.grasp_ramp_steps)
        return self.grasp_count >= c.grasp_ramp_steps

    # --- main tick ------------------------------------------------------
    def tick(self, robot_pose, object_pos, object_path_follower=None):
        """Advance the FSM one step.

        robot_pose: (3,) x, y, yaw; object_pos: (2/3,) current object pose.
        object_path_follower() -> (vel_cmd (3,), reached: bool) supplies
        the push-phase velocity command (the NMPC stack in the full
        system).  Returns (state, robot_vel_cmd, object_vel_cmd).
        """
        c = self.cfg
        if self.state == FsmState.WAIT_TASK_PLANNING:
            if self.order:
                self.state = FsmState.WAIT_ROBOT_PATH
        elif self.state == FsmState.ROBOT_TRACKING:
            if self._track_robot_path(robot_pose, object_pos):
                self.state = FsmState.GRASPING
                self.grasp_count = 0
                self._grasp_ticks = 0
        elif self.state == FsmState.GRASPING:
            self._grasp_ticks += 1
            if self._grasp(robot_pose, object_pos):
                self.state = FsmState.WAIT_OBJECT_PATH
            elif (self.grasp_count == 0
                  and self._grasp_ticks > c.grasp_timeout_ticks):
                # watchdog: servo not closing -- re-approach
                self.state = FsmState.WAIT_ROBOT_PATH
                self.robot_path = None
                self.robot_vel_cmd = np.zeros(3)
        elif self.state == FsmState.OBJECT_TRACKING:
            if object_path_follower is not None:
                vel, reached = object_path_follower()
                self.object_vel_cmd = np.asarray(vel, float)
                if reached:
                    self.object_vel_cmd = np.zeros(3)
                    self.state = FsmState.RELEASING
                    self.release_count = 0
        elif self.state == FsmState.RELEASING:
            self.release_count += 1
            self.arm_ratio = max(
                0.0, 1.0 - self.release_count / c.release_ramp_steps)
            if self.release_count >= c.release_ramp_steps:
                self.task_idx += 1
                if self.task_idx >= len(self.order):
                    self.state = FsmState.DONE
                else:
                    self.state = FsmState.WAIT_ROBOT_PATH
                    self.robot_path = None
        return self.state, self.robot_vel_cmd, self.object_vel_cmd
