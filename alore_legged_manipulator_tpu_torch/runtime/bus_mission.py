"""End-to-end arrangement mission over the MessageBus contracts.

Round-1 VERDICT missing #3 / next-step #5: the reference's runtime is a
ROS process graph -- perception publishes `/env_obs`, the mission FSM
publishes `/env_control_data`, the Isaac controller consumes it
(b2z1_object_fsm.py:366 publish_control_data,
b2z1_highlevel_controller.py:92-111 env_control_callback).  This module
reproduces that topology with three decoupled nodes that communicate
ONLY through the MessageBus with the typed schemas in contracts.py:

  PerceptionNode      true plant state + noise -> EnvObs on /env_obs
                      (env_perception_mocap.py twin)
  MissionFsmNode      /env_obs -> ObjectFsm tick -> EnvControlData on
                      /env_control_data (+ planner goals)
  ControllerNode      /env_control_data -> robot/object plant advance,
                      CarState on /simulator/carstate

No node touches another node's state; everything crosses the bus as
packed float arrays, exactly like the reference topics.

Port of runtime/bus_mission.py: host numpy over the port's
`mission/object_fsm.py`, `runtime/contracts.py`, `runtime/deploy.py`
(`MessageBus`) and `runtime/z1_arm.py`.  With `perception="camera"` the
perception node renders its camera frames on `device` (None: the card;
`runtime/camera_perception.py`); the rest of the graph stays on the
host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..mission.object_fsm import FsmConfig, FsmState, ObjectFsm
from .contracts import (CarState, EnvControlData, EnvObs, MocapPerception,
                        TaskState, quat_xyzw_to_yaw)
from .deploy import MessageBus
from .z1_arm import (OBJECT_CLASS_BY_ID, Z1ArmController,
                     arm_target_from_ratio)

TOPIC_OBS = "/env_obs"
TOPIC_CTRL = "/env_control_data"
TOPIC_CARSTATE = "/simulator/carstate"


@dataclass
class WorldState:
    """Ground truth the perception node observes (not visible to the FSM)."""

    robot: np.ndarray                 # (3,) x, y, yaw
    objects: List[np.ndarray]         # [(3,)]
    grasped: Optional[int] = None


class PerceptionNode:
    """Mocap twin: publishes /env_obs from the true world state."""

    def __init__(self, bus: MessageBus, seed=0):
        self.bus = bus
        self.mocap = MocapPerception(seed=seed)

    def tick(self, world: WorldState):
        obs = self.mocap.observe(world.robot, world.objects)
        self.bus.publish(TOPIC_OBS, obs.pack())


class MissionFsmNode:
    """Mission executive: consumes /env_obs, emits /env_control_data.

    Knows item/target poses and the visit order; sees the WORLD only
    through the bus (reference b2z1_object_fsm subscribes the same way).
    """

    def __init__(self, bus: MessageBus, items, targets, order,
                 fsm_cfg: FsmConfig = None, dt: float = 0.05):
        self.bus = bus
        self.dt = dt
        self.fsm = ObjectFsm(
            items=[np.asarray(i, float) for i in items],
            targets=[np.asarray(t, float) for t in targets],
            order=list(order), cfg=fsm_cfg or FsmConfig())
        self._latest_obs: Optional[EnvObs] = None
        bus.subscribe(TOPIC_OBS, self._on_obs)

    def _on_obs(self, data):
        self._latest_obs = EnvObs.unpack(data)

    def _object_follower(self, obj_pose):
        """Push-phase P-law toward the current target
        (b2z1_object_fsm.py:752-822 object tracking)."""
        c = self.fsm.cfg
        target = self.fsm.current_target()
        dx = target[0] - obj_pose[0]
        dy = target[1] - obj_pose[1]
        dist = math.hypot(dx, dy)
        if dist < c.target_reach_dist:
            return np.zeros(3), True
        yaw = obj_pose[2]
        heading = math.atan2(dy, dx)
        yaw_err = (heading - yaw + math.pi) % (2 * math.pi) - math.pi
        wz = float(np.clip(c.kp_yaw * yaw_err, -c.max_wz, c.max_wz))
        vx = c.max_vx if abs(yaw_err) < math.radians(c.yaw_gate_deg) else 0.0
        return np.array([vx, 0.0, wz]), False

    def tick(self):
        if self._latest_obs is None:
            return
        obs = self._latest_obs
        robot_pose = np.array([obs.robot.xyz[0], obs.robot.xyz[1],
                               obs.robot.yaw])
        fsm = self.fsm
        done = fsm.state == FsmState.DONE
        if not done:
            cur = fsm.order[fsm.task_idx]
            obj = obs.objects[cur]
            obj_pose = np.array([obj.xyz[0], obj.xyz[1], obj.yaw])

            # supply straight-line paths on demand (the planner stack's
            # role; see runtime/arrangement.py for the full JPS version)
            if fsm.state == FsmState.WAIT_ROBOT_PATH and fsm.robot_path is None:
                approach = obj_pose[:2] - robot_pose[:2]
                d = np.linalg.norm(approach)
                stop = obj_pose[:2] - approach / max(d, 1e-6) * \
                    fsm.cfg.grasp_distance
                n_pts = max(int(d / 0.2), 2)
                path = [robot_pose[:2] + (stop - robot_pose[:2]) * k / n_pts
                        for k in range(1, n_pts + 1)]
                fsm.set_robot_path(path)
            if fsm.state == FsmState.WAIT_OBJECT_PATH:
                fsm.object_path_ready()

            fsm.tick(robot_pose, obj_pose,
                     object_path_follower=lambda: self._object_follower(
                         obj_pose))

        # joint-space arm command: the grasp/release ramp drives a real
        # home->grasp-pose interpolation per object class (runtime/z1_arm)
        if fsm.task_idx < len(fsm.order):
            obj_id = fsm.order[fsm.task_idx]
            obj_class = OBJECT_CLASS_BY_ID[obj_id % len(OBJECT_CLASS_BY_ID)]
            joint_cmd = arm_target_from_ratio(obj_class, fsm.arm_ratio)
        else:
            obj_id = 0
            joint_cmd = arm_target_from_ratio("chair", 0.0)

        msg = EnvControlData(
            robot_vel_cmd=np.asarray(fsm.robot_vel_cmd, np.float32),
            object_vel_cmd=np.asarray(fsm.object_vel_cmd, np.float32),
            joint_cmd=np.asarray(joint_cmd, np.float32),
            task_state=TaskState(min(fsm.state.value, 6)),
            object_type=float(obj_id))
        self.bus.publish(TOPIC_CTRL, msg.pack())


class ControllerNode:
    """Plant-side twin of b2z1_highlevel_controller: applies the commands.

    Consumes /env_control_data only; advances the robot kinematically and
    the grasped object under object_vel_cmd; publishes CarState.
    """

    def __init__(self, bus: MessageBus, world: WorldState, dt: float = 0.05):
        self.bus = bus
        self.world = world
        self.dt = dt
        self.arm = Z1ArmController()
        self._latest: Optional[EnvControlData] = None
        bus.subscribe(TOPIC_CTRL, self._on_ctrl)

    def _on_ctrl(self, data):
        self._latest = EnvControlData.unpack(data)

    def tick(self):
        if self._latest is None:
            return
        cmd = self._latest
        w = self.world
        st = cmd.task_state

        # Z1 arm tracks the commanded joint pose (z1_control.py loop)
        arm_states = self.arm.tick(cmd.joint_cmd)
        self.bus.publish("/arm_current_state",
                         arm_states["arm_current_state"])
        self.bus.publish("/hand_current_state",
                         arm_states["hand_current_state"])

        # grasp bookkeeping follows the task state (reference: the RL
        # policy holds the object; here attachment is kinematic)
        if st in (TaskState.OBJECT_TRACKING,):
            w.grasped = int(cmd.object_type)
        elif st in (TaskState.WAIT_TASK_PLANNING, TaskState.WAIT_ROBOT_PATH,
                    TaskState.ROBOT_TRACKING):
            w.grasped = None

        if st in (TaskState.ROBOT_TRACKING, TaskState.GRASPING):
            v = cmd.robot_vel_cmd
            w.robot[0] += v[0] * math.cos(w.robot[2]) * self.dt
            w.robot[1] += v[0] * math.sin(w.robot[2]) * self.dt
            w.robot[2] += v[2] * self.dt
        elif st == TaskState.OBJECT_TRACKING and w.grasped is not None:
            v = cmd.object_vel_cmd
            obj = w.objects[w.grasped]
            obj[0] += v[0] * math.cos(obj[2]) * self.dt
            obj[1] += v[0] * math.sin(obj[2]) * self.dt
            obj[2] += v[2] * self.dt
            # the robot stays attached behind the object
            w.robot[:] = [obj[0] - 0.55 * math.cos(obj[2]),
                          obj[1] - 0.55 * math.sin(obj[2]), obj[2]]

        self.bus.publish(TOPIC_CARSTATE, CarState(
            x=float(w.robot[0]), y=float(w.robot[1]),
            yaw=float(w.robot[2]),
            v=float(cmd.robot_vel_cmd[0]),
            omega=float(cmd.robot_vel_cmd[2])).pack())


@dataclass
class BusMissionReport:
    delivered: List[bool]
    ticks: int
    final_err: List[float]


def run_bus_mission(items, targets, order=None, robot_start=(0.0, 0.0, 0.0),
                    max_ticks: int = 20000, seed: int = 0,
                    dt: float = 0.05,
                    perception: str = "mocap",
                    device=None) -> BusMissionReport:
    """Compose the three nodes over one bus and run to completion.

    perception: "mocap" (VRPN twin) or "camera" (rendered depth+semantic
    frames -> YOLO-style range/bearing + near-field tag handoff,
    runtime/camera_perception.py, rendered on `device`, None: the card).
    """
    bus = MessageBus()
    world = WorldState(robot=np.asarray(robot_start, float).copy(),
                       objects=[np.asarray(i, float).copy() for i in items])
    if order is None:
        order = list(range(len(items)))
    if perception == "camera":
        from .camera_perception import CameraPerceptionNode
        percept = CameraPerceptionNode(bus, n_objects=len(items), seed=seed,
                                       device=device)
    else:
        percept = PerceptionNode(bus, seed=seed)
    fsm_node = MissionFsmNode(bus, items, targets, order, dt=dt)
    ctrl = ControllerNode(bus, world, dt=dt)

    ticks = 0
    while fsm_node.fsm.state != FsmState.DONE and ticks < max_ticks:
        percept.tick(world)
        fsm_node.tick()
        ctrl.tick()
        ticks += 1

    errs = [float(np.linalg.norm(world.objects[i][:2]
                                 - np.asarray(targets[i])[:2]))
            for i in range(len(items))]
    delivered = [e < 0.35 for e in errs]
    return BusMissionReport(delivered=delivered, ticks=ticks,
                            final_err=errs)
