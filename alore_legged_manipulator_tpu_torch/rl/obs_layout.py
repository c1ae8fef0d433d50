"""The reference's exact observation layouts, actor 70-d and critic 161-d
(port of rl/obs_layout.py).

Field lists, order and scales of the reference env's `_get_observations`
(Training/b2z1_multiobj_wbc_gnn_plan/b2z1_multiobj_wbc_gnn_plan_env_train.py
:687-711 actor, :757-790 critic; scales :678-680, commands_scale :84).
Every dimension is computed from defined state -- no padding.

Planar training-world reduction (the JAX package's, kept): roll, pitch
and the x/y body rates are zero, the base z sits at BASE_HEIGHT, leg
joints hold the stance unless a hierarchy `RobotState` supplies real
q/dq, the 49-d link-pose block is the Z1 arm chain {link00, link02..06,
ee} from the planar FK over the nominal Z1 geometry, and one
object-floor friction feeds both critic friction slots.

Every function takes any number of leading (lane) axes.  Quaternions
are (w, x, y, z) throughout this module.  `DEFAULT_JOINT_POS` is a
float64 numpy constant; `default_joint_pos(dtype, device)` builds it on
the caller's device and dtype (the JAX package's `.astype(dtype)`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# env_train.py:678-680, :84
LIN_VEL_SCALE = 2.0
ANG_VEL_SCALE = 0.25
DOF_VEL_SCALE = 0.05
COMMANDS_SCALE = (2.0, 2.0, 0.25)

# planar-world constants: B2 standing base height; nominal object
# center heights per class (chair/table/box)
BASE_HEIGHT = 0.55
OBJ_CENTER_HEIGHT = (0.25, 0.30, 0.20)
# Z1 arm mount in the base frame (forward of the base origin, on top)
ARM_MOUNT = (0.25, 0.0, 0.0)

# nominal Z1 link geometry, runtime/z1_arm.py:_L
_D1, _A2, _A3, _D5, _D6 = 0.1035, 0.35, 0.225, 0.07, 0.0492

DEFAULT_JOINT_POS = np.concatenate([
    np.tile(np.asarray([0.1, 0.8, -1.5]), 4),     # legs (B2 stance)
    np.asarray([0.0, 1.26, -2.8, 0.0, 0.0, 0.0]),  # Z1 arm home
])


def default_joint_pos(dtype, device) -> torch.Tensor:
    """(18,) stance + arm home on `device` in `dtype`."""
    return torch.as_tensor(DEFAULT_JOINT_POS).to(dtype=dtype, device=device)


class RobotView(NamedTuple):
    """What the observation assembler needs to know about the robot."""

    base_pose: torch.Tensor   # (..., 3) world x, y, yaw
    base_vel: torch.Tensor    # (..., 3) body-frame vx, vy, wz
    q: torch.Tensor           # (..., 18) joint positions (12 leg + 6 arm)
    dq: torch.Tensor          # (..., 18) joint velocities


def _rpy_quat_wxyz(roll, pitch, yaw):
    """Intrinsic ZYX (yaw-pitch-roll) quaternion, (w, x, y, z)."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy], dim=-1)


def yaw_quat_wxyz(yaw):
    z = torch.zeros_like(yaw)
    return _rpy_quat_wxyz(z, z, yaw)


def arm_link_frames(q_arm):
    """(..., 7, 7) frames [pos3 | quat4 wxyz] of {link00, link02..link06,
    ee} in the ROBOT BASE frame -- the reference's exact link selection
    (env_train.py:651-652), via the planar-chain Z1 FK of
    runtime/z1_arm.py:57-87 extended to the intermediate links.
    """
    yaw = q_arm[..., 0]
    p1 = q_arm[..., 1]
    p2 = q_arm[..., 1] + q_arm[..., 2]
    p3 = q_arm[..., 1] + q_arm[..., 2] + q_arm[..., 3]
    roll = q_arm[..., 4]
    pitch_ee = p3 + q_arm[..., 5]
    z0 = torch.zeros_like(yaw)

    # radial/vertical chain in the arm's vertical plane
    r1 = _A2 * torch.sin(p1)
    z1 = _D1 + _A2 * torch.cos(p1)
    r2 = r1 + _A3 * torch.sin(p2)
    z2 = z1 + _A3 * torch.cos(p2)
    r3 = r2 + _D5 * torch.sin(p3)
    z3 = z2 + _D5 * torch.cos(p3)
    r4 = r2 + (_D5 + _D6) * torch.sin(p3)
    z4 = z2 + (_D5 + _D6) * torch.cos(p3)
    cyaw, syaw = torch.cos(yaw), torch.sin(yaw)

    def frame(r, z, rol, pit):
        pos = torch.stack([r * cyaw + ARM_MOUNT[0], r * syaw + ARM_MOUNT[1],
                           z + ARM_MOUNT[2]], dim=-1)
        return torch.cat([pos, _rpy_quat_wxyz(rol, pit, yaw)], dim=-1)

    return torch.stack([
        frame(z0, torch.full_like(yaw, _D1), z0, z0),  # link00 (yaw base)
        frame(r1, z1, z0, p1),                         # link02 (upper arm)
        frame(r2, z2, z0, p2),                         # link03 (forearm)
        frame(r2, z2, z0, p3),                         # link04 (wrist pitch)
        frame(r3, z3, roll, p3),                       # link05 (wrist roll)
        frame(r3, z3, roll, pitch_ee),                 # link06
        frame(r4, z4, roll, pitch_ee),                 # ee / gripper
    ], dim=-2)


def _object_in_robot_frame(rv: RobotView, obj_pose, obj_type):
    """Object position (..., 3) + quat (..., 4, wxyz) in the robot frame."""
    dtype, dev = obj_pose.dtype, obj_pose.device
    dyaw = obj_pose[..., 2] - rv.base_pose[..., 2]
    rel = obj_pose[..., :2] - rv.base_pose[..., :2]
    c, s = torch.cos(rv.base_pose[..., 2]), torch.sin(rv.base_pose[..., 2])
    rel_b = torch.stack([c * rel[..., 0] + s * rel[..., 1],
                         -s * rel[..., 0] + c * rel[..., 1]], dim=-1)
    heights = torch.tensor(OBJ_CENTER_HEIGHT, dtype=dtype, device=dev)
    z = heights[obj_type.long()] - BASE_HEIGHT
    return torch.cat([rel_b, z[..., None]], dim=-1), yaw_quat_wxyz(dyaw)


def actor_observation(st, rv: RobotView, default_q) -> torch.Tensor:
    """The 70-d actor observation (env_train.py:687-711, field order
    preserved).  `st` duck-types PushEnvState (cmd, prev_action,
    obj_pose, obj_type)."""
    dtype = rv.q.dtype
    z0 = torch.zeros_like(rv.base_vel[..., 2])
    ee = arm_link_frames(rv.q[..., 12:])[..., -1, :]
    obj_pos, obj_quat = _object_in_robot_frame(rv, st.obj_pose, st.obj_type)
    parts = [
        rv.q - default_q,                                  # dof_pos   18
        rv.dq * DOF_VEL_SCALE,                             # dof_vel   18
        torch.stack([z0, z0], dim=-1),                     # roll, pitch 2
        torch.stack([z0, z0, rv.base_vel[..., 2]], dim=-1)
        * ANG_VEL_SCALE,                                   # ang vel    3
        st.prev_action,                                    # last act   9
        st.cmd * torch.tensor(COMMANDS_SCALE, dtype=dtype,
                              device=rv.q.device),         # commands   3
        ee[..., :3],                                       # ee pos     3
        ee[..., 3:],                                       # ee quat    4
        obj_pos,                                           # obj pos    3
        obj_quat,                                          # obj quat   4
        F.one_hot(st.obj_type.long(), 3).to(dtype),        # category   3
    ]
    return torch.cat(parts, dim=-1)                        # = 70


def critic_observation_161(st, rv: RobotView, default_q,
                           gripper_ok) -> torch.Tensor:
    """The 161-d privileged critic observation (env_train.py:757-790,
    field order preserved).  `st` additionally duck-types obj_vel
    (body frame), mass, friction."""
    dtype = rv.q.dtype
    z0 = torch.zeros_like(rv.base_vel[..., 2])
    frames = arm_link_frames(rv.q[..., 12:])
    obj_pos, obj_quat = _object_in_robot_frame(rv, st.obj_pose, st.obj_type)
    ang = torch.stack([z0, z0, rv.base_vel[..., 2]], dim=-1) * ANG_VEL_SCALE
    obj_lin = torch.cat([st.obj_vel[..., :2], z0[..., None]], dim=-1) \
        * LIN_VEL_SCALE
    obj_ang = torch.stack([z0, z0, st.obj_vel[..., 2]], dim=-1) \
        * ANG_VEL_SCALE
    lead = rv.q.shape[:-1]
    parts = [
        rv.q - default_q,                                  # dof_pos   18
        rv.dq * DOF_VEL_SCALE,                             # dof_vel   18
        default_q.expand(lead + (18,)),                    # default   18
        rv.q,                                              # abs pos   18
        torch.stack([z0, z0], dim=-1),                     # roll, pitch 2
        ang,                                               # ang vel    3
        st.prev_action,                                    # last act   9
        st.cmd * torch.tensor(COMMANDS_SCALE, dtype=dtype,
                              device=rv.q.device),         # commands   3
        frames.reshape(lead + (49,)),                      # links     49
        torch.as_tensor(gripper_ok, device=rv.q.device).to(dtype)
        .expand(lead)[..., None],                          # ee contact 1
        obj_pos,                                           # obj pos    3
        obj_quat,                                          # obj quat   4
        torch.cat([rv.base_vel[..., :2], z0[..., None]], dim=-1)
        * LIN_VEL_SCALE,                                   # root lin   3
        ang,                                               # root ang   3
        obj_lin,                                           # obj lin    3
        obj_ang,                                           # obj ang    3
        st.friction[..., None],                            # static mu  1
        st.mass[..., None] / 40.0,                         # mass       1
        st.friction[..., None],                            # dynamic mu 1
    ]
    return torch.cat(parts, dim=-1)                        # = 161
