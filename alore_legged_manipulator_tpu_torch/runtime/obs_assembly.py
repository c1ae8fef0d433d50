"""Low-level WBC observation assembly -- the exact 799-d deployment layout
(port of runtime/obs_assembly.py).

Reference: `_compute_low_level_observation`
(b2z1_multiobj_wbc_gnn_plan_env_train.py:545-613) and the deployment's
identical composition (deploy_real_b2z1_obj.py:319-467, configs/b2z1.yaml
num_obs 799).  Per-step 71-d proprio vector:

    [ body orientation (roll, pitch)                    2
      base angular velocity * 0.25                      3
      q - q_default (real joint order)                 18
      dq * 0.05                                        18
      previous low-level action, legs                  12
      zeros                                             4
      velocity command * scale                          3
      ee goal (base frame, cartesian)                   3
      zeros                                             3
      gait index                                        1
      clock inputs sin/cos pairs                        4 ]  = 71

Full policy input: [obs(71), priv(18, FROZEN constants -- the reference
bakes a fixed priv vector at :562-566), hist(10 x 71)] = 799.  The
frozen policy is run with hist_encoding=True so the priv slot is
actually ignored (low_level_model.py:231), but the layout is preserved
for checkpoint-faithful operation.

Every function takes any number of leading (lane) axes: one robot in
the deployment runtime, a batch of them in the hierarchy env
(rl/hierarchy.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.precision import resolve_device

N_PROP = 71
N_PRIV = 18
HIST = 10
OBS_799 = N_PROP + N_PRIV + HIST * N_PROP

# the reference's frozen privileged vector (env_train.py:562-566)
FROZEN_PRIV = np.array(
    [0.0000, 0.0000, 0.0000, 0.0000, 0.0795, 0.5203, -0.1516, -0.0065,
     0.0467, 0.2631, 0.1297, 0.1543, -0.1086, -0.1943, 0.0883, 0.2819,
     0.2323, -0.0110], np.float32)

# nominal end-effector goal in the base frame (env_train.py:557)
EE_GOAL_LOCAL = np.array([0.3991, -0.0004, 0.047], np.float32)

ANG_VEL_SCALE = 0.25
DOF_VEL_SCALE = 0.05
GAIT_FREQ_HZ = 2.0      # trot clock


class LowObsState(NamedTuple):
    """Carry for the observation assembler (history + gait phase)."""

    hist: torch.Tensor            # (..., HIST, N_PROP)
    gait_phase: torch.Tensor      # (...) in [0, 1)
    prev_leg_action: torch.Tensor  # (..., 12)

    @staticmethod
    def create(dtype=torch.float32, device=None, batch=()):
        """Zero carry with leading axes `batch` on `device` (None: the
        card)."""
        dev = resolve_device(device)
        batch = tuple(batch)
        z = dict(dtype=dtype, device=dev)
        return LowObsState(hist=torch.zeros(batch + (HIST, N_PROP), **z),
                           gait_phase=torch.zeros(batch, **z),
                           prev_leg_action=torch.zeros(batch + (12,), **z))


def _const(x, like):
    return torch.as_tensor(np.asarray(x)).to(dtype=like.dtype,
                                             device=like.device)


def assemble_low_level_obs(state: LowObsState, roll, pitch, ang_vel,
                           q, dq, q_default, vel_cmd, dt,
                           cmd_scale=1.0, ee_goal=None):
    """One assembly tick.  Returns (new_state, prop (..., 71),
    obs799 (..., 799)).

    q, dq: (..., 18) real joint order; ang_vel: (..., 3) body frame;
    vel_cmd: (..., 3); roll, pitch: (...).  The gait clock advances at
    GAIT_FREQ_HZ like the reference's `gait_indices`/`clock_inputs`
    (trot phase offsets 0, 0.5, 0.5, 0).
    """
    phase = (state.gait_phase + GAIT_FREQ_HZ * dt) % 1.0
    offsets = _const([0.0, 0.5, 0.5, 0.0], q)
    clock = torch.sin(2.0 * math.pi * (phase[..., None] + offsets))
    lead = q.shape[:-1]
    ee = _const(EE_GOAL_LOCAL if ee_goal is None else ee_goal, q)
    zeros = torch.zeros(lead + (4,), dtype=q.dtype, device=q.device)

    prop = torch.cat([
        torch.stack([roll, pitch], dim=-1),
        ang_vel * ANG_VEL_SCALE,
        q - q_default,
        dq * DOF_VEL_SCALE,
        state.prev_leg_action,
        zeros,
        vel_cmd * cmd_scale,
        ee.expand(lead + (3,)),
        zeros[..., :3],
        phase[..., None],
        clock,
    ], dim=-1)

    # history update semantics of env_train.py:603-611: broadcast on the
    # first tick is the caller's responsibility via LowObsState.create +
    # an explicit fill; steady state appends
    hist = torch.cat([state.hist[..., 1:, :], prop[..., None, :]], dim=-2)
    priv = _const(FROZEN_PRIV, q).expand(lead + (N_PRIV,))
    obs799 = torch.cat([prop, priv, hist.reshape(lead + (HIST * N_PROP,))],
                       dim=-1)
    new_state = state._replace(hist=hist, gait_phase=phase)
    return new_state, prop, obs799


def split_obs799(obs799):
    """(..., 799) -> (prop (..., 71), priv (..., 18), hist (..., 10, 71))."""
    prop = obs799[..., :N_PROP]
    priv = obs799[..., N_PROP:N_PROP + N_PRIV]
    hist = obs799[..., -HIST * N_PROP:].reshape(
        obs799.shape[:-1] + (HIST, N_PROP))
    return prop, priv, hist
