"""Angle utilities (port of utils/angles.py).

Reference semantics:
  - normalize_angle: nmpc_controller/src/mpc.cpp:243 (normlize_theta)
  - unwrap_to: front_end jps_planner.cpp:368 (normalizeAngle)
  - smooth_yaw_sequence: nmpc_controller/src/mpc.cpp:248 (smooth_yaw)
"""
from __future__ import annotations

import math

import torch


def normalize_angle(theta):
    """Wrap angle to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def unwrap_to(ref, angle):
    """Shift `angle` by multiples of 2*pi so that |ref - angle| <= pi."""
    return angle + 2.0 * math.pi * torch.round((ref - angle) / (2.0 * math.pi))


def _shift_within(prev, cur, half_width):
    k = torch.ceil((cur - prev - half_width) / (2.0 * math.pi))
    cur = cur - 2.0 * math.pi * torch.clamp(k, min=0.0)
    k = torch.ceil((prev - cur - half_width) / (2.0 * math.pi))
    return cur + 2.0 * math.pi * torch.clamp(k, min=0.0)


def smooth_yaw_sequence(yaw_est, yaw_ref_seq):
    """Unwrap a yaw reference sequence against the current estimate.

    yaw_est: (...,); yaw_ref_seq: (..., M).  Each element is unwrapped
    against its predecessor with a pi/2 threshold (mpc.cpp:248-277).
    """
    prev = _shift_within(yaw_est, yaw_ref_seq[..., 0], math.pi / 2)
    out = [prev]
    for i in range(1, yaw_ref_seq.shape[-1]):
        prev = _shift_within(prev, yaw_ref_seq[..., i], math.pi / 2)
        out.append(prev)
    return torch.stack(out, dim=-1)
