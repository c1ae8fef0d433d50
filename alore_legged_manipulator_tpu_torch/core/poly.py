"""Piecewise-polynomial flat trajectories sigma(t) = (yaw(t), s(t))
(port of core/poly.py).

A batch of trajectories is one static-shape tuple:

  coeffs : (B, N, 6, 2)  ascending-power coefficients per piece
  times  : (B, N)        piece durations
"""
from __future__ import annotations

from typing import NamedTuple

import torch

DEGREE = 5
NCOEF = DEGREE + 1


class PolyTraj(NamedTuple):
    coeffs: torch.Tensor  # (B, N, 6, 2) ascending powers
    times: torch.Tensor   # (B, N)

    @property
    def num_pieces(self) -> int:
        return self.coeffs.shape[-3]

    @property
    def total_time(self):
        return torch.sum(self.times, dim=-1)


def _falling(k: int, order: int) -> float:
    out = 1.0
    for d in range(order):
        out *= max(k - d, 0)
    return float(out)


def _basis(s, order: int, ncoef: int = NCOEF):
    """beta_order(s): derivative-of-monomial basis, shape (..., ncoef)."""
    pw = [torch.ones_like(s)]
    for _ in range(ncoef - order - 1):
        pw.append(pw[-1] * s)
    cols = [torch.zeros_like(s)] * order
    cols += [_falling(k, order) * pw[k - order] for k in range(order, ncoef)]
    return torch.stack(cols, dim=-1)


def eval_piece(coeffs, s, order: int = 0):
    """Evaluate pieces (..., ncoef, 2) at local times s (...,); (..., 2)."""
    b = _basis(s, order, coeffs.shape[-2])
    return torch.sum(b[..., :, None] * coeffs, dim=-2)


def locate(traj: PolyTraj, t):
    """Global times t (B, M) -> (piece index, local time), clamped to the
    ends (trajectory.hpp locatePieceIdx semantics)."""
    cum = torch.cumsum(traj.times, dim=-1)
    t = torch.minimum(torch.clamp(t, min=0.0), cum[..., -1:])
    idx = torch.searchsorted(cum.contiguous(), t.contiguous(), right=True)
    idx = torch.clamp(idx, 0, traj.num_pieces - 1)
    prev = torch.gather(cum, -1, torch.clamp(idx - 1, min=0))
    start = torch.where(idx > 0, prev, torch.zeros_like(prev))
    return idx, t - start


def eval_traj(traj: PolyTraj, t, order: int = 0):
    """Evaluate at global times t (B, M) (or (B,)); returns (..., 2)."""
    squeeze = t.dim() == 1
    if squeeze:
        t = t[:, None]
    idx, local = locate(traj, t)
    B, M = idx.shape
    c = torch.gather(traj.coeffs, 1,
                     idx[:, :, None, None].expand(B, M, *traj.coeffs.shape[2:]))
    out = eval_piece(c, local, order)
    return out[:, 0] if squeeze else out


def pos(traj: PolyTraj, t):
    return eval_traj(traj, t, 0)


def vel(traj: PolyTraj, t):
    return eval_traj(traj, t, 1)


def acc(traj: PolyTraj, t):
    return eval_traj(traj, t, 2)


def jerk(traj: PolyTraj, t):
    return eval_traj(traj, t, 3)
