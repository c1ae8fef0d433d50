"""Flat-trajectory planner <-> controller contracts (port of
planner/flat_traj.py), batched over a leading lane axis.

`FlatTraj` is the front-end -> back-end handoff (reference FlatTrajData,
traj_representation.h:46-75); `Polynome` the back-end -> NMPC handoff
(Polynome.msg, plan_manager.hpp:784-831).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FlatTraj(NamedTuple):
    """inner_yaw_s (B, 2, N-1); init_piece_time (B,); inner_positions
    (B, N, 3); start_state / final_state (B, 2, 3); start_xytheta /
    final_xytheta (B, 3); if_cut (B,) bool."""

    inner_yaw_s: torch.Tensor
    init_piece_time: torch.Tensor
    inner_positions: torch.Tensor
    start_state: torch.Tensor
    final_state: torch.Tensor
    start_xytheta: torch.Tensor
    final_xytheta: torch.Tensor
    if_cut: torch.Tensor

    @property
    def num_pieces(self) -> int:
        return self.inner_yaw_s.shape[-1] + 1


class Polynome(NamedTuple):
    """Planner -> controller message (Polynome.msg analogue)."""

    traj_start_time: torch.Tensor  # (B,)
    inner_points: torch.Tensor     # (B, 2, N-1)
    piece_times: torch.Tensor      # (B, N)
    init_state: torch.Tensor       # (B, 2, 3)
    tail_state: torch.Tensor       # (B, 2, 3)
    start_position: torch.Tensor   # (B, 3) world x, y, theta
    icr: torch.Tensor              # (B, 3) (yr, yl, xv)
