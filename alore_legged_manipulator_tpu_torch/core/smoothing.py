"""Smoothed penalty primitives (reference: optimizer.cpp:1069-1086)."""
from __future__ import annotations

import torch


def positive_smoothed_l1(x, eps: float = 0.01):
    """C2-smooth hinge: x - eps/2 for x >= eps, cubic/quartic blend below,
    0 for x <= 0 (port of core/smoothing.py)."""
    pe = eps
    f3c = 1.0 / (pe * pe)
    f4c = -0.5 * f3c / pe
    half = 0.5 * pe
    xp = torch.clamp(x, min=0.0)
    blend = (f4c * xp + f3c) * xp * xp * xp
    return torch.where(xp < pe, blend, xp - half)
