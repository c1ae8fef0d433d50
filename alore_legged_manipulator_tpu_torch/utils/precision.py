"""Numerical-precision policy and device selection.

The planner's contractions are tiny and their accuracy gates
convergence (see the JAX package's utils/precision.py), so the port runs
every float32 product in full float32: TF32 is switched off for both
matrix products and cuDNN.  No bfloat16 appears anywhere in the port.
"""
from __future__ import annotations

import torch


def set_precision_policy() -> None:
    """Full-f32 contractions on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """Entry-point device: None means the card.  Raises when CUDA is
    asked for and missing; never switches to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "on the CPU")
    return dev


def hdot(a, b):
    """Batched dot product over the last axis."""
    return torch.sum(a * b, dim=-1)
