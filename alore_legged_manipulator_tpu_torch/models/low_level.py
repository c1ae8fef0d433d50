"""Low-level whole-body-control policy architecture (port of
models/low_level.py).

The frozen visual-wholebody policy that turns proprioception + commands
into 18 joint targets:

  * StateHistoryEncoder: per-step linear projection to 30 channels,
    1-D convolutions over the 10-step history (channels-first
    `nn.Conv1d`), linear output.  The convolution output is flattened
    time-major (l * C + c), as the JAX package's channels-last reshape
    does, so a flax `Dense` kernel applies unchanged; a reference torch
    checkpoint, flattened channel-major, is permuted on conversion
    (`models/torch_convert.py`).
  * ActorCriticLow: proprio + privileged latent (encoded from the
    history, or from the privileged observation), backbone MLP,
    separate leg (12) / arm (6) heads.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .nets import MLP

# (kernel, stride) of each convolution per supported history length
_CONVS = {10: ((4, 2), (2, 1)), 20: ((6, 2), (4, 2)),
          50: ((8, 4), (5, 1), (5, 1))}


class StateHistoryEncoder(nn.Module):
    def __init__(self, num_prop: int, tsteps: int = 10,
                 output_size: int = 20, channels: int = 10):
        super().__init__()
        if tsteps not in _CONVS:
            raise ValueError("tsteps must be 10, 20 or 50")
        self.Dense_0 = nn.Linear(num_prop, 3 * channels)
        length, c_in = tsteps, 3 * channels
        self.n_convs = len(_CONVS[tsteps])
        for i, (k, s) in enumerate(_CONVS[tsteps]):
            c_out = 2 * channels if i == 0 else channels
            self.add_module(f"Conv_{i}", nn.Conv1d(c_in, c_out, k, stride=s))
            length, c_in = (length - k) // s + 1, c_out
        self.Dense_1 = nn.Linear(c_in * length, output_size)

    def forward(self, obs_hist: torch.Tensor) -> torch.Tensor:
        """obs_hist: (B, T, n_prop) -> (B, output_size)."""
        B = obs_hist.shape[0]
        x = F.elu(self.Dense_0(obs_hist)).transpose(1, 2)   # (B, 30, T)
        for i in range(self.n_convs):
            x = F.elu(getattr(self, f"Conv_{i}")(x))
        x = x.transpose(1, 2).reshape(B, -1)                # time-major
        return F.elu(self.Dense_1(x))


class ActorCriticLow(nn.Module):
    """Dual-head low-level policy: 12 leg + 6 arm joint targets."""

    def __init__(self, num_prop: int = 33, num_hist: int = 10,
                 num_priv: int = 9, priv_latent: int = 20,
                 backbone_hidden: Sequence[int] = (256, 256, 256),
                 leg_head_hidden: Sequence[int] = (128,),
                 arm_head_hidden: Sequence[int] = (128,),
                 num_leg_actions: int = 12, num_arm_actions: int = 6):
        super().__init__()
        self.priv_encoder = MLP(num_priv, (64,), priv_latent, act="elu",
                                final_act=True)
        self.history_encoder = StateHistoryEncoder(
            num_prop, tsteps=num_hist, output_size=priv_latent)
        self.backbone = MLP(num_prop + priv_latent, backbone_hidden[:-1],
                            backbone_hidden[-1], act="elu", final_act=True)
        self.leg_head = MLP(backbone_hidden[-1], leg_head_hidden,
                            num_leg_actions, act="elu")
        self.arm_head = MLP(backbone_hidden[-1], arm_head_hidden,
                            num_arm_actions, act="elu")

    def forward(self, prop, prop_hist, priv=None):
        """prop (B, num_prop) current proprioception; prop_hist
        (B, num_hist, num_prop); priv (B, num_priv) privileged state
        (training) or None (deployment: use the history encoder)."""
        if priv is not None:
            latent = self.priv_encoder(priv)
        else:
            latent = self.history_encoder(prop_hist)
        feat = self.backbone(torch.cat([prop, latent], dim=-1))
        return torch.cat([self.leg_head(feat), self.arm_head(feat)], dim=-1)
