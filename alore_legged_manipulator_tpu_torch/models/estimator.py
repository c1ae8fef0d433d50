"""LSTM physics estimator (port of models/estimator.py): object
(vx, vy, omega) from the observation history.

A single-layer LSTM(128) over the 11-step history, its last h state
through an MLP(64) head to 3 outputs.  The parameters live in a
`torch.nn.LSTM` (`batch_first`; gates i, f, g, o), so that reference
torch checkpoints load as they are; flax's `OptimizedLSTMCell` keeps
the bias on the h side only, so a converted flax tree sets `b_ih = 0`
and `b_hh` to flax's bias.

The recurrence is written out in plain operations (one input projection
for all steps, then per step the state projection, three sigmoids and
two tanh) rather than handed to `nn.LSTM`'s fused cuDNN kernel: on an
NVIDIA H100 that kernel's float32 estimate differed from the CPU's by
4.2e-6, which the trained actor (mean actions up to +-40) turned into
1.3e-4 between the devices' mean actions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class PhysicEstimator(nn.Module):
    def __init__(self, in_dim: int = 70, lstm_hidden: int = 128,
                 mlp_hidden: int = 64, out_dim: int = 3):
        super().__init__()
        self.lstm = nn.LSTM(in_dim, lstm_hidden, num_layers=1,
                            batch_first=True)
        # flax's cell has one bias, on the h side: the input-side bias
        # stays zero and is not trained
        self.lstm.bias_ih_l0.requires_grad_(False)
        self.Dense_0 = nn.Linear(lstm_hidden, mlp_hidden)
        self.Dense_1 = nn.Linear(mlp_hidden, out_dim)

    def last_hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The LSTM's h state after the last step, (B, H), from a zero
        carry (flax's `initialize_carry`)."""
        lstm = self.lstm
        xw = F.linear(x, lstm.weight_ih_l0, lstm.bias_ih_l0)   # (B, T, 4H)
        H = lstm.hidden_size
        h = x.new_zeros(x.shape[0], H)
        c = torch.zeros_like(h)
        for t in range(x.shape[1]):
            gates = xw[:, t] + F.linear(h, lstm.weight_hh_l0, lstm.bias_hh_l0)
            i, f, g, o = gates.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h

    def forward(self, obs_history: torch.Tensor) -> torch.Tensor:
        """obs_history: (B, T, D) -> (B, out_dim)."""
        return self.Dense_1(F.relu(self.Dense_0(self.last_hidden(
            obs_history))))
