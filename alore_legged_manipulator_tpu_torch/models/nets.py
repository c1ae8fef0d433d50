"""Small shared network blocks (port of models/nets.py).

Every layer is registered under the name flax gives it (`Dense_0`,
`Dense_1`, ...), so a flax parameter tree maps onto the module's
`state_dict` by renaming paths alone (`models/torch_convert.py::
state_dict_from_flax`).  A flax `Dense` kernel is (in, out); the
`nn.Linear` weight is its transpose.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTS = {"elu": F.elu, "relu": F.relu}


class MLP(nn.Module):
    """Linear stack with an activation between layers.

    in_dim: input width (flax infers it; torch needs it); hidden: hidden
    widths; out: output width; final_act: apply the activation after
    the last layer too (the reference uses both styles).
    """

    def __init__(self, in_dim: int, hidden: Sequence[int], out: int,
                 act: str = "elu", final_act: bool = False):
        super().__init__()
        self.act = _ACTS[act]
        self.final_act = final_act
        widths = [in_dim, *hidden, out]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1 or self.final_act:
                x = self.act(x)
        return x
