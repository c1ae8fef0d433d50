"""High-level object-velocity policy, actor and critic (port of
models/actor_critic.py).

The actor consumes the 11-step observation history augmented per step
with the (detached) LSTM velocity estimate, concatenated with the 128-d
interaction-GNN embedding, through a shared MLP with separate base (3)
and arm (6) heads; a Gaussian policy with a learned state-independent
std.  The critic is a plain MLP on the 161-d privileged observation.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .estimator import PhysicEstimator
from .gnn import GraphBatch, InteractiveGNN
from .nets import MLP

N_BASE_ACTIONS = 3
N_ARM_ACTIONS = 6


class PhysicActorCritic(nn.Module):
    def __init__(self, obs_dim: int = 70, history_length: int = 11,
                 actor_hidden: Sequence[int] = (512, 256, 128),
                 init_noise_std: float = 1.0, gnn_out: int = 128):
        super().__init__()
        self.history_length = history_length
        self.physic_estimator = PhysicEstimator(in_dim=obs_dim)
        self.interactive_gnn = InteractiveGNN(out_dim=gnn_out)
        self.shared_mlp = MLP(history_length * (obs_dim + 3) + gnn_out,
                              actor_hidden[:-1], actor_hidden[-1],
                              act="elu", final_act=True)
        self.base_head = nn.Linear(actor_hidden[-1], N_BASE_ACTIONS)
        self.arm_head = nn.Linear(actor_hidden[-1], N_ARM_ACTIONS)
        self.std = nn.Parameter(torch.full(
            (N_BASE_ACTIONS + N_ARM_ACTIONS,), float(init_noise_std)))

    def forward(self, obs_history: torch.Tensor, graph: GraphBatch
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs_history (B, T, D), graph built from privileged state.

        Returns (mean (B, 9), std (9,), vel_estimate (B, 3)).
        """
        B, T, _ = obs_history.shape
        vel_est = self.physic_estimator(obs_history)
        vel_tiled = vel_est.detach()[:, None, :].expand(B, T, 3)
        obs_aug = torch.cat([obs_history, vel_tiled], dim=-1)
        z = self.interactive_gnn(graph)                    # (B, 128)
        feat = self.shared_mlp(torch.cat([obs_aug.reshape(B, -1), z],
                                         dim=-1))
        mean = torch.cat([self.base_head(feat), self.arm_head(feat)],
                         dim=-1)
        return mean, self.std, vel_est


class Critic(nn.Module):
    def __init__(self, in_dim: int = 161,
                 hidden: Sequence[int] = (512, 256, 128)):
        super().__init__()
        self.MLP_0 = MLP(in_dim, hidden[:-1], hidden[-1], act="elu",
                         final_act=True)
        self.Dense_0 = nn.Linear(hidden[-1], 1)

    def forward(self, critic_obs: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(self.MLP_0(critic_obs))[..., 0]
