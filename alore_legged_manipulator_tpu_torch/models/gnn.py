"""Interaction GNN (port of models/gnn.py): edge-conditioned message
passing over the robot-base / joints / end-effector / object graph.

Two EdgeConv layers with edge attributes (max aggregation), a global
mean pool and an MLP readout to a 128-d embedding.  The topology is
fixed (9 nodes, the static 26-edge list), so the graph is dense tensors:
node features (B, 9, node_dim), edge attributes (B, E, 7), a gather by
the edge list and a scatter-max onto the receiving nodes.

`build_interaction_graph` takes any number of leading axes (the JAX
function builds one graph and is vmapped).  Quaternions are (x, y, z, w).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .nets import MLP

N_NODES = 9  # base, 6 joints, ee, object
NODE_DIM = 15
EDGE_DIM = 7


def _edge_list():
    """interactive_gnn.py:204-210: base->joints star, joint chain,
    joint6->ee, ee->object, plus reverses."""
    edges = [(0, j) for j in range(1, 7)]
    edges += [(j, j + 1) for j in range(1, 6)]
    edges.append((6, 7))
    edges.append((7, 8))
    edges += [(d, s) for (s, d) in edges]
    return np.asarray(edges, np.int32)  # (E, 2)


EDGES = _edge_list()
N_EDGES = EDGES.shape[0]


class GraphBatch(NamedTuple):
    nodes: torch.Tensor      # (B, 9, node_dim)
    edge_attr: torch.Tensor  # (B, E, edge_dim)


def quat_inverse(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def _onehot_and_base(dtype, device):
    onehot = torch.zeros((N_NODES, 4), dtype=dtype, device=device)
    onehot[0, 0] = 1.0
    onehot[1:7, 1] = 1.0
    onehot[7, 2] = 1.0
    onehot[8, 3] = 1.0
    base_pose = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype,
                             device=device)
    return onehot, base_pose


def build_interaction_graph(base_feat, joint_feats, ee_feat, object_feat,
                            joint_poses, ee_pose, object_pose) -> GraphBatch:
    """Assemble the graphs' node features and edge attributes.

    base_feat (..., 5), joint_feats (..., 6, 11), ee_feat (..., 8),
    object_feat (..., 10); poses are (..., 7) (xyz + xyzw quaternion) in
    the base frame.  Mirrors interactive_gnn.py:100-249: zero-pad every
    node to 11 dims, append a 4-d type one-hot, edge attrs = relative
    position and relative quaternion between endpoint poses.  Returns
    nodes (..., 9, 15) and edge_attr (..., E, 7).
    """
    dtype, dev = base_feat.dtype, base_feat.device
    lead = base_feat.shape[:-1]

    def pad_to(x, width):
        return F.pad(x, (0, width - x.shape[-1]))

    nodes = torch.cat([pad_to(base_feat, 11)[..., None, :], joint_feats,
                       pad_to(ee_feat, 11)[..., None, :],
                       pad_to(object_feat, 11)[..., None, :]], dim=-2)
    onehot, base_pose = _onehot_and_base(dtype, dev)
    nodes = torch.cat([nodes, onehot.expand(*lead, N_NODES, 4)], dim=-1)

    poses = torch.cat([base_pose.expand(*lead, 1, 7), joint_poses,
                       ee_pose[..., None, :], object_pose[..., None, :]],
                      dim=-2)                              # (..., 9, 7)
    src = torch.as_tensor(EDGES[:, 0], dtype=torch.long, device=dev)
    dst = torch.as_tensor(EDGES[:, 1], dtype=torch.long, device=dev)
    p_src = poses[..., src, :]
    p_dst = poses[..., dst, :]
    rel_pos = p_dst[..., :3] - p_src[..., :3]
    rel_quat = quat_mul(p_dst[..., 3:], quat_inverse(p_src[..., 3:]))
    return GraphBatch(nodes=nodes,
                      edge_attr=torch.cat([rel_pos, rel_quat], dim=-1))


class _EdgeConv(nn.Module):
    """EdgeConv with edge attrs, max aggregation (EdgeConvWithEdgeAttr)."""

    def __init__(self, in_dim: int, hidden: int, edge_dim: int = EDGE_DIM):
        super().__init__()
        self.hidden = hidden
        self.MLP_0 = MLP(2 * in_dim + edge_dim, (64,), hidden, act="relu")
        self.register_buffer("src", torch.as_tensor(EDGES[:, 0],
                                                    dtype=torch.long),
                             persistent=False)
        self.register_buffer("dst", torch.as_tensor(EDGES[:, 1],
                                                    dtype=torch.long),
                             persistent=False)

    def forward(self, x, edge_attr):
        # x: (B, 9, D); messages on the static edge list
        x_i = x[:, self.dst]          # central node (receives)
        x_j = x[:, self.src]          # neighbor
        msg = self.MLP_0(torch.cat([x_i, x_j, edge_attr], dim=-1))
        # segment-max over incoming edges per node
        out = torch.full((x.shape[0], N_NODES, self.hidden), -1e30,
                         dtype=msg.dtype, device=msg.device)
        idx = self.dst.view(1, -1, 1).expand(x.shape[0], -1, self.hidden)
        out = out.scatter_reduce(1, idx, msg, reduce="amax")
        return torch.where(out <= -1e29, torch.zeros_like(out), out)


class InteractiveGNN(nn.Module):
    def __init__(self, node_dim: int = NODE_DIM, hidden_dim: int = 64,
                 out_dim: int = 128):
        super().__init__()
        self._EdgeConv_0 = _EdgeConv(node_dim, hidden_dim)
        self._EdgeConv_1 = _EdgeConv(hidden_dim, hidden_dim)
        self.MLP_0 = MLP(hidden_dim, (64,), out_dim, act="relu")

    def forward(self, g: GraphBatch):
        x = F.relu(self._EdgeConv_0(g.nodes, g.edge_attr))
        x = F.relu(self._EdgeConv_1(x, g.edge_attr))
        pooled = torch.mean(x, dim=1)              # global mean pool
        return self.MLP_0(pooled)
