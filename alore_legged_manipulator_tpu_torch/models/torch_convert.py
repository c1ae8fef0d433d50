"""Reference torch checkpoints and flax parameter trees -> the port's
modules.

The reference ships trained torch policies (deploy_real_b2z1_obj.py
loads jit-exported `.pt`; env_train.py:1401-1434 loads the frozen
low-level ActorCriticLow state_dict); the JAX package trains and stores
flax parameter trees (orbax).  Both arrive here as plain
`{name: np.ndarray}` data and leave as `state_dict`s of the port's
modules (`models/`):

  * `convert_*` take a reference torch state dict.  They first build
    the flax-layout tree exactly as the JAX package's
    `models/torch_convert.py` does (a copy of its numpy rules below),
    then rename it with `state_dict_from_flax`.
  * `state_dict_from_flax(tree)` takes a flax parameter tree (nested
    dicts of numpy arrays, `{"params": ...}` or its inside) and returns
    the `state_dict` of the port module whose layers carry flax's names:
      - a `Dense` kernel (in, out) becomes the `nn.Linear` weight, its
        transpose;
      - a `Conv` kernel (k, in_c, out_c) becomes the `nn.Conv1d` weight
        (out_c, in_c, k);
      - an `OptimizedLSTMCell` (gates i, f, g, o; kernels `i*` on the
        input, `h*` on the state, bias on the h side only) becomes the
        `nn.LSTM` named `lstm`: `weight_ih_l0` and `weight_hh_l0` stack
        the gates, `bias_hh_l0` is flax's bias and `bias_ih_l0` is zero.
  * `save_flax_npz` / `load_flax_npz` store a tree as one `.npz` whose
    keys are the '/'-joined paths; `load_highlevel_actor` builds the
    `PhysicActorCritic` of the committed trained weights
    (`models/weights/highlevel_physics_6000.npz`, or the 1500-iteration
    `highlevel_physics_1500.npz`).

Reference torch layout rules (the JAX package's, kept):
  * torch Linear stores (out, in); flax Dense wants (in, out)  -> W.T
  * torch Conv1d stores (out_c, in_c, k) channels-first; flax Conv wants
    (k, in_c, out_c) channels-last  -> transpose(2, 1, 0)
  * torch Flatten of (B, C, L) orders features c*L + l; the time-major
    flatten orders l*C + c -> the following Linear's columns are permuted
  * torch LSTM packs gates [i, f, g, o] into (4H, ...) blocks with two
    bias vectors (b_ih + b_hh are always summed).

Reference architectures: low_level_model.py:39-235 (ActorCriticLow),
rsl_rl/actor_critic_physic.py:26-151 (PhysicActorCritic),
rsl_rl/physic_estimator.py:7-100, rsl_rl/interactive_gnn.py:10-80.
"""
from __future__ import annotations

import os

import numpy as np
import torch

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "weights")
HIGHLEVEL_PHYSICS_6000 = os.path.join(WEIGHTS_DIR,
                                      "highlevel_physics_6000.npz")
# the exported actors of the JAX example's contact-plant run, by step
HIGHLEVEL_PHYSICS = {6000: HIGHLEVEL_PHYSICS_6000,
                     1500: os.path.join(WEIGHTS_DIR,
                                        "highlevel_physics_1500.npz")}
# the JAX package's seed-0 initial training parameters ({"actor",
# "critic"}): the start of examples/artifacts/train_physics_6000.csv
TRAIN_INIT_PHYSICS_SEED0 = os.path.join(WEIGHTS_DIR,
                                        "train_init_physics_seed0.npz")


def load_torch_state_dict(path):
    """Read a torch checkpoint into a plain numpy dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def _dense(sd, key):
    return {"kernel": np.ascontiguousarray(sd[key + ".weight"].T),
            "bias": sd[key + ".bias"].copy()}


def _seq_mlp(sd, prefix, indices):
    """nn.Sequential([Linear, act, Linear, ...]) -> {Dense_i: ...}."""
    return {f"Dense_{i}": _dense(sd, f"{prefix}.{j}")
            for i, j in enumerate(indices)}


def _conv1d(sd, key):
    return {"kernel": np.ascontiguousarray(
                sd[key + ".weight"].transpose(2, 1, 0)),
            "bias": sd[key + ".bias"].copy()}


def _flatten_permuted_dense(sd, key, channels, length):
    """Linear following a torch Flatten of (B, C, L) features.

    Our channels-last pipeline flattens (B, L, C); reorder the torch
    weight's input dimension from c*L+l to l*C+c.
    """
    W = sd[key + ".weight"]                       # (out, C*L)
    W = W.reshape(-1, channels, length)           # (out, C, L)
    W = W.transpose(0, 2, 1).reshape(-1, channels * length)  # (out, L*C)
    return {"kernel": np.ascontiguousarray(W.T),
            "bias": sd[key + ".bias"].copy()}


def _lstm_cell(sd, prefix, layer=0):
    """torch nn.LSTM layer -> flax OptimizedLSTMCell param dict."""
    w_ih = sd[f"{prefix}.weight_ih_l{layer}"]     # (4H, D)
    w_hh = sd[f"{prefix}.weight_hh_l{layer}"]     # (4H, H)
    b = (sd[f"{prefix}.bias_ih_l{layer}"]
         + sd[f"{prefix}.bias_hh_l{layer}"])      # (4H,)
    H = w_hh.shape[1]
    gates = ("i", "f", "g", "o")
    out = {}
    for gi, gname in enumerate(gates):
        sl = slice(gi * H, (gi + 1) * H)
        out[f"i{gname}"] = {
            "kernel": np.ascontiguousarray(w_ih[sl].T)}
        out[f"h{gname}"] = {
            "kernel": np.ascontiguousarray(w_hh[sl].T),
            "bias": b[sl].copy()}
    return out


# ---------------------------------------------------------------------------
# module-level converters
# ---------------------------------------------------------------------------

# conv1 output length per supported history length (StateHistoryEncoder
# second-conv input; low_level_model.py:55-70)
_SHE_FINAL_LEN = {10: 3, 20: 3, 50: 3}


def _flax_state_history_encoder(sd, prefix, channels=10):
    """StateHistoryEncoder (tsteps=10 variant: 2 convs)."""
    return {
        "Dense_0": _dense(sd, f"{prefix}.encoder.0"),
        "Conv_0": _conv1d(sd, f"{prefix}.conv_layers.0"),
        "Conv_1": _conv1d(sd, f"{prefix}.conv_layers.2"),
        "Dense_1": _flatten_permuted_dense(
            sd, f"{prefix}.linear_output.0", channels,
            _SHE_FINAL_LEN[10]),
    }


def _flax_low_level_actor(sd):
    """Reference ActorCriticLow state_dict -> flax ActorCriticLow params.

    Covers the actor path (the frozen policy the env runs,
    env_train.py:518): priv encoder, history encoder, backbone and both
    heads.  Returns {"params": ...} ready for `ActorCriticLow.apply`.
    """
    p = {
        "priv_encoder": _seq_mlp(sd, "actor.priv_encoder", (0, 2)),
        "history_encoder": _flax_state_history_encoder(
            sd, "actor.history_encoder"),
        "backbone": _seq_mlp(sd, "actor.actor_backbone", (0, 2, 4)),
        "leg_head": _seq_mlp(sd, "actor.actor_leg_control_head", (0, 2, 4)),
        "arm_head": _seq_mlp(sd, "actor.actor_arm_control_head", (0, 2, 4)),
    }
    return {"params": p}


def _flax_physic_estimator(sd, prefix="physic_estimator"):
    pre = prefix + "." if prefix else ""
    return {
        "OptimizedLSTMCell_0": _lstm_cell(sd, f"{pre}lstm"),
        "Dense_0": _dense(sd, f"{pre}output_head.0"),
        "Dense_1": _dense(sd, f"{pre}output_head.2"),
    }


def _flax_interactive_gnn(sd, prefix="interactive_gnn"):
    pre = prefix + "." if prefix else ""
    return {
        "_EdgeConv_0": {"MLP_0": _seq_mlp(sd, f"{pre}edge_mlp1.net",
                                          (0, 2))},
        "_EdgeConv_1": {"MLP_0": _seq_mlp(sd, f"{pre}edge_mlp2.net",
                                          (0, 2))},
        "MLP_0": _seq_mlp(sd, f"{pre}readout.net", (0, 2)),
    }


def _flax_physic_actor_critic(sd):
    """Reference PhysicActorCritic state_dict -> flax params.

    Actor side: shared MLP + base/arm heads + estimator + GNN + std.
    (The critic lives in a separate flax module; use `convert_critic`.)
    """
    p = {
        "physic_estimator": _flax_physic_estimator(sd),
        "interactive_gnn": _flax_interactive_gnn(sd),
        "shared_mlp": _seq_mlp(sd, "shared_mlp", (0, 2, 4)),
        "base_head": _dense(sd, "base_head"),
        "arm_head": _dense(sd, "arm_head"),
        "std": sd["std"].reshape(-1).copy(),
    }
    return {"params": p}


def _flax_critic(sd, prefix="critic"):
    """rsl_rl ActorCritic critic MLP ([512,256,128] + scalar head)."""
    return {"params": {
        "MLP_0": _seq_mlp(sd, prefix, (0, 2, 4)),
        "Dense_0": _dense(sd, f"{prefix}.6"),
    }}


# ---------------------------------------------------------------------------
# reference torch state dicts -> the port's state dicts
# ---------------------------------------------------------------------------

def convert_state_history_encoder(sd, prefix, channels=10):
    """StateHistoryEncoder (tsteps=10 variant: 2 convs)."""
    return state_dict_from_flax(
        _flax_state_history_encoder(sd, prefix, channels))


def convert_low_level_actor(sd):
    """Reference ActorCriticLow state_dict -> the port's ActorCriticLow
    state_dict (priv encoder, history encoder, backbone, both heads)."""
    return state_dict_from_flax(_flax_low_level_actor(sd))


def convert_physic_estimator(sd, prefix="physic_estimator"):
    return state_dict_from_flax(_flax_physic_estimator(sd, prefix))


def convert_interactive_gnn(sd, prefix="interactive_gnn"):
    return state_dict_from_flax(_flax_interactive_gnn(sd, prefix))


def convert_physic_actor_critic(sd):
    """Reference PhysicActorCritic state_dict -> the port's
    PhysicActorCritic state_dict (the actor side; `convert_critic` for
    the critic)."""
    return state_dict_from_flax(_flax_physic_actor_critic(sd))


def convert_critic(sd, prefix="critic"):
    """rsl_rl ActorCritic critic MLP ([512,256,128] + scalar head) -> the
    port's Critic state_dict."""
    return state_dict_from_flax(_flax_critic(sd, prefix))


# ---------------------------------------------------------------------------
# flax parameter trees -> the port's state dicts
# ---------------------------------------------------------------------------

_GATES = ("i", "f", "g", "o")


def _lstm_state_dict(cell, prefix):
    H = cell["hi"]["kernel"].shape[0]
    dt = cell["hi"]["kernel"].dtype
    return {
        prefix + "weight_ih_l0": np.concatenate(
            [np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GATES]),
        prefix + "weight_hh_l0": np.concatenate(
            [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES]),
        prefix + "bias_ih_l0": np.zeros(4 * H, dt),
        prefix + "bias_hh_l0": np.concatenate(
            [np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES]),
    }


def state_dict_from_flax(tree, prefix=""):
    """flax parameter tree (numpy leaves) -> {name: torch.Tensor}."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    out = {}
    for name, node in tree.items():
        if not isinstance(node, dict):
            out[prefix + name] = np.asarray(node)
        elif name.startswith("OptimizedLSTMCell"):
            out.update(_lstm_state_dict(node, prefix + "lstm."))
        elif "kernel" in node and not isinstance(node["kernel"], dict):
            k = np.asarray(node["kernel"])
            out[prefix + name + ".weight"] = (
                k.T if k.ndim == 2 else k.transpose(2, 1, 0))
            if "bias" in node:
                out[prefix + name + ".bias"] = np.asarray(node["bias"])
        else:
            out.update(state_dict_from_flax(node, prefix + name + "."))
    return {k: torch.as_tensor(np.ascontiguousarray(v))
            for k, v in out.items()}


def flax_from_state_dict(sd):
    """The inverse of `state_dict_from_flax`: a port module's state_dict
    -> its flax parameter tree `{"params": ...}` (numpy leaves).  The
    LSTM's two biases fold into flax's one (h-side) bias."""
    tree = {}

    def node(path):
        n = tree
        for p in path:
            n = n.setdefault(p, {})
        return n

    for name, t in sd.items():
        a = t.detach().cpu().numpy()
        *path, leaf = name.split(".")
        if path and path[-1] == "lstm":
            cell = path[:-1] + ["OptimizedLSTMCell_0"]
            side = "h" if leaf in ("weight_hh_l0", "bias_hh_l0") else "i"
            for g, blk in zip(_GATES, np.split(a, 4)):
                if leaf.startswith("weight"):
                    node(cell + [side + g])["kernel"] = \
                        np.ascontiguousarray(blk.T)
                else:
                    bias = node(cell + ["h" + g])
                    bias["bias"] = bias.get("bias", 0) + blk
        elif leaf == "weight":
            node(path)["kernel"] = np.ascontiguousarray(
                a.T if a.ndim == 2 else a.transpose(2, 1, 0))
        else:
            node(path)[leaf] = a
    return {"params": tree}


def flatten_flax(tree, prefix=""):
    """Nested dict -> {'a/b/c': array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_flax(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten_flax(flat):
    """{'a/b/c': array} -> nested dict."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_flax_npz(path, tree, dtype=np.float32):
    """Store a flax parameter tree as one compressed `.npz`."""
    np.savez_compressed(path, **{k: v.astype(dtype)
                                 for k, v in flatten_flax(tree).items()})


def load_flax_npz(path):
    with np.load(path) as z:
        return unflatten_flax({k: z[k] for k in z.files})


def load_highlevel_actor(device=None, path=HIGHLEVEL_PHYSICS_6000):
    """The trained contact-plant `PhysicActorCritic` (6000 PPO
    iterations of the JAX package's `examples/train_and_deploy_highlevel.py
    --physics`, or the export at `path`: `HIGHLEVEL_PHYSICS[1500]`),
    float32, in eval mode on `device` (None: the card)."""
    from ..utils.precision import resolve_device, set_precision_policy
    from .actor_critic import PhysicActorCritic

    set_precision_policy()
    actor = PhysicActorCritic()
    actor.load_state_dict(state_dict_from_flax(load_flax_npz(path)))
    return actor.to(resolve_device(device)).eval()
