"""Carry state from the JAX package into the port.

`from_jax_numpy(obj)` takes one of the JAX package's pytrees or configs
whose arrays have been turned into numpy arrays (for example with
`jax.tree.map(np.asarray, obj)`), and returns the port's object of the
same name, field by field: arrays become tensors (shape and dtype kept),
nested tuples and configs are converted recursively, plain numbers stay
as they are.  The dataclass configs (`PlanManagerConfig`, `FsmConfig`)
are carried the same way, their dtype fields (`jnp.float32`, ...) mapped
to the torch dtype of the same name.  A host dataclass (`E2EScenario`,
whose grid stays a numpy array on the host; `ObstacleTerrainConfig`,
`Scene`) is copied field by field.
The port's class is found by the JAX class's name, so this module
imports nothing of the JAX package.

The leading lane axis is the caller's business: convert a vmapped pytree
as it is, or add the axis before converting (`add_lane_axis`).

`state_dict_from_flax` (from `models/torch_convert.py`) carries the JAX
package's flax parameter trees, as numpy, into the `state_dict`s of the
port's `PhysicActorCritic`, `Critic` and `ActorCriticLow`.  Two classes
hold such trees and are carried by their own rules:

  * `PpoState`: its `{"actor", "critic"}` parameters become the port's
    modules (`rl/runner.py::load_models`) and optax's `ScaleByAdamState`
    (mu, nu, count) becomes a `torch.optim.Adam` over their trainable
    parameters (exp_avg, exp_avg_sq, step); the lr becomes a float.
  * `TrainConfig`: a `low_level_params` tree becomes the frozen
    `ActorCriticLow` module the port's runner takes.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from .models.torch_convert import state_dict_from_flax  # noqa: F401

# class name -> module of the port that defines it
_CLASSES = {
    "ESDF": "ops.esdf",
    "ICRParams": "core.dynamics",
    "PolyTraj": "core.poly",
    "FlatTraj": "planner.flat_traj",
    "Polynome": "planner.flat_traj",
    "NmpcCarry": "control.nmpc",
    "NmpcConfig": "control.nmpc",
    "EkfState": "estimator.icr_ekf",
    "EkfConfig": "estimator.icr_ekf",
    "FirstOrderFilter": "estimator.icr_ekf",
    "SimpleIcrState": "estimator.icr_ekf",
    "ConvergenceMonitor": "estimator.icr_ekf",
    "PlantState": "world.plant",
    "PlantConfig": "world.plant",
    "TrackedTraj": "control.tracked_traj",
    "LoopConfig": "runtime.closed_loop",
    "TrackingResult": "runtime.closed_loop",
    "MincoProblem": "solvers.minco",
    "LbfgsParams": "solvers.lbfgs",
    "BackendWeights": "planner.backend",
    "PathWeights": "planner.backend",
    "AlmConfig": "planner.backend",
    "BackendConfig": "planner.backend",
    "BackendResult": "planner.backend",
    "FleetFsmConfig": "runtime.mission_fleet",
    "MissionFleetConfig": "runtime.mission_fleet",
    "MissionFleetResult": "runtime.mission_fleet",
    "BodyState": "world.physics2d",
    "PhysicsConfig": "world.physics2d",
    "Manifold": "world.physics2d",
    "ContactDebug": "world.physics2d",
    "PhysicsLoopConfig": "runtime.closed_loop_physics",
    "PhysicsTrackingResult": "runtime.closed_loop_physics",
    "FrontendConfig": "planner.frontend",
    "LtvMpcConfig": "control.ltv_mpc",
    "LtvMpcCarry": "control.ltv_mpc",
    "LidarConfig": "world.lidar",
    "OccupancyConfig": "world.lidar",
    "OccupancyState": "world.lidar",
    "GraphBatch": "models.gnn",
    "LowObsState": "runtime.obs_assembly",
    "RobotView": "rl.obs_layout",
    "PushEnvConfig": "rl.env",
    "PushEnvState": "rl.env",
    "HierarchyConfig": "rl.hierarchy",
    "RobotState": "rl.hierarchy",
    "PhysicsEnvConfig": "rl.env_physics",
    "PhysPushEnvState": "rl.env_physics",
    "PpoConfig": "rl.ppo",
    "Rollout": "rl.ppo",
    "TrainConfig": "rl.runner",
    "CameraModel": "world.camera",
    "BoxScene": "world.camera",
    "VoxelMapConfig": "world.voxel_map",
    "VoxelMapState": "world.voxel_map",
    "OctomapTree": "world.octomap_io",
    "ScalingPoint": "parallel.scaling",
}

# dataclass configs: class name -> module of the port that defines it
DATACLASSES = {
    "PlanManagerConfig": "mission.plan_manager",
    "FsmConfig": "mission.object_fsm",
}

# host dataclasses, copied as they are: class name -> module of the port
HOST_DATACLASSES = {
    "E2EScenario": "runtime.planner_sim",
    "DeployConfig": "runtime.deploy",
    "ObstacleTerrainConfig": "world.scene",
    "Scene": "world.scene",
}


def add_lane_axis(obj):
    """Prefix every array leaf of a numpy-leaved pytree with a lane axis
    of 1 (a single JAX env state -> a one-lane port state)."""
    if isinstance(obj, (np.ndarray, np.generic)):
        return np.asarray(obj)[None]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(add_lane_axis(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(add_lane_axis(v) for v in obj)
    return obj


def port_class(name: str):
    """The port's class for a JAX class name."""
    where = _CLASSES.get(name) or DATACLASSES.get(name) \
        or HOST_DATACLASSES[name]
    mod = importlib.import_module(f"{__package__}.{where}")
    return getattr(mod, name)


def torch_dtype(dt):
    """The torch dtype named like a numpy or JAX dtype (jnp.float32,
    np.float64, np.dtype('float32'), ...)."""
    return getattr(torch, np.dtype(dt).name)


def _ppo_state(obj, device):
    """JAX `PpoState` (numpy leaves) -> the port's, on `device` (None:
    the CPU), in the parameters' dtype."""
    from .rl.ppo import PpoConfig, ppo_init
    from .rl.runner import load_models

    leaf = np.asarray(obj.params["critic"]["params"]["Dense_0"]["kernel"])
    models = load_models(obj.params, device=device or "cpu",
                         dtype=torch_dtype(leaf.dtype))
    params = {"actor": models.actor, "critic": models.critic}
    state = ppo_init(params, PpoConfig(lr=float(obj.lr)))
    adam, = [s for s in obj.opt_state
             if type(s).__name__ == "ScaleByAdamState"]
    for k, m in params.items():
        mu = state_dict_from_flax(adam.mu[k])
        nu = state_dict_from_flax(adam.nu[k])
        for name, p in m.named_parameters():
            if p.requires_grad:
                state.opt_state.state[p] = {
                    "step": torch.tensor(float(np.asarray(adam.count)),
                                         dtype=torch.float32),
                    "exp_avg": mu[name].to(p),
                    "exp_avg_sq": nu[name].to(p)}
    return state


def _low_level(tree, device):
    """A flax low-level parameter tree -> the frozen `ActorCriticLow`."""
    from .rl.hierarchy import low_level_policy_cfg

    leaf = np.asarray(tree["params"]["backbone"]["Dense_0"]["kernel"])
    low = low_level_policy_cfg().to(device=device or "cpu",
                                    dtype=torch_dtype(leaf.dtype))
    low.load_state_dict(state_dict_from_flax(tree))
    return low.requires_grad_(False)


def from_jax_numpy(obj, device=None):
    """Convert a numpy-leaved JAX-package pytree/config to the port."""
    if isinstance(obj, np.ndarray) or isinstance(obj, np.generic):
        return torch.as_tensor(np.array(obj), device=device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        name = type(obj).__name__
        if name == "PpoState":
            return _ppo_state(obj, device)
        if name == "TrainConfig" and isinstance(obj.low_level_params, dict):
            low = _low_level(obj.low_level_params, device)
            return from_jax_numpy(obj._replace(low_level_params=None),
                                  device)._replace(low_level_params=low)
        if name not in _CLASSES:
            raise TypeError(f"no port counterpart for {name}")
        cls = port_class(name)
        if tuple(cls._fields) != tuple(obj._fields):
            raise TypeError(f"{name}: fields differ between the JAX package "
                            f"{obj._fields} and the port {cls._fields}")
        return cls(*(from_jax_numpy(v, device) for v in obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name in HOST_DATACLASSES:
            return port_class(name)(**{
                f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj)})
        if name not in DATACLASSES:
            raise TypeError(f"no port counterpart for {name}")
        cls = port_class(name)
        names = [f.name for f in dataclasses.fields(obj)]
        if names != [f.name for f in dataclasses.fields(cls)]:
            raise TypeError(f"{name}: fields differ between the JAX package "
                            "and the port")
        return cls(**{k: (torch_dtype(v) if k == "dtype"
                          else from_jax_numpy(v, device))
                      for k, v in ((n, getattr(obj, n)) for n in names)})
    if isinstance(obj, tuple):
        return tuple(from_jax_numpy(v, device) for v in obj)
    if isinstance(obj, list):
        return [from_jax_numpy(v, device) for v in obj]
    return obj
