"""Carry state from the JAX package into the port.

`from_jax_numpy(obj)` takes one of the JAX package's pytrees or configs
whose arrays have been turned into numpy arrays (for example with
`jax.tree.map(np.asarray, obj)`), and returns the port's object of the
same name, field by field: arrays become tensors (shape and dtype kept),
nested tuples and configs are converted recursively, plain numbers stay
as they are.  The dataclass configs (`PlanManagerConfig`, `FsmConfig`)
are carried the same way, their dtype fields (`jnp.float32`, ...) mapped
to the torch dtype of the same name.  A host dataclass (`E2EScenario`,
whose grid stays a numpy array on the host) is copied field by field.
The port's class is found by the JAX class's name, so this module
imports nothing of the JAX package.

The leading lane axis is the caller's business: convert a vmapped pytree
as it is, or add the axis before converting.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

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
}

# dataclass configs: class name -> module of the port that defines it
DATACLASSES = {
    "PlanManagerConfig": "mission.plan_manager",
    "FsmConfig": "mission.object_fsm",
}

# host dataclasses, copied as they are: class name -> module of the port
HOST_DATACLASSES = {
    "E2EScenario": "runtime.planner_sim",
}


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


def from_jax_numpy(obj, device=None):
    """Convert a numpy-leaved JAX-package pytree/config to the port."""
    if isinstance(obj, np.ndarray) or isinstance(obj, np.generic):
        return torch.as_tensor(np.array(obj), device=device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        name = type(obj).__name__
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
