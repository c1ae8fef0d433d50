"""Carry state from the JAX package into the port.

`from_jax_numpy(obj)` takes one of the JAX package's pytrees or configs
whose arrays have been turned into numpy arrays (for example with
`jax.tree.map(np.asarray, obj)`), and returns the port's object of the
same name, field by field: arrays become tensors (shape and dtype kept),
nested tuples and configs are converted recursively, plain numbers stay
as they are.  The port's class is found by the JAX class's name, so this
module imports nothing of the JAX package.

The leading lane axis is the caller's business: convert a vmapped pytree
as it is, or add the axis before converting.
"""
from __future__ import annotations

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
    "PlantState": "world.plant",
    "PlantConfig": "world.plant",
    "TrackedTraj": "control.tracked_traj",
    "LoopConfig": "runtime.closed_loop",
    "LbfgsParams": "solvers.lbfgs",
    "BackendWeights": "planner.backend",
    "PathWeights": "planner.backend",
    "AlmConfig": "planner.backend",
    "BackendConfig": "planner.backend",
    "FleetFsmConfig": "runtime.mission_fleet",
    "MissionFleetConfig": "runtime.mission_fleet",
}


def port_class(name: str):
    """The port's class for a JAX class name."""
    mod = importlib.import_module(f"{__package__}.{_CLASSES[name]}")
    return getattr(mod, name)


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
    if isinstance(obj, tuple):
        return tuple(from_jax_numpy(v, device) for v in obj)
    if isinstance(obj, list):
        return [from_jax_numpy(v, device) for v in obj]
    return obj
