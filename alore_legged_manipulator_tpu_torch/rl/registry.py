"""Task registry: named env+training configurations (port of
rl/registry.py, the same text over the port's `TrainConfig`).

The reference registers its environments with gym ids bundling the env
class, env cfg, and per-RL-library agent cfgs
(Training/b2z1_multiobj_wbc_gnn_plan/__init__.py:18-41:
`Isaac-Velocity-{Flat,Rough}-B2Z1MultiObjWBCGNNPLAN-Direct-v0`).  Here a
task id resolves to a complete `TrainConfig` (env cfg + PPO cfg bundled,
rl/runner.py) plus override hooks -- the same one-string entry point for
train scripts and sweeps, without the gym dependency.

Flat vs Rough in the reference differ by terrain; on the TPU surrogate
the analogous axis is the contact-difficulty of the push (friction and
mass ranges), so Rough widens randomization toward harder contacts.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from .env import PushEnvConfig
from .runner import TrainConfig

_REGISTRY: Dict[str, Callable[[], TrainConfig]] = {}


def register(task_id: str, factory: Callable[[], TrainConfig]):
    if task_id in _REGISTRY:
        raise ValueError(f"task {task_id!r} already registered")
    _REGISTRY[task_id] = factory


def list_tasks() -> List[str]:
    return sorted(_REGISTRY)


def make(task_id: str, **overrides) -> TrainConfig:
    """Resolve a task id to its TrainConfig; kwargs override top-level
    TrainConfig fields (e.g. make(id, num_envs=3072, iterations=500))."""
    if task_id not in _REGISTRY:
        raise KeyError(
            f"unknown task {task_id!r}; available: {list_tasks()}")
    cfg = _REGISTRY[task_id]()
    if overrides:
        cfg = cfg._replace(**overrides)
    return cfg


# -- built-in tasks (reference gym ids __init__.py:19, 32) -------------------

def _flat() -> TrainConfig:
    return TrainConfig(env=PushEnvConfig())


def _rough() -> TrainConfig:
    # harder contacts: heavier objects, wider/lower friction band
    return TrainConfig(env=PushEnvConfig(mass_range=(10.0, 60.0),
                                         friction_range=(0.2, 1.5),
                                         com_range=0.25))


register("Alore-Push-Flat-v0", _flat)
register("Alore-Push-Rough-v0", _rough)
