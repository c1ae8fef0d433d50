"""Port parity: the task registry (`rl/registry.py`).

tests/test_rl.py::test_task_registry's assertions on the port, plus:
every task id resolves to the same `TrainConfig` in both packages (the
JAX package's converted with `from_jax_numpy`), and a registered task
trains end to end on the CPU at a tiny budget.
"""
import numpy as np
import pytest

from alore_legged_manipulator_tpu.rl import registry as jreg
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.rl import registry
from alore_legged_manipulator_tpu_torch.rl.runner import train


def test_task_registry():
    ids = registry.list_tasks()
    assert "Alore-Push-Flat-v0" in ids and "Alore-Push-Rough-v0" in ids
    flat = registry.make("Alore-Push-Flat-v0")
    rough = registry.make("Alore-Push-Rough-v0", num_envs=48, iterations=3)
    assert rough.num_envs == 48 and rough.iterations == 3
    assert rough.env.mass_range[1] > flat.env.mass_range[1]
    with pytest.raises(KeyError):
        registry.make("Nope-v0")
    with pytest.raises(ValueError):
        registry.register("Alore-Push-Flat-v0", lambda: flat)

    # a registered task trains end to end (tiny budget)
    cfg = registry.make("Alore-Push-Rough-v0", num_envs=6, steps_per_env=8,
                        iterations=2)
    _, hist = train(cfg, device="cpu")
    assert len(hist) == 2 and np.isfinite(hist[-1]["mean_reward"])


@pytest.mark.parametrize("task", ["Alore-Push-Flat-v0", "Alore-Push-Rough-v0"])
def test_tasks_equal_jax(task):
    assert registry.list_tasks() == jreg.list_tasks()
    over = dict(num_envs=1536, physics_env=True, iterations=10)
    assert registry.make(task, **over) == from_jax_numpy(
        jreg.make(task, **over))
