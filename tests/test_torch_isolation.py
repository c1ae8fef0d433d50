"""The port stands alone: it imports neither JAX nor the JAX package, and
its configs keep the JAX package's field names and defaults.

* A fresh interpreter imports every module of the port (the training
  modules `rl/ppo.py`, `rl/runner.py`, `rl/registry.py` and the camera
  path among them) and must find none of `jax`, `flax`, `optax`, `orbax`
  and `alore_legged_manipulator_tpu` in `sys.modules`.
* A scan of the port's sources finds no import of either.
* Every config NamedTuple the port shares with the JAX package has the
  same fields with equal defaults (nested configs compared field by
  field), and so do the dataclass configs (`PlanManagerConfig`,
  `FsmConfig`), whose dtype field names the same dtype, and the host
  dataclasses (`E2EScenario`: the same fields, the same defaults where
  there are any).
"""
import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import alore_legged_manipulator_tpu_torch as port_pkg
from alore_legged_manipulator_tpu_torch.convert import (DATACLASSES,
                                                      HOST_DATACLASSES,
                                                      _CLASSES, port_class,
                                                      torch_dtype)

ROOT = Path(port_pkg.__file__).resolve().parent
REPO = ROOT.parent


def _port_modules():
    names = [port_pkg.__name__]
    for info in pkgutil.walk_packages([str(ROOT)], port_pkg.__name__ + "."):
        names.append(info.name)
    return sorted(names)


def test_module_list_covers_the_slice():
    mods = _port_modules()
    for m in ("ops.wavefront", "ops.wavefront_cuda", "planner.backend",
              "solvers.bfgs", "solvers.lbfgs", "solvers.minco",
              "control.nmpc", "estimator.icr_ekf", "ops.qp",
              "runtime.mission_fleet", "convert", "utils.precision",
              "world.physics2d", "runtime.closed_loop_physics",
              "world.grid_map", "native", "planner.frontend",
              "mission.ordering", "mission.object_fsm",
              "mission.plan_manager", "runtime.arrangement",
              "control.ltv_mpc", "world.lidar", "config", "config.profiles",
              "runtime.planner_sim", "models", "models.nets", "models.gnn",
              "models.estimator", "models.actor_critic", "models.low_level",
              "models.torch_convert", "rl", "rl.obs_layout", "rl.env",
              "rl.hierarchy", "rl.env_physics", "rl.eval",
              "runtime.contracts", "runtime.remote", "runtime.z1_arm",
              "runtime.deploy", "runtime.obs_assembly",
              "runtime.bus_mission", "runtime.highlevel_controller",
              "rl.ppo", "rl.runner", "rl.registry", "world.camera",
              "world.voxel_map", "runtime.perception",
              "runtime.camera_perception"):
        assert f"{port_pkg.__name__}.{m}" in mods


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
            "'alore_legged_manipulator_tpu'))\n"
            "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout



def test_importing_the_port_needs_no_yaml():
    """PyYAML is imported only inside config.profiles.load_profile."""
    mods = _port_modules()
    code = ("import importlib, sys\n"
            "sys.modules['yaml'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "alore_legged_manipulator_tpu",
                           "flax", "optax", "orbax"), \
            f"{path.name} imports {name}"


def test_chip_smoke_imports_no_jax():
    for name in _imports(REPO / "chip_smoke.py"):
        assert name.split(".")[0] not in ("jax", "alore_legged_manipulator_tpu")


_CONFIGS = [n for n in sorted(_CLASSES) if n.endswith(("Config", "Params",
                                                       "Weights"))]
_JAX_MODULES = {n: "alore_legged_manipulator_tpu." + _CLASSES[n]
                for n in _CONFIGS}


def _same_defaults(jax_obj, port_obj, where):
    if hasattr(jax_obj, "_fields"):
        assert tuple(jax_obj._fields) == tuple(port_obj._fields), where
        for f in jax_obj._fields:
            _same_defaults(getattr(jax_obj, f), getattr(port_obj, f),
                           f"{where}.{f}")
    else:
        assert jax_obj == port_obj, f"{where}: {jax_obj!r} != {port_obj!r}"


@pytest.mark.parametrize("name", _CONFIGS)
def test_config_defaults_match(name):
    import importlib
    jax_cls = getattr(importlib.import_module(_JAX_MODULES[name]), name)
    port_cls = port_class(name)
    _same_defaults(jax_cls(), port_cls(), name)


@pytest.mark.parametrize("name", sorted(_CLASSES))
def test_class_fields_match(name):
    """Every class the port shares with the JAX package keeps its field
    names and their order, so `from_jax_numpy` can carry it over."""
    import importlib
    jax_cls = getattr(importlib.import_module(
        "alore_legged_manipulator_tpu." + _CLASSES[name]), name)
    assert tuple(jax_cls._fields) == tuple(port_class(name)._fields)


@pytest.mark.parametrize("name", sorted(DATACLASSES))
def test_dataclass_config_defaults_match(name):
    import importlib
    jax_cls = getattr(importlib.import_module(
        "alore_legged_manipulator_tpu." + DATACLASSES[name]), name)
    port_cls = port_class(name)
    names = [f.name for f in dataclasses.fields(jax_cls)]
    assert names == [f.name for f in dataclasses.fields(port_cls)]
    jax_obj, port_obj = jax_cls(), port_cls()
    for f in names:
        a, b = getattr(jax_obj, f), getattr(port_obj, f)
        if f == "dtype":
            assert torch_dtype(a) == b
        else:
            _same_defaults(a, b, f"{name}.{f}")


@pytest.mark.parametrize("name", sorted(HOST_DATACLASSES))
def test_host_dataclass_fields_match(name):
    import importlib
    jax_cls = getattr(importlib.import_module(
        "alore_legged_manipulator_tpu." + HOST_DATACLASSES[name]), name)
    jf = dataclasses.fields(jax_cls)
    tf = dataclasses.fields(port_class(name))
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert a.default == b.default, a.name
