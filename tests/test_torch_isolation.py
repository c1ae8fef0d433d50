"""The port stands alone: it imports neither JAX nor the JAX package, and
its configs keep the JAX package's field names and defaults.

* A fresh interpreter imports every module of the port (the training
  modules `rl/ppo.py`, `rl/runner.py`, `rl/registry.py` and the camera
  path among them) and must find none of `jax`, `flax`, `optax`, `orbax`
  and `alore_legged_manipulator_tpu` in `sys.modules`.
* A scan of the port's sources finds no import of either.
* The port has a twin of every module of the JAX package (its
  `native/bus.cpp` too), byte for byte where the source is C++, and
  each twin defines every public top-level name of its JAX module (an
  AST scan), but for the JAX `precision=` helpers.
* Every config NamedTuple the port shares with the JAX package has the
  same fields with equal defaults (nested configs compared field by
  field), and so do the dataclass configs (`PlanManagerConfig`,
  `FsmConfig`), whose dtype field names the same dtype, and the host
  dataclasses (`E2EScenario`: the same fields, the same defaults where
  there are any).
* Every JAX example has its twin in the port's `examples/` (the seven
  throughput benches among them) or a stated reason, and the repo's
  `bench.py` its twin in the package with the same metric names; the
  throughput twins use no CUDA graphs and no `torch.compile`.
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
              "runtime.camera_perception", "parallel", "parallel.mesh",
              "parallel.scaling", "parallel.dryrun", "utils.profiling",
              "solvers.minco_s4", "ops.roots", "ops.sdlp", "world.scene",
              "world.octomap_io", "runtime.transport",
              "runtime.native_transport", "utils.viz", "bench",
              "examples.bench_backend", "examples.bench_closed_loop",
              "examples.bench_frontend", "examples.bench_mapping",
              "examples.bench_mission_fleet", "examples.bench_mission_legs",
              "examples.bench_physics_env"):
        assert f"{port_pkg.__name__}.{m}" in mods


def test_every_jax_module_has_its_twin():
    jax_root = REPO / "alore_legged_manipulator_tpu"
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root)
        if rel.name == "wavefront_pallas.py":      # csrc/wavefront.cu
            continue
        assert (ROOT / rel).exists(), f"no twin of {rel}"
    for name in ("jps.cpp", "bus.cpp"):
        assert (ROOT / "native" / name).read_bytes() == \
            (jax_root / "native" / name).read_bytes(), name


def _public_names(path):
    """Names a module defines at its top level (functions, classes,
    assignments, also under a top-level if / try), those without a
    leading underscore."""
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(n.id for t in node.targets for n in ast.walk(t)
                             if isinstance(n, ast.Name))
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
                for h in getattr(node, "handlers", []):
                    visit(h.body)
                visit(getattr(node, "finalbody", []))
    visit(ast.parse(path.read_text()).body)
    return {n for n in names if not n.startswith("_")}


# The JAX package's per-call `precision=` helpers: the port sets its
# precision policy once (`utils/precision.py::set_precision_policy`:
# TF32 off, float32 matmuls at full precision) instead of passing a
# precision to each contraction, so it has no twin of these.
PRECISION_ONLY = {"utils/precision.py": {"HIGHEST", "heinsum", "hmatvec"}}
# The JAX package's EWMA stage timer, which times the enqueue: the port's
# tracer (`utils/profiling.py`: spans on the profiler's clock, stream
# time, host syncs) takes its place.
REPLACED = {"utils/profiling.py": {"StageTimer"}}


def test_every_public_name_has_its_twin():
    jax_root = REPO / "alore_legged_manipulator_tpu"
    missing = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root)
        if rel.name == "wavefront_pallas.py":      # csrc/wavefront.cu
            continue
        gap = (_public_names(path) - _public_names(ROOT / rel)
               - PRECISION_ONLY.get(str(rel), set())
               - REPLACED.get(str(rel), set()))
        if gap:
            missing[str(rel)] = sorted(gap)
    assert not missing, missing
    for rel, names in {**PRECISION_ONLY, **REPLACED}.items():
        assert names <= _public_names(jax_root / rel)
        assert not names & _public_names(ROOT / rel)


def _reexports(init_path):
    """(module, name, alias) of every relative `from .module import name
    [as alias]` in a subpackage's `__init__.py`."""
    for node in ast.walk(ast.parse(init_path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for a in node.names:
                yield node.module, a.name, a.asname or a.name


_SUBPACKAGES = sorted(
    p.parent.name for p in
    (REPO / "alore_legged_manipulator_tpu").glob("*/__init__.py"))


@pytest.mark.parametrize("sub", _SUBPACKAGES)
def test_every_subpackage_reexport_has_its_twin(sub):
    """Each name a JAX subpackage re-exports is re-exported by the port's
    subpackage of the same name, and is the port module's own object."""
    import importlib
    jax_init = REPO / "alore_legged_manipulator_tpu" / sub / "__init__.py"
    port_sub = importlib.import_module(f"{port_pkg.__name__}.{sub}")
    for module, name, alias in _reexports(jax_init):
        src = importlib.import_module(f"{port_pkg.__name__}.{sub}.{module}")
        assert hasattr(port_sub, alias), f"{sub}: no {alias}"
        assert getattr(port_sub, alias) is getattr(src, name), \
            f"{sub}.{alias} is not {sub}.{module}.{name}"


# the JAX package's user-facing examples (examples/*.py) with a twin in
# the port's examples/ subpackage, and those without one and why
EXAMPLE_TWINS = ("arrangement_mission.py", "mission_validation.py",
                 "planner_sim.py", "train_and_deploy_highlevel.py",
                 "bench_backend.py", "bench_closed_loop.py",
                 "bench_frontend.py", "bench_mapping.py",
                 "bench_mission_fleet.py", "bench_mission_legs.py",
                 "bench_physics_env.py")
_XLA_QUESTION = "asks an XLA question (compile cache, on-chip chained " \
    "timing, shape buckets) with no eager counterpart"
EXAMPLES_WITHOUT_TWIN = {
    "precompile.py": _XLA_QUESTION,
    "latency_onchip.py": _XLA_QUESTION,
    "roofline_backend.py": _XLA_QUESTION,
    "roofline_mission_twophase.py": _XLA_QUESTION,
    "roofline_wavefront.py": _XLA_QUESTION,
    "bucketing_study.py": _XLA_QUESTION,
}


def test_every_example_has_its_twin_or_a_reason():
    examples = {p.name for p in (REPO / "examples").glob("*.py")}
    assert not set(EXAMPLE_TWINS) & set(EXAMPLES_WITHOUT_TWIN)
    assert examples == set(EXAMPLE_TWINS) | set(EXAMPLES_WITHOUT_TWIN), \
        sorted(examples ^ (set(EXAMPLE_TWINS) | set(EXAMPLES_WITHOUT_TWIN)))
    for name in EXAMPLE_TWINS:
        twin = ROOT / "examples" / name
        assert twin.exists(), f"no twin of examples/{name}"
        tree = ast.parse(twin.read_text())
        main = [n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main"]
        assert main and [a.arg for a in main[0].args.args] == ["argv"], name
        assert '"--device"' in twin.read_text(), name


def _metrics(path):
    """The `metric` values of every `json.dumps({...})` literal of a file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Dict):
            keys = [k.value if isinstance(k, ast.Constant) else None
                    for k in node.keys]
            if "metric" in keys:
                out.append(node.values[keys.index("metric")].value)
    return sorted(out)


def test_bench_has_its_twin_in_the_package():
    """The repo's `bench.py` has its twin in the package (not at the repo
    root, as `entry.py` is the twin of `__graft_entry__.py`): `main(argv)`
    with `--device`, and the same five metric names."""
    twin = ROOT / "bench.py"
    assert twin.exists()
    tree = ast.parse(twin.read_text())
    main = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name == "main"]
    assert main and [a.arg for a in main[0].args.args] == ["argv"]
    assert '"--device"' in twin.read_text()
    assert len(_metrics(REPO / "bench.py")) == 5
    assert _metrics(twin) == _metrics(REPO / "bench.py")


def test_benches_use_no_graphs_or_compile():
    """The throughput twins time the eager port: no CUDA graphs, no
    torch.compile."""
    for path in [ROOT / "bench.py"] + sorted(
            (ROOT / "examples").glob("bench_*.py")):
        text = path.read_text()
        for word in ("CUDAGraph", "cuda.graph", "torch.compile"):
            assert word not in text, f"{path.name} uses {word}"


def test_obstacle_terrain_config_defaults_match():
    from alore_legged_manipulator_tpu.world.scene import (
        ObstacleTerrainConfig as J)
    from alore_legged_manipulator_tpu_torch.world.scene import (
        ObstacleTerrainConfig as T)
    names = [f.name for f in dataclasses.fields(J)]
    assert names == [f.name for f in dataclasses.fields(T)]
    assert all(getattr(J(), n) == getattr(T(), n) for n in names)


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


# what chip_smoke.py imports of the tests: the golden readers (with the
# back-end oracle's) and the port-side replays of the golden tests
CHIP_SMOKE_TEST_IMPORTS = ("torch_golden_io.py",
                           "golden/backend_oracle/oracle_io.py",
                           "test_torch_golden_backend.py",
                           "test_torch_golden_trajanal.py",
                           "test_torch_golden_ekf.py",
                           "test_torch_golden_esdf.py",
                           "test_torch_golden_plant.py")


def test_chip_smoke_imports_no_jax():
    for path in ["chip_smoke.py"] + [f"tests/{n}"
                                     for n in CHIP_SMOKE_TEST_IMPORTS]:
        for name in _imports(REPO / path):
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "alore_legged_manipulator_tpu"), \
                f"{path} imports {name}"


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
