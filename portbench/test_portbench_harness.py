"""The harness's own arithmetic and lookup, on the CPU: metric readers,
the trace reduction, finding cells, configurations, traffic and readers
by name (one of each added from a temporary folder), and the check that
no JAX module was loaded."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import run, trace

# BENCHMARK.json with the cell kept ready in portbench/pending/
BENCH = run.load_bench("replan-b1")


def read(name, rec):
    return run.load_reader(name, os.path.join(run.HERE, "metrics"))(rec)


def test_tick_p95_is_over_every_tick():
    lat = [0.07] * 94 + [0.5] * 6          # six stalls in a hundred ticks
    assert read("tick_p95_ms", {"latencies_s": lat}) == pytest.approx(500.0)
    assert read("tick_p95_ms", {"latencies_s": [0.07] * 96 + [0.5] * 4}) \
        == pytest.approx(np.percentile([70.0] * 96 + [500.0] * 4, 95))


@pytest.mark.parametrize("name", ["plans_per_s", "scenario_ticks_per_s"])
def test_rates_are_over_the_whole_window(name):
    rec = {"lanes": 512, "requests": 12, "elapsed_s": 48.0,
           "latencies_s": [1.0] * 12}
    # all the work over all the time: not the median call's rate
    assert read(name, rec) == pytest.approx(512 * 12 / 48.0)


def test_trace_reduction_union_and_gaps():
    dev = [(100, 200, "k1"), (150, 300, "k2"), (500, 600, "k1"),
           (900, 1200, "k3")]                      # the last one clipped
    host = [(0, 1000, "outer"), (320, 480, "aten::mul"), (330, 340, "x")]
    s = trace.summarize((0, 1000), dev, host)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx(400e-9)       # 100-300, 500-600, 900-1000
    assert s.device_ops == 4
    assert dict(s.device_top) == pytest.approx(
        {"k1": 200e-9, "k2": 150e-9, "k3": 100e-9})
    gaps = dict(s.idle_gaps)
    assert gaps["aten::mul"] == pytest.approx(200e-9)   # 300-500
    assert gaps["outer"] == pytest.approx(400e-9)       # 0-100, 600-900
    rec = {"trace": s, "traced_requests": 2}
    assert read("device_idle_pct.tick", rec) == pytest.approx(60.0)
    assert read("launches_per_tick.b1", rec) == pytest.approx(2.0)
    assert read("device_ms_per_plan", rec) == pytest.approx(200e-9 * 1e3)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]
                                  if m["source"] == "device_trace"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert read(name, {"trace": None, "traced_requests": 1}) is None


def test_every_cell_finds_its_files_and_metrics():
    for cell in BENCH["workloads"]:
        _, config, traffic, e2e, layer = run.cell_spec(BENCH, cell["name"])
        assert os.path.exists(os.path.join(
            run.HERE, "drivers", traffic["driver"] + ".py"))
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        assert all(m["moves"] in names for m in layer)
        for m in e2e + layer:
            assert callable(run.load_reader(
                m["name"], os.path.join(run.HERE, "metrics")))
        assert config["dtype"] == "float32"
    for m in BENCH["per_layer"]:
        # each per-layer metric lists only cells that report what it moves
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in run.cell_spec(BENCH, w)[3]}


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    """A new configuration, traffic mix and per-layer metric are new
    files and new entries of BENCHMARK.json; no file changes."""
    conf = run.load_json(run.HERE, "configs", "nmpc-icrekf-3ms.json")
    conf["nmpc"]["horizon"] = 20
    (tmp_path / "nmpc-short.json").write_text(json.dumps(conf))
    traffic_dir, metrics_dir = tmp_path / "traffic", tmp_path / "metrics"
    traffic_dir.mkdir()
    metrics_dir.mkdir()
    mix = run.load_json(run.HERE, "traffic", "closed-loop-1.json")
    mix.update(lanes=2, check_every=2)
    (traffic_dir / "pair.json").write_text(json.dumps(mix))
    for name in ("setup_s", "tick_p95_ms"):
        with open(os.path.join(run.HERE, "metrics", name + ".py")) as f:
            (metrics_dir / f"{name}.py").write_text(f.read())
    (metrics_dir / "ticks_seen.py").write_text(
        "def read(rec):\n    return float(rec['requests'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "nmpc-short", "source": "x",
                             "file": str(tmp_path / "nmpc-short.json"),
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "track-pair", "config": "nmpc-short",
                               "traffic": "pair", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("track-pair")
    bench["per_layer"].append({"name": "ticks_seen", "unit": "ticks",
                               "better": "higher", "source": "host_clock",
                               "layer": "host dispatch",
                               "moves": "tick_p95_ms",
                               "workloads": ["track-pair"]})
    res = run.run_cell("track-pair", 7, 0.3, 1, device="cpu", bench=bench,
                       traffic_dir=str(traffic_dir),
                       metrics_dir=str(metrics_dir))
    assert res["correct"], res["checks"]
    assert res["metrics"]["ticks_seen"]["value"] > 0
    assert res["checked"]["checked_lane_ticks"] > 0


def test_the_harness_loads_no_jax():
    """Import every module of the harness in a fresh interpreter: no
    module whose top-level name is jax, jaxlib, flax or the JAX package
    (compared whole: the port's name begins with the JAX package's)."""
    code = (
        "import importlib, pkgutil, sys, portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.test_' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "from portbench import run\n"
        "import glob, os\n"
        "for f in glob.glob(os.path.join(run.HERE, 'metrics', '*.py')):\n"
        "    run.load_reader(os.path.basename(f)[:-3],\n"
        "                    os.path.join(run.HERE, 'metrics'))\n"
        "import portbench.drivers.tracking as t, portbench.drivers.replan\n"
        "import alore_legged_manipulator_tpu_torch.parallel.mesh\n"
        "import alore_legged_manipulator_tpu_torch.planner.backend\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "alore_legged_manipulator_tpu_torch_x",
                        object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax.numpy"]

