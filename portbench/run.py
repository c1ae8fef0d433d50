"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and its
traffic are found by name: `BENCHMARK.json` names the cell's
configuration file and traffic; `portbench/traffic/<traffic>.json`
names the driver (`portbench/drivers/<driver>.py`) and its parameters;
each metric is read by `portbench/metrics/<metric>.py`.  Set-up (imports,
the card, building and warming up the cell) runs before the window; the
window measures for `--seconds`; with `--trace 1` a bounded stretch after
it runs under the profiler.  Then the program's state is freed and what
the window produced is checked against the plain reference: each number
is printed beside its limit, on standard error and as the result line's
last key.  The run fails without a card, and if the JAX package or JAX
was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "alore_legged_manipulator_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(ROOT, "build", "portbench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_reader(name: str, metrics_dir: str):
    """`read(record)` of `<metrics_dir>/<name>.py`, or, where there is no
    such file, of the file named by the part before the first dot
    (`device_idle_pct.tick` -> `device_idle_pct.py`)."""
    path = os.path.join(metrics_dir, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(metrics_dir, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_bench(workload: str = None) -> dict:
    """BENCHMARK.json; for a cell that it does not name, with the entries
    of `portbench/pending/<workload>.json` added where that file exists
    (a cell kept ready for a later benchmark, run by the tests and by
    `portbench.control`, never by a run of the command)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    path = os.path.join(HERE, "pending", f"{workload}.json")
    if workload not in {w["name"] for w in bench["workloads"]} \
            and os.path.exists(path):
        for key, entries in load_json(path).items():
            if key != "why":
                bench[key] = bench[key] + entries
    return bench


def cell_spec(bench: dict, workload: str, traffic_dir: str = None):
    """(cell, configuration, traffic, end-to-end metrics, per-layer
    metrics) of the named cell; its traffic from `traffic_dir`
    (portbench/traffic)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT, conf["file"])
    traffic = load_json(traffic_dir or os.path.join(HERE, "traffic"),
                        cell["traffic"] + ".json")

    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    # a per-layer metric without a list of cells is read wherever the
    # metric it moves is reported
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in moved]
    return cell, config, traffic, e2e, layer


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def compare(readings: dict, limits: dict):
    """[[name, value, limit], ...] and whether every value is within its
    limit (a number without a limit fails)."""
    rows = [[k, v, limits.get(k)] for k, v in readings.items()]
    ok = all(lim is not None and not math.isnan(v) and v <= lim
             for _, v, lim in rows)
    return rows, ok


def make_cell(workload, seed, device, bench=None, overrides=None,
              traffic_dir=None):
    """(the driver's Cell for this run, traffic, end-to-end metrics,
    per-layer metrics); `overrides` replace traffic keys."""
    bench = bench or load_bench(workload)
    _, config, traffic, e2e, layer = cell_spec(bench, workload, traffic_dir)
    traffic = {**traffic, **(overrides or {})}
    driver = importlib.import_module("portbench.drivers." + traffic["driver"])
    return driver.Cell(config, traffic, seed, device), traffic, e2e, layer


def run_cell(workload, seed, seconds, trace, device="cuda", bench=None,
             overrides=None, traffic_dir=None, metrics_dir=None):
    """One run of a cell; returns the result dict.  device "cpu" and
    `overrides` (traffic keys) are the tests' hook: a CPU result carries
    no device numbers.  Traffic and metric files are looked up in
    `traffic_dir` and `metrics_dir` (portbench/traffic, portbench/metrics)."""
    import torch

    from . import trace as tracing

    run, traffic, e2e, layer = make_cell(workload, seed, device, bench,
                                         overrides, traffic_dir)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    run.setup()
    setup_s = time.perf_counter() - T_START
    record = {"setup_s": setup_s, **run.window(seconds)}
    summary = None
    if trace and on_card:
        summary, record["traced_requests"] = tracing.profile_stretch(
            run.stretch)
    elif trace:
        record["traced_requests"] = run.stretch()
    record["trace"] = summary
    record.update(run.counters())
    device_out = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": 1}
    if on_card:
        device_out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    run.release()
    if on_card:
        torch.cuda.empty_cache()
    readings, checked = run.readings()
    rows, ok = compare(readings, traffic["limits"])
    ok = ok and all(v > 0 for v in checked.values())   # nothing unchecked
    wanted = layer if trace else e2e
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"], metrics_dir or os.path.join(
            HERE, "metrics"))(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok, "attempted": record["requests"] * record["lanes"],
              "failed": record["failed"], "metrics": metrics,
              "device": device_out, "checked": checked}
    if summary is not None:
        device_out["busy_s"] = summary.busy_s
        device_out["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_top,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch

    bench = load_json(ROOT, "BENCHMARK.json")
    cell = cell_spec(bench, args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from . import frozen
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      bench=bench)
    result["device"]["power_limit_w"] = frozen.device_fields()["power_limit_w"]
    bad = forbidden_modules()
    if bad:
        print("portbench: modules that no run may load: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
