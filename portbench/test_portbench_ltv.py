"""The LTV cells (`ltv-b1`, `ltv-fleet4096`) through the harness on the
CPU at their own traffic (the fleet cut to 8 lanes), the faults and the
control that `correct` must catch, and their readers on a fixed
record.  Run from the
repository's root: `python -m pytest portbench/`.
"""
import pytest
import torch

from portbench import control, ltv_work, run, spans
from portbench.drivers import ltv_tracking
from portbench.trace import TraceSummary

from alore_legged_manipulator_tpu_torch.parallel import mesh

LTV = ["ltv-b1", "ltv-fleet4096"]
# each cell's own traffic (start offsets, measurement noise, warm-up),
# the fleet cut to 8 lanes, every tick of the window checked
OWN = {"ltv-b1": {"check_every": 1},
       "ltv-fleet4096": {"lanes": 8, "check_every": 1}}
SECONDS = {"ltv-b1": 6.0, "ltv-fleet4096": 3.0}
# ticks checked at the least: the fleet's from tick 2 on, the robot's
# from tick 10 on, past tick 20, where a cut ADMM has moved its plan
MIN_TICKS = {"ltv-b1": 12, "ltv-fleet4096": 4}
SEED = 2 ** 31 + 12345       # a run's seed may pass 32 signed bits


def _run(workload):
    res = run.run_cell(workload, SEED, SECONDS[workload], 0, device="cpu",
                       overrides=OWN[workload])
    assert res["checked"]["checked_ticks"] >= MIN_TICKS[workload]
    return res


@pytest.mark.parametrize("workload", LTV)
def test_cell_is_correct_and_reports_its_metrics(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    bench = run.load_bench(workload)
    _, _, traffic, e2e, layer = run.cell_spec(bench, workload)
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    assert {m["name"] for m in e2e} - {"setup_s"} == {
        "ltv-b1": {"tick_p95_ms"},
        "ltv-fleet4096": {"scenario_ticks_per_s"}}[workload]
    assert sorted(m["name"] for m in e2e + layer) == sorted(
        FIXED_VALUES[workload])
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == set(traffic["limits"])
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("workload", LTV)
def test_control_is_not_correct(workload):
    """The reference in bfloat16, put in the program's place, fails at
    least one limit; the program's own readings pass them all."""
    prog, ctl, checked = control.readings(
        workload, SEED, SECONDS[workload], "cpu", OWN[workload])
    assert checked["checked_ticks"] >= MIN_TICKS[workload]
    limits = run.cell_spec(run.load_bench(workload), workload)[2]["limits"]
    assert run.compare(prog, limits)[1]
    assert not run.compare(ctl, limits)[1]


def _broken_tick(monkeypatch, fault):
    """The tick with one fault: `swap`, lanes 0 and 1's commands
    swapped; `carry`, the node's plan and delay buffer left as they came
    in; `last_cmd`, the command of the tick before sent again; `admm75`,
    the ADMM cut to 75 steps a pass."""
    real_node = mesh.ltv_mpc_tick

    def node(carry, x_est, xref, dref, cfg):
        if fault == "admm75":
            cfg = cfg._replace(admm_iters=75)
        new, cmd = real_node(carry, x_est, xref, dref, cfg)
        if fault == "carry":
            return carry, cmd
        if fault == "last_cmd":
            return new, carry.delay_buff[:, -1]
        return new, cmd
    monkeypatch.setattr(mesh, "ltv_mpc_tick", node)
    if fault == "swap":
        real = ltv_tracking.batched_ltv_tracking_step

        def make(*a):
            step = real(*a)

            def fn(*state):
                out = step(*state)
                u = out[3][[1, 0, *range(2, out[3].shape[0])]]
                return (*out[:3], u, out[4])
            return fn
        monkeypatch.setattr(ltv_tracking, "batched_ltv_tracking_step", make)


# the check each fault has to fail
FAULTS = {"swap": "u_cmd_gap", "carry": "plan_gap", "last_cmd": "u_cmd_gap",
          "admm75": "plan_gap"}


@pytest.mark.parametrize("workload,fault", [
    ("ltv-b1", "carry"), ("ltv-b1", "last_cmd"), ("ltv-b1", "admm75"),
    ("ltv-fleet4096", "swap"), ("ltv-fleet4096", "carry"),
    ("ltv-fleet4096", "last_cmd"), ("ltv-fleet4096", "admm75")])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    """At the cell's own traffic, each fault fails its check."""
    _broken_tick(monkeypatch, fault)
    res = _run(workload)
    assert not res["correct"]
    c = res["checks"][FAULTS[fault]]
    assert c["value"] > c["limit"], res["checks"]


# span name: (spans a tick, host ms, self ms, stream ms) of the factor-1
# tick
SPANS = {"tick": (1, 900, 20, 950), "ref": (1, 5, 5, 1),
         "ltv.linearize": (3, 30, 30, 12), "admm.factor": (3, 15, 15, 40),
         "admm.iterate": (3, 700, 700, 800), "ekf.predict": (1, 3, 3, 4),
         "plant": (1, 15, 15, 8), "ekf.update": (1, 3, 3, 5)}


def _ticks():
    """Three traced ticks, each layer's times scaled by 1, 3 and 2."""
    return [{"name": "tick", "lanes": 4096,
             "counts": {"admm.iters": 450, "host_syncs": 3},
             "spans": {k: {"n": n, "host_ms": h * f, "self_ms": s * f,
                           "stream_ms": st * f, "counts": {}}
                       for k, (n, h, s, st) in SPANS.items()}}
            for f in (1.0, 3.0, 2.0)]


FIXED = {"lanes": 4096, "requests": 40, "elapsed_s": 51.0, "setup_s": 12.0,
         "latencies_s": [0.15] * 40, "traced_requests": 2,
         "trace": TraceSummary(window_s=2.0, busy_s=1.5, device_ops=35000,
                               device_top=[], idle_gaps=[]),
         "config": run.load_json(run.ROOT, "portbench", "configs",
                                 "ltv-mpc-3ms.json")}
# 4096 lanes x 450 steps x 4 (596 + 484) operations at 67 TFLOP/s
BOUND_MS = 1e3 * 4096 * 450 * 4 * (596 + 484) / 67e12
# every number of the LTV cells on the fixed record; the span readers
# take the median over the factors 1, 3, 2: the factor-2 tick's values
FIXED_VALUES = {
    "ltv-b1": {
        "tick_p95_ms": 150.0, "setup_s": 12.0, "device_idle_pct.tick": 25.0,
        "launches_per_tick.b1": 17500.0, "ref_host_ms.b1": 10.0,
        "ekf_host_ms.b1": 12.0, "plant_host_ms.b1": 30.0,
        "host_syncs_per_tick.b1": 3.0,
        "host_us_per_launch.b1": 1e3 * 1800.0 * 2 / 35000,
        "ltv_linearize_host_ms.ltvb1": 60.0,
        "admm_factor_host_ms.ltvb1": 30.0,
        "admm_iterate_host_ms.ltvb1": 1400.0},
    "ltv-fleet4096": {
        "scenario_ticks_per_s": 4096 * 40 / 51.0, "setup_s": 12.0,
        "device_idle_pct.fleet": 25.0, "launches_per_tick.fleet": 17500.0,
        "device_ms_per_tick.fleet": 750.0, "ref_stream_ms.fleet": 2.0,
        "ekf_stream_ms.fleet": 18.0, "plant_stream_ms.fleet": 16.0,
        "host_syncs_per_tick.fleet": 3.0, "tick_host_ms.fleet": 1800.0,
        "ltv_linearize_stream_ms.ltvfleet": 24.0,
        "admm_factor_stream_ms.ltvfleet": 80.0,
        "admm_iterate_stream_ms.ltvfleet": 1600.0,
        "admm_roofline_pct.ltvfleet": 100.0 * BOUND_MS / 1600.0}}
CELL_METRICS = [(w, name) for w in LTV for name in FIXED_VALUES[w]]


def _reported(workload):
    _, _, _, e2e, layer = run.cell_spec(run.load_bench(), workload)
    return sorted(m["name"] for m in e2e + layer)


@pytest.mark.parametrize("workload", LTV)
def test_each_cell_reports_the_metrics_of_the_fixed_record(workload):
    assert _reported(workload) == sorted(FIXED_VALUES[workload])


@pytest.mark.parametrize("workload,name", CELL_METRICS)
def test_readers_read_a_fixed_record(workload, name, monkeypatch):
    monkeypatch.setattr(spans, "snapshot",
                        lambda: {"records": [], "requests": _ticks(),
                                 "dropped": 0})
    got = run.load_reader(name, run.HERE + "/metrics")(FIXED)
    assert got == pytest.approx(FIXED_VALUES[workload][name], rel=1e-12)


@pytest.mark.parametrize("workload,name", [
    (w, n) for w, n in CELL_METRICS if n not in ("tick_p95_ms", "setup_s",
                                                  "scenario_ticks_per_s")])
def test_per_layer_readers_read_nothing_without_the_trace(
        workload, name, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert run.load_reader(name, run.HERE + "/metrics")(
        {**FIXED, "trace": None}) is None


def test_the_admm_work_is_the_configurations():
    """n = 145 variables, m = 201 rows; K's lower triangle has 596
    nonzeros and A 484, so a step of a lane needs 4 x 1,080 operations
    and a pass reads 1,080 float32 numbers; 4096 lanes x 450 steps are
    bound by the operations, 0.119 ms; a lane's one step by the bytes."""
    config = FIXED["config"]
    assert ltv_work.qp_shape(config) == (145, 201)
    assert ltv_work.nonzeros(config) == (596, 484)
    assert ltv_work.step_flops(config) == 4320
    assert ltv_work.pass_bytes(config) == 4 * 1080
    assert ltv_work.admm_bound_ms(config, 4096, 450) == pytest.approx(
        BOUND_MS)
    assert ltv_work.admm_bound_ms(config, 1, 1) == pytest.approx(
        1e3 * 3 * 4320 / 3.35e12)
    # a dense step (2 n^2 + 4 m n) is 37 times the least
    assert (2 * 145 ** 2 + 4 * 201 * 145) / ltv_work.step_flops(config) > 36


def test_a_program_without_the_ltv_tick_fails_at_import(monkeypatch):
    """A parent program (no `batched_ltv_tracking_step`) fails as the
    driver is imported, before any work."""
    import importlib
    import sys

    monkeypatch.delattr(mesh, "batched_ltv_tracking_step")
    monkeypatch.delitem(sys.modules, "portbench.drivers.ltv_tracking")
    with pytest.raises(ImportError):
        importlib.import_module("portbench.drivers.ltv_tracking")


@pytest.mark.cuda
def test_cells_on_the_card():
    """One short traced run of each LTV cell on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in LTV:
        res = run.run_cell(workload, SEED, 2.0, 1,
                           overrides={"check_every": 2})
        assert res["correct"], res["checks"]
        layer = run.cell_spec(run.load_bench(workload), workload)[4]
        assert set(res["metrics"]) == {m["name"] for m in layer}
