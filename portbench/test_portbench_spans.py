"""The readers of the port's spans and counters (`portbench/spans.py`
and the `program_span` / `program_counter` metrics), on the CPU: each
reads nothing without spans, or from a program without the tracer, and
the median over the traced ticks from a synthetic snapshot; one traced
tick of the port gives the host readers their numbers."""
import pytest
import torch

from portbench import run, spans
from portbench.trace import TraceSummary

from alore_legged_manipulator_tpu_torch.utils import profiling

BENCH = run.load_bench()
NAMES = [m["name"] for m in BENCH["per_layer"]
         if m["source"] in ("program_span", "program_counter")]
REC = {"trace": TraceSummary(window_s=1.0, busy_s=0.1, device_ops=1000,
                             device_top=[], idle_gaps=[]),
       "traced_requests": 2}


def read(name, rec=REC):
    return run.load_reader(name, run.HERE + "/metrics")(rec)


def _tick(ms, syncs=None, name="tick"):
    """A request as `snapshot()` gives it: each span's host, self and
    stream ms from `ms` (name -> (host, self, stream))."""
    return {"name": name, "lanes": 1,
            "counts": {} if syncs is None else {"host_syncs": syncs},
            "spans": {k: {"n": 1, "host_ms": h, "self_ms": s,
                          "stream_ms": st, "counts": {}}
                      for k, (h, s, st) in ms.items()}}


def _ticks():
    """Three ticks, each layer's times scaled by 1, 3 and 2, and a request
    that is not a tick."""
    out = []
    for f, syncs in ((1.0, 5), (3.0, 7), (2.0, 5)):
        out.append(_tick({"tick": (100 * f, 10 * f, 90 * f),
                          "ref": (5 * f, 5 * f, 1 * f),
                          "nmpc.linearize": (4 * f, 4 * f, 2 * f),
                          "nmpc.feedback": (60 * f, 60 * f, 70 * f),
                          "ekf.predict": (3 * f, 3 * f, 4 * f),
                          "plant": (15 * f, 15 * f, 8 * f),
                          "ekf.update": (3 * f, 3 * f, 5 * f)}, syncs))
    out.append(_tick({"nmpc.linearize": (99, 99, 99)},
                     name="nmpc.linearize"))       # not a tick: left out
    return out


def test_every_new_metric_has_a_reader():
    assert len(NAMES) == 14
    for name in NAMES:
        assert callable(run.load_reader(name, run.HERE + "/metrics"))


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_without_spans(name, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert read(name) is None
    monkeypatch.setattr(spans, "snapshot",
                        lambda: {"records": [], "requests": [], "dropped": 0})
    assert read(name) is None


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_from_a_program_without_the_tracer(
        name, monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    assert read(name) is None


EXPECTED = {   # medians over factors 1, 3, 2: the factor-2 tick's values
    "ref_host_ms.b1": 10.0, "linearize_host_ms.b1": 8.0,
    "feedback_host_ms.b1": 120.0, "ekf_host_ms.b1": 12.0,
    "plant_host_ms.b1": 30.0, "host_syncs_per_tick.b1": 5.0,
    "host_us_per_launch.b1": 1e3 * 200.0 / (1000 / 2),
    "ref_stream_ms.fleet": 2.0, "linearize_stream_ms.fleet": 4.0,
    "feedback_stream_ms.fleet": 140.0, "ekf_stream_ms.fleet": 18.0,
    "plant_stream_ms.fleet": 16.0, "host_syncs_per_tick.fleet": 5.0,
    "tick_host_ms.fleet": 200.0}


@pytest.mark.parametrize("name", NAMES)
def test_readers_take_the_median_tick(name, monkeypatch):
    monkeypatch.setattr(spans, "snapshot",
                        lambda: {"records": [], "requests": _ticks(),
                                 "dropped": 0})
    assert read(name) == pytest.approx(EXPECTED[name])


def test_host_witness_needs_the_trace(monkeypatch):
    monkeypatch.setattr(spans, "snapshot",
                        lambda: {"requests": _ticks()})
    assert read("host_us_per_launch.b1",
                {"trace": None, "traced_requests": 2}) is None


def test_a_traced_tick_of_the_port_feeds_the_host_readers():
    from alore_legged_manipulator_tpu_torch.control.nmpc import NmpcConfig
    from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
    from alore_legged_manipulator_tpu_torch.parallel.scaling import (
        _tiny_traj, make_fleet)
    cfg = NmpcConfig(horizon=8)
    tt, icr = _tiny_traj()
    step = pm.batched_tracking_step(tt, icr, nmpc_cfg=cfg)
    state = make_fleet(1, cfg, device="cpu")[:4]
    profiling.reset()
    P = torch.profiler
    try:
        for _ in range(3):
            with P.profile(activities=[P.ProfilerActivity.CPU]):
                state = step(*state, torch.zeros((1, 5, 2)), 0.0)[:4]
        assert len(spans.ticks()) == 3
        for name in NAMES:
            v = read(name)
            if "_host_ms" in name or "host_us" in name:
                assert v > 0, name
            else:     # stream times and syncs need the card
                assert v is None, name
        parts = sum(read(f"{k}_host_ms.b1") for k in
                    ("ref", "linearize", "feedback", "ekf", "plant"))
        assert parts < read("tick_host_ms.fleet")
    finally:
        profiling.reset()


# every number of the tracking cells on one fixed record, as their
# readers give it: a change to what a tracking cell reads shows here
FIXED = {"lanes": 16, "requests": 300, "elapsed_s": 51.25, "setup_s": 9.5,
         "latencies_s": [0.02 + 1e-4 * (i % 37) for i in range(300)],
         "trace": TraceSummary(window_s=2.0, busy_s=0.5, device_ops=26000,
                               device_top=[], idle_gaps=[]),
         "traced_requests": 20}
FIXED_VALUES = {
    "tick_p95_ms": 23.5, "setup_s": 9.5, "device_idle_pct.tick": 75.0,
    "launches_per_tick.b1": 1300.0, "ref_host_ms.b1": 10.0,
    "linearize_host_ms.b1": 8.0, "feedback_host_ms.b1": 120.0,
    "ekf_host_ms.b1": 12.0, "plant_host_ms.b1": 30.0,
    "host_syncs_per_tick.b1": 5.0,
    "host_us_per_launch.b1": 153.84615384615384,
    "scenario_ticks_per_s": 93.65853658536585,
    "device_idle_pct.fleet": 75.0, "launches_per_tick.fleet": 1300.0,
    "device_ms_per_tick.fleet": 25.0, "ref_stream_ms.fleet": 2.0,
    "linearize_stream_ms.fleet": 4.0, "feedback_stream_ms.fleet": 140.0,
    "ekf_stream_ms.fleet": 18.0, "plant_stream_ms.fleet": 16.0,
    "host_syncs_per_tick.fleet": 5.0, "tick_host_ms.fleet": 200.0}


def _tracking_metrics():
    """Every metric that a tracking cell reports, each once."""
    out = []
    for w in ("track-b1", "track-fleet16k"):
        _, _, _, e2e, layer = run.cell_spec(BENCH, w)
        out += [m["name"] for m in e2e + layer if m["name"] not in out]
    return out


@pytest.mark.parametrize("name", _tracking_metrics())
def test_tracking_readers_read_a_fixed_record_as_before(name, monkeypatch):
    monkeypatch.setattr(spans, "snapshot",
                        lambda: {"records": [], "requests": _ticks(),
                                 "dropped": 0})
    assert read(name, FIXED) == pytest.approx(FIXED_VALUES[name], rel=1e-12)
