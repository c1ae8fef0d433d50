"""The port's tracer (`utils/profiling.py`: `span`, `count`, `snapshot`).

On the CPU: the span tree (ids, parents, roots), self time under a fake
clock, counters charged to the innermost span, the bounded buffer; off
by default (nothing kept, `record_function`, CUDA events and the sync
debug mode never touched); on under a CPU `torch.profiler`, each span
starting within 1 ms of the profiler's event of the same name (one
clock); `enable` / `disable` / `reset`; one tick of
`parallel/mesh.py::batched_tracking_step` under the profiler gives one
`tick` with the six children of its layers.

On the card (marked `cuda`, skipped without one): a blocking host-to-card
copy and an `.item()` each count one host sync, an elementwise kernel
none; a B=1 tick counts the syncs PERF.md records; the spans add no
device operation to the profiler's count of a traced tick.  Run there
with `python -m pytest --noconftest -m cuda tests/test_torch_tracing.py`
(the conftest imports JAX; this file does not).
"""
import warnings

import pytest
import torch

from alore_legged_manipulator_tpu_torch.control.nmpc import NmpcConfig
from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
from alore_legged_manipulator_tpu_torch.parallel.scaling import (
    _tiny_traj, make_fleet)
from alore_legged_manipulator_tpu_torch.utils import profiling as tp

P = torch.profiler
LAYERS = ("ref", "nmpc.linearize", "nmpc.feedback", "ekf.predict", "plant",
          "ekf.update")
# synchronising CUDA calls in one B=1 tick by span, as PERF.md records
# them: ref_points' t_now, ekf_predict's Q and ekf_update's R, each a
# blocking copy from a Python value (the feedback kernel takes its
# weights as launch arguments and makes none)
HOST_SYNCS = {"ref": 1, "ekf.predict": 1, "ekf.update": 1}


def _fake_clock(times_ms):
    it = iter(times_ms)
    return lambda: int(next(it) * 1e6)


def _tick(device, lanes=2, horizon=8):
    """(step, state, noise) of a small closed-loop tick on `device`."""
    cfg = NmpcConfig(horizon=horizon)
    tt, icr = _tiny_traj()
    tt = pm.tree_map(lambda x: x.to(device), tt)
    step = pm.batched_tracking_step(tt, icr, nmpc_cfg=cfg)
    state = make_fleet(lanes, cfg, device=device)[:4]
    noise = torch.zeros((lanes, 5, 2), device=device)
    return step, state, noise


@pytest.fixture
def fresh():
    """The program's tracer, emptied and off before and after the test."""
    tp.disable()
    tp.reset()
    yield tp.TRACER
    tp.disable()
    tp.reset()


def test_span_tree_parent_and_root_ids():
    tr = tp.Tracer()
    tr.enable()
    with tr.span("a", lanes=4) as a:
        with tr.span("b") as b:
            with tr.span("c") as c:
                pass
        with tr.span("d") as d:
            pass
    with tr.span("e") as e:
        pass
    recs = {r["name"]: r for r in tr.snapshot()["records"]}
    assert [r["name"] for r in tr.snapshot()["records"]] == \
        ["c", "b", "d", "a", "e"]                    # kept as they close
    assert recs["a"]["parent"] is None and recs["a"]["root"] == a.id
    assert recs["b"]["parent"] == a.id and recs["c"]["parent"] == b.id
    assert recs["d"]["parent"] == a.id
    assert {recs[n]["root"] for n in "abcd"} == {a.id}
    assert recs["e"]["root"] == e.id and recs["e"]["parent"] is None
    assert len({x.id for x in (a, b, c, d, e)}) == 5
    reqs = tr.snapshot()["requests"]
    assert [(q["name"], q["lanes"]) for q in reqs] == [("a", 4), ("e", None)]
    assert set(reqs[0]["spans"]) == set("abcd")


def test_self_time_of_nested_spans_under_a_fake_clock():
    # a [0, 100] holds b [10, 40] (c [15, 35] inside) and b again [50, 70]
    tr = tp.Tracer(clock=_fake_clock([0, 10, 15, 35, 40, 50, 70, 100]))
    tr.enable()
    with tr.span("a"):
        with tr.span("b"):
            with tr.span("c"):
                pass
        with tr.span("b"):
            pass
    spans = tr.snapshot()["requests"][0]["spans"]
    assert spans["a"]["host_ms"] == pytest.approx(100)
    assert spans["a"]["self_ms"] == pytest.approx(100 - 30 - 20)
    assert spans["b"]["n"] == 2
    assert spans["b"]["host_ms"] == pytest.approx(30 + 20)
    assert spans["b"]["self_ms"] == pytest.approx(10 + 20)
    assert spans["c"]["self_ms"] == pytest.approx(20)
    assert spans["a"]["stream_ms"] is None        # no CUDA event on the CPU


def test_counters_are_charged_to_the_innermost_span():
    tr = tp.Tracer()
    tr.count("lost")                              # off: nothing
    tr.enable()
    tr.count("lost")                              # no open span: nothing
    with tr.span("a"):
        tr.count("trips", 2)
        with tr.span("b"):
            tr.count("trips")
            tr.count("reads", 3)
        tr.count("trips")
    recs = {r["name"]: r for r in tr.snapshot()["records"]}
    assert recs["a"]["counts"] == {"trips": 3}
    assert recs["b"]["counts"] == {"trips": 1, "reads": 3}
    q = tr.snapshot()["requests"][0]
    assert q["counts"] == {"trips": 4, "reads": 3}
    assert q["spans"]["b"]["counts"] == {"trips": 1, "reads": 3}


def test_buffer_is_bounded():
    tr = tp.Tracer()
    tr.capacity = 3
    tr.enable()
    for _ in range(5):
        with tr.span("a"):
            pass
    snap = tr.snapshot()
    assert len(snap["records"]) == 3 and snap["dropped"] == 2


def test_off_by_default_touches_nothing(fresh, monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("touched while the tracer is off")
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", forbidden)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", forbidden)
    assert tp.span("tick", lanes=2) is tp.span("ref")     # one shared no-op
    with tp.span("tick"):
        tp.count("host_syncs")
    step, state, noise = _tick("cpu")
    step(*state, noise, 0.0)
    snap = tp.snapshot()
    assert snap["records"] == [] and snap["requests"] == []


def test_enable_disable_reset(fresh):
    with tp.span("a"):
        pass
    tp.enable()
    with tp.span("b"):
        pass
    tp.disable()
    with tp.span("c"):
        pass
    assert [r["name"] for r in tp.snapshot()["records"]] == ["b"]
    tp.reset()
    assert tp.snapshot() == {"records": [], "requests": [], "dropped": 0}
    tp.enable()
    with tp.span("d"):
        pass
    assert [r["name"] for r in tp.snapshot()["records"]] == ["d"]


def _profiled_tick(step, state, noise, activities):
    with P.profile(activities=activities) as prof:
        step(*state, noise, 0.0)
        if noise.is_cuda:
            torch.cuda.synchronize()
    return prof


def test_on_under_the_profiler_on_its_clock(fresh):
    step, state, noise = _tick("cpu")
    cpu = [P.ProfilerActivity.CPU]
    _profiled_tick(step, state, noise, cpu)               # warm up
    tp.reset()
    prof = _profiled_tick(step, state, noise, cpu)
    recs = tp.snapshot()["records"]
    assert sorted(r["name"] for r in recs) == sorted(("tick",) + LAYERS)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    for r in recs:
        (e,) = events[r["name"]]                 # record_function, once
        assert abs(e.start_ns() - r["start_ns"]) < 1_000_000, r["name"]
        assert r["start_ns"] <= e.start_ns() + 1_000_000
        assert e.start_ns() + e.duration_ns() <= r["end_ns"] + 1_000_000
    assert not tp.TRACER._enabled
    step(*state, noise, 0.0)                     # profiler gone: off again
    assert len(tp.snapshot()["records"]) == len(recs)


def test_one_tick_has_one_tick_span_and_six_children(fresh):
    step, state, noise = _tick("cpu", lanes=3)
    _profiled_tick(step, state, noise, [P.ProfilerActivity.CPU])
    snap = tp.snapshot()
    (q,) = snap["requests"]
    assert q["name"] == "tick" and q["lanes"] == 3
    assert set(q["spans"]) == {"tick", *LAYERS}
    assert all(s["n"] == 1 for s in q["spans"].values())
    (root,) = [r for r in snap["records"] if r["name"] == "tick"]
    for r in snap["records"]:
        if r is not root:
            assert r["parent"] == root["id"] and r["root"] == root["id"]
    # the layers' self times and the tick's own add up to the tick
    total = sum(s["self_ms"] for s in q["spans"].values())
    assert total == pytest.approx(q["spans"]["tick"]["host_ms"], rel=1e-9)
    assert "host_syncs" not in q["counts"]       # no CUDA: nothing counted


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.init()
    return torch.device("cuda")


def _device_ops(prof):
    """Kernels, copies and sets on the card's timeline, annotations left
    out (as `portbench/trace.py` counts them)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.device_type() == cuda and not getattr(
        e, "is_user_annotation", lambda: False)()
        for e in prof.profiler.kineto_results.events())


@pytest.mark.cuda
def test_syncs_are_counted_inside_a_span(cuda_device):
    tr = tp.Tracer()
    tr.enable()
    x = torch.ones(1024, device=cuda_device)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with tr.span("root"):
            with tr.span("copy"):
                torch.tensor([1.0, 2.0], device=cuda_device)
            with tr.span("item"):
                float((x * 2).sum().item())
            with tr.span("kernel"):
                y = x * 3 + 1
            warnings.warn("passed on")
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == mode
    assert [str(w.message) for w in seen] == ["passed on"]
    recs = {r["name"]: r for r in tr.snapshot()["records"]}
    assert recs["copy"]["counts"] == {"host_syncs": 1}
    assert recs["item"]["counts"] == {"host_syncs": 1}
    assert recs["kernel"]["counts"] == {}
    assert recs["root"]["counts"] == {"host_syncs": 0}
    assert tr.snapshot()["requests"][0]["counts"] == {"host_syncs": 2}
    assert all(r["stream_ms"] >= 0 for r in recs.values())
    assert float(y[0]) == 4.0


@pytest.mark.cuda
def test_b1_tick_counts_the_recorded_syncs(cuda_device, fresh):
    step, state, noise = _tick(cuda_device, lanes=1, horizon=50)
    step(*state, noise, 0.0)
    torch.cuda.synchronize()
    tp.enable()
    step(*state, noise, 0.01)
    tp.disable()
    (q,) = tp.snapshot()["requests"]
    spans = q["spans"]
    assert {n: s["counts"]["host_syncs"] for n, s in spans.items()
            if s["counts"].get("host_syncs")} == HOST_SYNCS
    assert q["counts"]["host_syncs"] == sum(HOST_SYNCS.values())
    assert all(s["stream_ms"] > 0 for s in spans.values())
    assert sum(s["self_ms"] for s in spans.values()) == pytest.approx(
        spans["tick"]["host_ms"], rel=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("host", [False, True])
def test_spans_add_no_device_operation(cuda_device, fresh, monkeypatch,
                                       host):
    acts = [P.ProfilerActivity.CUDA] + ([P.ProfilerActivity.CPU]
                                        if host else [])
    step, state, noise = _tick(cuda_device, lanes=1, horizon=50)
    _profiled_tick(step, state, noise, acts)              # warm up
    with_spans = _device_ops(_profiled_tick(step, state, noise, acts))
    assert len(tp.snapshot()["requests"]) == 2
    monkeypatch.setattr(tp, "_profiler_enabled", lambda: False)
    tp.reset()
    stubbed = _device_ops(_profiled_tick(step, state, noise, acts))
    assert tp.snapshot()["records"] == []
    assert with_spans == stubbed > 0
