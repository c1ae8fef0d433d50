"""Port parity: stage timing and the device trace (`utils/profiling.py`).

`StageTimer` against the JAX package's under the same (fake) clock:
equal EWMAs, last times, counts and report; a stage that raises is still
timed.  `device_trace` on the CPU writes a Chrome trace of the block's
operations, and `trace_summary` reads it: no kernel without a card, the
window spanning the events, a busy share of 0; on a synthetic trace,
overlapping kernel and copy intervals counted once.
"""
import json
import time

import pytest
import torch

from alore_legged_manipulator_tpu.utils import profiling as jp
from alore_legged_manipulator_tpu_torch.utils import profiling as tp


def _run(mod, monkeypatch):
    clock = iter([0.0, 0.010, 1.0, 1.030, 2.0, 2.020, 3.0, 3.5, 4.0, 4.25])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    st = mod.StageTimer()
    for name in ("plan", "plan", "track", "plan"):
        with st.stage(name):
            pass
    with pytest.raises(ValueError):
        with st.stage("track"):
            raise ValueError("inside a stage")
    return st


def test_stage_timer_matches_jax(monkeypatch):
    a, b = _run(tp, monkeypatch), _run(jp, monkeypatch)
    assert a.ewma == pytest.approx(b.ewma, rel=1e-15)
    assert a.last == b.last and a.count == b.count
    assert a.report() == b.report()
    assert a.count == {"plan": 3, "track": 2}


def test_device_trace_on_cpu(tmp_path):
    x = torch.randn(64, 64)
    with tp.device_trace(str(tmp_path / "trace")) as prof:
        y = torch.relu(x @ x).sum()
    assert float(y) >= 0
    assert any("matmul" in e.key or "mm" in e.key
               for e in prof.key_averages())
    path = tmp_path / "trace" / "trace.json"
    s = tp.trace_summary(str(path))
    if not torch.cuda.is_available():
        assert s["kernels"] == 0 and s["device_busy_us"] == 0.0
        assert s["busy_share"] == 0.0
    assert s["window_us"] > 0


def test_trace_summary_unions_device_intervals(tmp_path):
    ev = [{"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 60, "dur": 10},
          {"ph": "X", "cat": "kernel", "ts": 90, "dur": 30},
          {"ph": "i", "cat": "kernel", "ts": 5}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = tp.trace_summary(str(path))
    assert s["kernels"] == 3
    assert s["device_busy_us"] == 30 + 10 + 30
    assert s["window_us"] == 120
    assert s["busy_share"] == pytest.approx(70 / 120)
