"""Port parity: the mission-validation twin
(`alore_legged_manipulator_tpu_torch/examples/mission_validation.py`)
against the JAX package's example (`examples/mission_validation.py`).

Both run the same `jps.cpp` and the same text of `mission/ordering.py`
on the same draws, so at `--n-tasks 4 --trials 5` (and a second seed)
the greedy and branch-and-bound orders and costs must be equal to the
last bit, and the printed lines equal but for their wall times.
"""
import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch

import alore_legged_manipulator_tpu.mission as jmission
from alore_legged_manipulator_tpu_torch.examples import mission_validation

REPO = Path(__file__).resolve().parent.parent


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_mission_validation", REPO / "examples" / "mission_validation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _without_times(text):
    return re.sub(r"\d+(\.\d+)? ms", "_ ms", text).splitlines()


def _recorded(fn, out):
    def wrapped(*args, **kwargs):
        res = fn(*args, **kwargs)
        out.append(res)
        return res
    return wrapped


@pytest.mark.parametrize("seed", [0, 3])
def test_orders_and_costs_equal_jax(seed, monkeypatch, capsys):
    flags = ["--n-tasks", "4", "--trials", "5", "--seed", str(seed)]
    greedy, bnb = [], []
    monkeypatch.setattr(jmission, "greedy_order",
                        _recorded(jmission.greedy_order, greedy))
    monkeypatch.setattr(jmission, "branch_and_bound_order",
                        _recorded(jmission.branch_and_bound_order, bnb))
    monkeypatch.setattr(sys, "argv", ["mission_validation.py"] + flags)
    _jax_example().main()
    jax_lines = _without_times(capsys.readouterr().out)
    got = mission_validation.main(flags + ["--device", "cpu"])
    port_lines = _without_times(capsys.readouterr().out)
    assert len(got["trials"]) == len(greedy) == len(bnb) == 5
    for t, (g_order, g_cost), (b_order, b_cost) in zip(got["trials"], greedy,
                                                       bnb):
        assert t["greedy_order"] == list(g_order)
        assert t["bnb_order"] == list(b_order)
        assert t["greedy_cost"] == g_cost and t["bnb_cost"] == b_cost
        assert t["valid"]
    assert port_lines == jax_lines and len(port_lines) == 5


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        mission_validation.main(["--trials", "1"])
