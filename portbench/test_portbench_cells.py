"""Each cell through the harness on the CPU at a tiny size, the reference
against the port, and the faults and the control that `correct` must
catch.  Run from the repository's root: `python -m pytest portbench/`.
"""
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.reference import spline, tick

# the cells at sizes the CPU holds: few lanes, few ticks or plans; the
# tracking cells checked once the robot is under way (from rest, the
# commands are too small for a bfloat16 control to read wrong); the
# replan cells plan one call, a whole pass of a one- or four-cell grid,
# with every plan of it solved again by the plain solver
TINY = {
    "track-b1": {"check_every": 1, "warmup_ticks": 60},
    "track-fleet16k": {"lanes": 4, "noise_ticks": 16, "check_every": 1,
                       "warmup_ticks": 60},
    "replan-b1": {"pool": 2, "strata": [1, 1], "solve_sample": 1},
    "replan-fleet512": {"lanes": 4, "pool": 2, "strata": [2, 2],
                        "solve_sample": 4},
}
REPLAN = ["replan-b1", "replan-fleet512"]
SEED = 2 ** 31 + 12345       # a run's seed may pass 32 signed bits


def _run(workload, trace=0, seed=SEED, **over):
    # a replan window of 0 s ends after its first call
    seconds = 0.0 if workload in REPLAN else 1.5
    return run.run_cell(workload, seed, seconds, trace, device="cpu",
                        overrides={**TINY[workload], **over})


@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_is_correct_and_reports_its_metrics(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    bench = run.load_bench(workload)
    _, _, traffic, e2e, _ = run.cell_spec(bench, workload)
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == set(traffic["limits"])
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0


def _broken_tick(monkeypatch, fault):
    import alore_legged_manipulator_tpu_torch.parallel.mesh as mesh
    real = mesh.batched_tracking_step

    def make(*a, **k):
        step = real(*a, **k)

        def fn(plants, ekfs, carries, u_prevs, noise, t):
            out = step(plants, ekfs, carries, u_prevs, noise, t)
            if fault == "unchanged":
                return plants, ekfs, carries, out[3], noise
            if fault == "command":
                return (*out[:3], out[3] + 0.01, noise)
            half = plants.xytheta.shape[0] // 2     # "half": lanes left out
            p = out[0]._replace(xytheta=torch.cat(
                [out[0].xytheta[:half], plants.xytheta[half:]]))
            return (p, *out[1:])
        return fn
    monkeypatch.setattr(mesh, "batched_tracking_step", make)


@pytest.mark.parametrize("workload,fault", [
    ("track-b1", "unchanged"), ("track-b1", "command"),
    ("track-fleet16k", "unchanged"), ("track-fleet16k", "command"),
    ("track-fleet16k", "half")])
def test_tracking_fault_is_not_correct(monkeypatch, workload, fault):
    _broken_tick(monkeypatch, fault)
    assert not _run(workload)["correct"]


def _broken_plan(monkeypatch, fault):
    import alore_legged_manipulator_tpu_torch.planner.backend as backend
    real, real_vg = backend.plan_backend, backend._value_and_grad

    def consistent(res, flat, cfg, inner, tail_s, times):
        """A plan that states what its decision variables imply."""
        x = backend.pack_vars(inner, tail_s, backend.real_to_virtual_time(
            times))
        coeffs, times = backend._spline(flat, inner, tail_s,
                                        backend.real_to_virtual_time(times))
        return res._replace(
            coeffs=coeffs, times=times, inner=inner,
            tail_state=backend._tail_with(flat.final_state, tail_s),
            final_xy_err=backend.final_xy_error(x, flat, cfg))

    def plan(flat, esdf, cfg):
        if fault == "stopped":                  # the solver stops early
            cfg = cfg._replace(lbfgs=cfg.lbfgs._replace(hard_iter_cap=3))
        res = real(flat, esdf, cfg)
        if fault == "coeffs":
            c = res.coeffs.clone()
            c[:, 0, 3] += 1e-2
            return res._replace(coeffs=c)
        if fault == "final_xy":
            return res._replace(final_xy_err=res.final_xy_err + 1e-3)
        if fault == "flag":
            return res._replace(collision=~res.collision)
        if fault == "short":                    # 0.5 m short, and says so
            return consistent(res, flat, cfg, res.inner,
                              res.tail_state[:, 1, 0] - 0.5, res.times)
        if fault in ("unmoved", "half"):        # the guess returned
            B, n = res.times.shape
            guess = consistent(res, flat, cfg, flat.inner_yaw_s,
                               flat.final_state[:, 1, 0],
                               flat.init_piece_time[:, None].expand(B, n))
            if fault == "unmoved":
                return guess
            half = B // 2                       # lanes left out
            return type(res)(*(torch.cat([r[:half], g[half:]])
                               for r, g in zip(res, guess)))
        return res

    def wrong_gradient(cost_fn, z):             # half the gradient scaled
        f, g, aux = real_vg(cost_fn, z)
        g = g.clone()
        g[:, 0::2] *= 0.3
        return f, g, aux

    monkeypatch.setattr(backend, "plan_backend", plan)
    if fault == "gradient":
        monkeypatch.setattr(backend, "_value_and_grad", wrong_gradient)


# The wrong gradient keeps the problem's stationary points: it moves a
# plan only where it stops the solver short, which it does for goals in
# the band of y beside the block (objective 0.17 above the plain
# solver's at a goal (5.88, 4.44)) and not below it (0.01-0.08 at goals
# (6.62, 4.35), (5.25, 3.50), (6.12, 3.38)).  So its B=1 case runs at a
# seed whose goal lies in that band.
GRADIENT_SEED = SEED + 3


@pytest.mark.parametrize("workload,fault", [
    *((w, f) for w in REPLAN for f in ("coeffs", "final_xy", "flag",
                                       "short", "unmoved", "stopped",
                                       "gradient")),
    ("replan-fleet512", "half")])
def test_replan_fault_is_not_correct(monkeypatch, fault, workload):
    _broken_plan(monkeypatch, fault)
    seed = GRADIENT_SEED if (workload, fault) == ("replan-b1", "gradient") \
        else SEED
    assert not _run(workload, seed=seed)["correct"]


def _counted_window(monkeypatch, workload, plan_s, seconds, failing=()):
    """The window of `drivers/replan.py` over calls that take `plan_s`
    each and plan nothing; the calls numbered in `failing` state a
    collision."""
    from portbench.drivers import replan
    bench = run.load_bench(workload)
    _, config, traffic, _, _ = run.cell_spec(bench, workload)
    cell = replan.Cell(config, traffic, SEED, "cpu")
    cell.calls = [None] * traffic["pool"]
    clock = [0.0]
    monkeypatch.setattr(replan, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))

    def call(req, keep):
        clock[0] += plan_s
        lanes = cell.lanes
        h = {"coeffs": torch.zeros(lanes, 6, 6, 2),
             "final_xy_err": torch.zeros(lanes, 2),
             "collision": torch.full((lanes,), len(cell.done) in failing),
             "stage2_iters": torch.arange(1, lanes + 1),
             "replans": torch.ones(lanes, dtype=torch.long)}
        cell.done.append((req, h))
    cell._call = call
    return cell, cell.window(seconds)


def test_replan_rate_counts_whole_passes_only(monkeypatch):
    """replan-b1 (8 plans a pass): a window that ends 3 plans into its
    third pass counts 16 plans over the time to the 16th; the failure in
    the unfinished pass is not the rate's, the one in a counted pass is."""
    cell, rec = _counted_window(monkeypatch, "replan-b1", 2.5, 51.0,
                                failing=(3, 17))
    assert cell.per_pass == 8 and len(cell.done) == 21
    assert rec["requests"] == 16 and rec["elapsed_s"] == pytest.approx(40.0)
    assert rec["latencies_s"] == [2.5] * 16 and rec["failed"] == 1
    assert run.load_reader("plans_per_s", run.HERE + "/metrics")(rec) \
        == pytest.approx(0.4)
    counters = cell.counters()
    assert counters["stage2_iters"] == 1.0 and counters["replans"] == 1.0


def test_fleet_call_is_a_whole_pass_and_reads_its_imbalance(monkeypatch):
    cell, rec = _counted_window(monkeypatch, "replan-fleet512", 5.0, 51.0)
    assert cell.per_pass == 1 and rec["requests"] == len(cell.done) == 11
    assert rec["elapsed_s"] == pytest.approx(55.0)
    # lanes' stage-2 iterations 1..512: the most over the mean
    assert cell.counters()["lane_imbalance"] == pytest.approx(512 / 256.5)


def test_a_window_with_no_whole_pass_fails(monkeypatch):
    with pytest.raises(RuntimeError, match="no whole pass"):
        _counted_window(monkeypatch, "replan-b1", 10.0, 51.0)


def test_a_pool_of_part_passes_is_refused():
    from portbench.drivers import replan
    bench = run.load_bench("replan-b1")
    _, config, traffic, _, _ = run.cell_spec(bench, "replan-b1")
    with pytest.raises(ValueError, match="whole number of passes"):
        replan.Cell(config, {**traffic, "pool": 12}, SEED, "cpu")


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_not_correct(workload):
    """The reference in bfloat16, put in the program's place, fails at
    least one limit; the program's own readings pass them all."""
    prog, ctl, checked = control.readings(workload, SEED, 1.5, "cpu",
                                          TINY[workload])
    assert all(v > 0 for v in checked.values())
    bench = run.load_bench(workload)
    limits = run.cell_spec(bench, workload)[2]["limits"]
    assert run.compare(prog, limits)[1]
    assert not run.compare(ctl, limits)[1]


def test_reference_spline_and_field_match_the_port():
    from alore_legged_manipulator_tpu_torch.ops.esdf import (
        esdf_from_occupancy)
    from alore_legged_manipulator_tpu_torch.solvers.minco import minco_coeffs
    rng = np.random.default_rng(0)
    B, N = 3, 7
    head = torch.tensor(rng.normal(size=(B, 2, 3)))
    tail = torch.tensor(rng.normal(size=(B, 2, 3)))
    inner = torch.tensor(rng.normal(size=(B, 2, N - 1)))
    times = torch.tensor(rng.uniform(0.3, 1.5, (B, N)))
    ref = spline.minco_coeffs(head, tail, inner, times)
    np.testing.assert_allclose(ref, minco_coeffs(head, tail, inner, times),
                               rtol=1e-9, atol=1e-9)
    occ = rng.random((20, 24)) < 0.15
    port = esdf_from_occupancy(torch.as_tensor(occ), torch.zeros(2), 0.1)
    np.testing.assert_allclose(spline.esdf(occ, 0.1, torch.float64),
                               port.dist.double(), atol=1e-6)


def test_reference_tick_in_bfloat16_runs():
    """The control's tick: every stage runs in bfloat16."""
    B, n = 2, 6
    bf = torch.bfloat16
    traj = spline.WorldTraj(
        torch.zeros(1, 2, 3, dtype=bf), torch.tensor([[[0.3, 0, 0],
                                                       [2.0, 0, 0]]], dtype=bf),
        torch.tensor([[[0.1], [1.0]]], dtype=bf),
        torch.ones(1, 2, dtype=bf), torch.zeros(1, 2, dtype=bf),
        torch.tensor([[-0.3, 0.3, 0.2]], dtype=bf))
    z = torch.zeros(B, dtype=bf)
    state = {"plant": {"xytheta": torch.zeros(B, 3, dtype=bf), "v": z,
                       "omega": z, "vy": z, "s": z},
             "ekf_x": torch.tensor([[0, 0, 0, -0.2, 0.2, 0.1]] * B, dtype=bf),
             "ekf_P": torch.eye(6, dtype=bf).repeat(B, 1, 1),
             "x_traj": torch.zeros(B, n + 1, 3, dtype=bf),
             "u_traj": torch.zeros(B, n, 2, dtype=bf),
             "u_prev": torch.zeros(B, 2, dtype=bf)}
    cfg = {"nmpc": {"horizon": n, "dt": 0.01, "q_diag": [10, 10, 0.5],
                    "r_diag": [0.1, 0.1], "u_min": -3, "u_max": 3,
                    "qp_iters": 2, "cg_iters": 3, "delay_num": 1},
           "ekf": {"q_diag": [0.1] * 3 + [1e-3] * 3, "r_diag": [1e-3] * 3},
           "plant": {"max_acc": 2.0, "max_domega": 4.0,
                     "rate_limit_dt": 0.01, "noise_stddev": 0.01},
           "substeps": 5}
    out, u = tick.tick(state, torch.zeros(B, 5, 2, dtype=bf), 0.0, traj,
                       (-0.3, 0.3, 0.2), cfg)
    assert u.dtype == bf and out["ekf_P"].dtype == bf
    assert bool(torch.isfinite(u.float()).all())


def test_command_fails_without_a_card():
    """No card: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "track-b1", "--seed", "1", "--seconds", "1"],
                       cwd=run.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the B=1 tracking cell on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run.run_cell("track-b1", SEED, 2.0, 1)
    assert res["correct"], res["checks"]
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert set(res["metrics"]) == {"device_idle_pct.tick",
                                   "launches_per_tick.b1"}
