"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing lines of its own:

1. Card and build: the card's name and power limit, the precision
   policy, and the build of the wavefront kernels from
   alore_legged_manipulator_tpu_torch/csrc/ with nvcc (sm_90a).
2. Kernels against their plain PyTorch versions on the card: K1
   (`wavefront_packed_cuda`) and K2 (`octile_distance_field_cuda`) on
   random-obstacle 80x80 grids (B=192) and on the 100x100 bench map
   (B=4096).  Fields and packed words must be bit-identical and the
   extracted paths identical; each kernel and its plain version are timed
   with CUDA events after a warm-up.
3. The mission fleet on the card at full width: B=64 three-object
   missions on the 80x80 map (wavefront front end, MINCO back end,
   NMPC + ICR-EKF closed-loop push), driven through `run_mission`.  The
   kernels' launch counts are set to 0 just before and read just after;
   K1 must have run.  A small fleet is also run on the CPU through the
   plain versions, and its front end and deliveries are compared.
4. The `kernels` JSON line, and as the last line
   {"ok": true, "device": {...}}.

Fails (non-zero exit, no result line) without a CUDA card or without the
package beside it.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet; 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# shared memory: 132 SMs x 128 B/clock x 1.98 GHz
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
# f32 operations per cell: one relaxation sweep (6 mins among the eight
# candidates, 2 adds, 2 mins with the old value) and the policy pass
# (8 adds, 8 compares)
OPS_PER_CELL_SWEEP = 10
OPS_PER_CELL_POLICY = 16


def _phase(name):
    print(f"== {name}", flush=True)


def _time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def _random_grids(rng, B, H, W, p=0.2):
    occ = rng.random((B, H, W)) < p
    goals = np.stack([rng.integers(0, H, B), rng.integers(0, W, B)], 1)
    starts = np.stack([rng.integers(0, H, B), rng.integers(0, W, B)], 1)
    lanes = np.arange(B)
    occ[lanes, goals[:, 0], goals[:, 1]] = False
    occ[lanes, starts[:, 0], starts[:, 1]] = False
    return occ, goals, starts


def _bench_map_grids(rng, B):
    """bench.py's front-end map: 100x100, walls, two bars; res 0.1."""
    from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
    occ = np.zeros((100, 100), bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    occ[40:44, 10:70] = True
    occ[70:74, 30:95] = True
    esdf = esdf_from_occupancy(torch.as_tensor(occ), torch.zeros(2), 0.1)
    blocked = (esdf.dist < 0.3).cpu().numpy()         # FrontendConfig.safe_dis
    s = rng.uniform([1.0, 1.0], [3.0, 8.5], (B, 2))
    g = rng.uniform([8.0, 1.0], [9.5, 8.5], (B, 2))
    return (np.broadcast_to(blocked, (B, 100, 100)).copy(),
            (g / 0.1).astype(np.int32), (s / 0.1).astype(np.int32))


def check_kernels(wf, wfc, label, occ, goals, starts, path_len, iters):
    """Bit-exactness and timings of K1 and K2 against the plain versions
    at one shape; returns {kernel: measurements}."""
    B, H, W = occ.shape
    blk = torch.as_tensor(occ, device="cuda")
    g = torch.as_tensor(goals, device="cuda")
    s = torch.as_tensor(starts, device="cuda")

    d_k, p_k, sweeps = wfc.wavefront_packed_cuda(blk, g, return_sweeps=True)
    d_p, p_p = wf.wavefront_packed_torch(blk, g)
    d_f, sweeps_f = wfc.octile_distance_field_cuda(blk, g, return_sweeps=True)
    d_fp = wf.octile_distance_field_torch(blk, g)
    _, c_k, v_k = wf.wavefront_path(blk, g, s, path_len, impl="cuda")
    _, c_p, v_p = wf.wavefront_path(blk, g, s, path_len, impl="torch")
    assert torch.equal(d_k, d_p), f"{label}: K1 dist differs from plain"
    assert torch.equal(p_k, p_p), f"{label}: K1 packed differs from plain"
    assert torch.equal(d_f, d_fp), f"{label}: K2 dist differs from plain"
    assert torch.equal(sweeps, sweeps_f), f"{label}: K1/K2 sweep counts differ"
    assert torch.equal(c_k, c_p) and torch.equal(v_k, v_p), \
        f"{label}: wavefront_path cells/valid differ"
    err1 = float((d_k - d_p).abs().max())
    err2 = float((d_f - d_fp).abs().max())

    cells = B * H * W
    sw = int(sweeps.to(torch.int64).sum())             # sum over lanes
    out = {}
    for name, fn, plain, err, bytes_cell, ops in (
            ("wavefront_packed",
             lambda: wfc.wavefront_packed_cuda(blk, g),
             lambda: wf.wavefront_packed_torch(blk, g), err1, 1 + 4 + 4 + 4,
             sw * H * W * OPS_PER_CELL_SWEEP + cells * OPS_PER_CELL_POLICY),
            ("octile_distance_field",
             lambda: wfc.octile_distance_field_cuda(blk, g),
             lambda: wf.octile_distance_field_torch(blk, g), err2, 1 + 4 + 4,
             sw * H * W * OPS_PER_CELL_SWEEP)):
        ms = _time_ms(fn, iters)
        plain_ms = _time_ms(plain, 1, warmup=1)
        t_bytes = cells * bytes_cell / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        out[name] = dict(
            shape=f"{B}x{H}x{W}", ms=ms, plain_ms=plain_ms, max_abs_err=err,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            smem_bound_ms=sw * H * W * 9 * 4 / SMEM_BYTES_PER_S * 1e3,
            sweeps_mean=sw / B, sweeps_max=int(sweeps.max()))
        print(f"{label} {name}: bit-identical to plain; "
              + json.dumps(out[name]), flush=True)
    mean_turn_cells = float(v_k.sum(1).to(torch.float32).mean())
    print(f"{label} wavefront_path: cells and valid identical "
          f"(mean valid cells {mean_turn_cells:.1f})", flush=True)
    return out


def leg_phases(mf, items, targets, robot0, esdf, icr, cfg):
    """Host wall time of each phase of the fleet's first leg, each phase
    ended by a synchronize: the steps of run_mission and _push_leg."""
    from alore_legged_manipulator_tpu_torch.control.tracked_traj import (
        build_tracked_traj)
    from alore_legged_manipulator_tpu_torch.planner.backend import plan_backend
    from alore_legged_manipulator_tpu_torch.planner.flat_traj import Polynome
    from alore_legged_manipulator_tpu_torch.runtime.closed_loop import (
        simulate_tracking)
    dev = torch.device("cuda")
    it = torch.as_tensor(items, device=dev)
    tg = torch.as_tensor(targets, device=dev)
    robot = torch.as_tensor(robot0, device=dev)
    B = it.shape[0]
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    with torch.no_grad():
        leg_esdf = timed("paint_esdf", lambda: mf._painted_esdf(
            esdf, it[:, 1:], cfg.paint_half_extents))
        robot = timed("approach", lambda: mf._approach(
            robot, it[:, 0], cfg.fsm, cfg.approach_ticks))
        flat = timed("front_end", lambda: mf._wavefront_flat(
            leg_esdf, it[:, 0], robot[:, 2], tg[:, 0], cfg))
        res = timed("back_end", lambda: plan_backend(flat, leg_esdf,
                                                     cfg.backend))
        icr_vec = torch.tensor([icr.yr, icr.yl, icr.xv], device=dev).expand(B, 3)
        tt = timed("tracked_traj", lambda: build_tracked_traj(Polynome(
            traj_start_time=torch.zeros(B, device=dev), inner_points=res.inner,
            piece_times=res.times, init_state=flat.start_state,
            tail_state=res.tail_state, start_position=flat.start_xytheta,
            icr=icr_vec), n_grid=256))
        timed("closed_loop", lambda: simulate_tracking(
            tt, icr, cfg.push_ticks, cfg.loop, seed=0, x0=tt.seq[:, 0]))
    total = sum(times.values())
    print("first-leg phases (s): " + json.dumps(
        {**times, "leg_total": total,
         "back_end_stage2_iters_max": int(res.stage2_iters.max()),
         "back_end_replans_max": int(res.replans.max())}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
    from alore_legged_manipulator_tpu_torch.ops import wavefront as wf
    from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda as wfc
    from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
    from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as mf
    from alore_legged_manipulator_tpu_torch.utils.precision import (
        set_precision_policy)

    # ---- 1. card and build ----
    _phase("card and build")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"device: {kind}", flush=True)
    print(smi, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    set_precision_policy()
    t0 = time.perf_counter()
    so, log = wfc.build()
    print(f"built {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # ---- 2. kernels against their plain versions ----
    _phase("kernels against plain versions")
    rng = np.random.default_rng(0)
    m80 = check_kernels(wf, wfc, "80x80 B=192", *_random_grids(rng, 192, 80, 80),
                        path_len=160, iters=20)
    m100 = check_kernels(wf, wfc, "100x100 B=4096", *_bench_map_grids(rng, 4096),
                         path_len=256, iters=5)
    oversize = torch.zeros((1, 160, 160), dtype=torch.bool, device="cuda")
    try:
        wfc.wavefront_packed_cuda(oversize, torch.zeros((1, 2), dtype=torch.int64,
                                                        device="cuda"))
    except ValueError as e:
        print(f"160x160 refused as expected: {e}", flush=True)
    else:
        raise AssertionError("a 160x160 grid was not refused")

    # ---- 3. the mission fleet on the card ----
    _phase("mission fleet B=64 K=3 on the card")
    occ = np.zeros((80, 80), bool)
    occ[30:40, 44:50] = True
    icr = ICRParams(-0.3, 0.3, 0.2)
    cfg = mf.MissionFleetConfig(approach_ticks=700, push_ticks=550)
    B, K = 64, 3
    items, targets = mf.spaced_scenarios(B, K, np.random.default_rng(0))
    robot0 = np.tile(np.array([1.0, 4.0, 0.0], np.float32), (B, 1))
    esdf = esdf_from_occupancy(torch.as_tensor(occ, device="cuda"),
                               torch.zeros(2), 0.1)
    items32, targets32 = items.astype(np.float32), targets.astype(np.float32)
    wfc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mf.run_mission(items32, targets32, robot0, esdf, icr, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(wfc.LAUNCHES)
    print("launches during the mission:", json.dumps(launches), flush=True)
    assert launches["wavefront_packed"] > 0, "K1 never ran on the main path"
    assert res.object_err.shape == (B, K) and res.push_traj.shape == \
        (B, K, cfg.push_ticks, 3)
    for name, v in res._asdict().items():
        if v.dtype.is_floating_point:
            assert bool(torch.isfinite(v).all()), f"non-finite {name}"
    delivered = float(res.delivered.float().mean())
    err = res.object_err
    print(json.dumps({
        "mission_wall_s": wall, "missions": B, "objects": K,
        "delivered_frac": delivered, "object_err_mean": float(err.mean()),
        "object_err_max": float(err.max()),
        "plan_err_max": float(res.plan_err.max()),
        "collision_frac": float(res.collision.float().mean()),
        "track_err_max": float(res.track_err_max.max())}), flush=True)
    assert delivered >= 0.75, f"delivered_frac {delivered} below 0.75"
    leg_phases(mf, items32, targets32, robot0, esdf, icr, cfg)

    # a small fleet (the first legs of 8 of these missions, unpainted map)
    # on the card through the kernel and on the CPU through the plain
    # versions: the front end agrees to 1e-9 in f64 (only libm rounding
    # differs), and the f32 missions deliver alike
    _phase("small fleet: card vs CPU plain")
    Bs = 8
    it_s, tg_s = items32[:Bs, :1], targets32[:Bs, :1]
    occ_t = torch.as_tensor(occ)
    out = {}
    for dev in ("cuda", "cpu"):
        e = esdf_from_occupancy(occ_t.to(dev), torch.zeros(2), 0.1)

        def f64(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)
        flat = mf._wavefront_flat(e, f64(it_s[:, 0]), f64(np.zeros(Bs)),
                                  f64(tg_s[:, 0]), cfg)
        r = mf.run_mission(it_s, tg_s, robot0[:Bs], e, icr, cfg, device=dev)
        out[dev] = (flat, r)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        same = (torch.allclose(a.cpu(), b, rtol=0, atol=1e-9)
                if a.dtype.is_floating_point else torch.equal(a.cpu(), b))
        assert same, "front end differs between card and CPU"
    dc, dp = out["cuda"][1].delivered.cpu(), out["cpu"][1].delivered
    print(f"front end agrees to 1e-9 (f64); delivered card "
          f"{dc.flatten().tolist()} cpu {dp.flatten().tolist()}", flush=True)
    assert int(dc.sum()) >= int(dp.sum()) - 1, \
        "the card delivers fewer legs than the CPU reference"

    # ---- 4. result lines ----
    kern = []
    for name, replaces in (
            ("wavefront_packed",
             "alore_legged_manipulator_tpu/ops/wavefront_pallas.py:282"),
            ("octile_distance_field",
             "alore_legged_manipulator_tpu/ops/wavefront_pallas.py:316")):
        m = m80[name]
        kern.append(dict(
            name=name, route="cuda",
            source="alore_legged_manipulator_tpu_torch/csrc/wavefront.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=max(m["max_abs_err"], m100[name]["max_abs_err"]),
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None, shape=m["shape"],
            ms_100x100=m100[name]["ms"], plain_ms_100x100=m100[name]["plain_ms"],
            bound_ms_100x100=m100[name]["bound_ms"]))
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
