"""Front-end throughput: host pipeline vs the on-device wavefront (twin
of examples/bench_frontend.py).

`planner/frontend.py` is per-scenario host Python (native C++ JPS +
numpy sampling) -- by design, matching its role in the reference (a
single ~ms search per replan).  At fleet scale the host loop
serializes, while `ops/wavefront.py` is the batched front end the
mission fleet uses on the card.  This benchmark measures BOTH on the
same scenario distribution and prints the JAX bench's table: host
plans/s and device paths/s for each fleet size.  The host pipeline
builds its FlatTraj on the CPU (the JAX bench pins it to its CPU
backend); the device side is the octile field (kernel K2,
`csrc/wavefront.cu`, on the card) over the whole fleet and the greedy
`extract_path`, each size warmed once and then timed over
max(1, 256 // B) calls, each ended by a synchronize.

    python -m alore_legged_manipulator_tpu_torch.examples.bench_frontend \
        [B ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..bench import device_fields, timed, wavefront_bench_esdf
from ..ops.wavefront import extract_path, octile_distance_field
from ..planner.frontend import FrontendConfig, plan_frontend
from ..utils.precision import resolve_device, set_precision_policy

SIZES = [1, 16, 64, 256, 1024]


def device_fleet(blk, s_cells, g_cells):
    """The device front end for every lane of the (B, H, W) blocked grids
    `blk`: (sum of the start cells' distances, number of valid path
    cells)."""
    B = s_cells.shape[0]
    dist = octile_distance_field(blk, g_cells)
    _, valid = extract_path(dist, blk, s_cells, max_len=256)
    lanes = torch.arange(B, device=blk.device)
    return dist[lanes, s_cells[:, 0], s_cells[:, 1]].sum(), valid.sum()


def frontend_rows(sizes=SIZES, device=None, out=print, calls=None):
    """The table, one row a fleet size, each also returned as a dict
    {"B", "host_plans_per_s", "device_paths_per_s", "n_ok", "dist_sum",
    "path_cells", "host_flats" (the host FlatTraj of every lane),
    "starts", "goals" (the cells, on the device)}.  calls: the timed
    device calls a size (None: max(1, 256 // B), the JAX bench's)."""
    dev = resolve_device(device)
    set_precision_policy()
    rng = np.random.default_rng(0)
    esdf = wavefront_bench_esdf(dev)
    esdf_np = esdf.dist.cpu().numpy()
    cfg = FrontendConfig()
    blocked = esdf.dist < cfg.safe_dis

    def starts_goals(B):
        s = rng.uniform([1.0, 1.0], [3.0, 8.5], (B, 2))
        g = rng.uniform([8.0, 1.0], [9.5, 8.5], (B, 2))
        return s, g

    # warm the native JPS library + one full sampling pass off the clock
    plan_frontend(esdf_np, (0.0, 0.0), 0.1, (1.5, 1.5, 0.0),
                  (9.0, 8.0, 0.0), cfg, device="cpu")

    out(f"{'B':>6} {'host plans/s':>14} {'device paths/s':>15}")
    rows = []
    for B in sizes:
        s, g = starts_goals(B)

        # ---- host pipeline (native JPS + numpy sampling), sequential
        t0 = time.perf_counter()
        flats = [plan_frontend(esdf_np, (0.0, 0.0), 0.1, (*s[i], 0.0),
                               (*g[i], 0.0), cfg, device="cpu")
                 for i in range(B)]
        host_dt = time.perf_counter() - t0
        n_ok = sum(f is not None for f in flats)
        assert n_ok == B

        # ---- device wavefront, the whole fleet batched
        s_cells, g_cells = (torch.as_tensor((a / 0.1).astype(np.int32)).to(
            dtype=torch.int64, device=dev) for a in (s, g))
        # one map for every lane, as a contiguous batch for the kernel
        blk = blocked.expand(B, *blocked.shape).contiguous()
        with torch.no_grad():
            device_fleet(blk, s_cells, g_cells)                 # warm
            reps = calls or max(1, 256 // B)
            dev_dt, (d, n) = timed(
                lambda: [device_fleet(blk, s_cells, g_cells)
                         for _ in range(reps)][-1], dev)
        dev_dt /= reps

        out(f"{B:>6} {B / host_dt:>14.1f} {B / dev_dt:>15.1f}")
        rows.append({"B": B, "host_plans_per_s": B / host_dt,
                     "device_paths_per_s": B / dev_dt, "n_ok": n_ok,
                     "dist_sum": float(d), "path_cells": int(n),
                     "host_flats": flats, "starts": s_cells,
                     "goals": g_cells})
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sizes", nargs="*", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    info = device_fields(dev)
    print(f"device: {info['device']}, power_limit_w: "
          f"{info['power_limit_w']}", flush=True)
    rows = frontend_rows(args.sizes or SIZES, dev,
                         out=lambda s: print(s, flush=True))
    return {"rows": [{k: v for k, v in r.items()
                      if k not in ("host_flats", "starts", "goals")}
                     for r in rows], **info}


if __name__ == "__main__":
    main()
