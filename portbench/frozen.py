"""The yardstick's frozen copies of arithmetic that the program also
carries, so that a later change to the program cannot move it:

  * `device_fields`: alore_legged_manipulator_tpu_torch/bench.py::device_fields
  * `straight_flats`: the back-end benches' front-end guess,
    alore_legged_manipulator_tpu_torch/bench.py (`mission_map_esdf`'s
    map is the back-end configuration's `map`; its goals, uniform in the
    box like `bench_goals`', are drawn by `drivers/replan.py`);
  * `wavefront_bound`: alore_legged_manipulator_tpu_torch/ops/wavefront_bench.py::bound,
    kept for a front-end cell (no cell runs the kernel yet).

`trace.summarize` holds the copy of
alore_legged_manipulator_tpu_torch/utils/profiling.py::trace_summary's
device-busy union, over in-memory intervals.
"""
from __future__ import annotations

import subprocess

import torch

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the wavefront relaxation's f32 operations per cell and sweep, and K1's
# policy pass per cell (ops/wavefront_bench.py)
OPS_PER_CELL_SWEEP = 10
OPS_PER_CELL_POLICY = 16


def device_fields(index: int = 0) -> dict:
    """The card's name and its power limit in W from nvidia-smi (None
    where nvidia-smi cannot say)."""
    watts = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
        watts = float(out.rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    return {"kind": torch.cuda.get_device_name(index), "power_limit_w": watts}


def straight_flats(goals, start, n_pieces: int) -> dict:
    """The front-end guess of the back-end benches from `start` (2,) to
    each goal (B, 2), as the fields of the program's FlatTraj: equal
    pieces over 2L/3 s (at least 1 s), yaw along the line, at rest at
    both ends."""
    g = torch.as_tensor(goals)
    dtype, B, dev = g.dtype, g.shape[0], g.device
    start = torch.as_tensor(start, dtype=dtype, device=dev)
    d = g - start
    L = torch.linalg.vector_norm(d, dim=-1)
    yaw = torch.atan2(d[:, 1], d[:, 0])
    fr = torch.arange(1, n_pieces, dtype=dtype, device=dev) / n_pieces
    inner = torch.stack([yaw[:, None].expand(B, n_pieces - 1),
                         L[:, None] * fr], dim=1)
    pos = torch.cat([start + fr[None, :, None] * d[:, None], g[:, None]], 1)
    pos = torch.cat([pos, yaw[:, None, None].expand(B, n_pieces, 1)], 2)
    total_t = torch.clamp(L / 3.0 * 2.0, min=1.0)
    z = torch.zeros_like(yaw)
    return dict(
        inner_yaw_s=inner, init_piece_time=total_t / n_pieces,
        inner_positions=pos,
        start_state=torch.stack([torch.stack([yaw, z, z], -1),
                                 torch.stack([z, z, z], -1)], 1),
        final_state=torch.stack([torch.stack([yaw, z, z], -1),
                                 torch.stack([L, z, z], -1)], 1),
        start_xytheta=torch.cat([start.expand(B, 2), yaw[:, None]], 1),
        final_xytheta=torch.cat([g, yaw[:, None]], 1),
        if_cut=torch.zeros((B,), dtype=torch.bool, device=dev))


def wavefront_bound(B, H, W, sweeps_total, packed: bool):
    """Least time (ms) the card could take for one wavefront call, and
    what bounds it: the larger of the bytes it must move (1 B of mask
    in, a 4 B field out, and for K1 a 4 B packed word out, per cell)
    over the HBM rate and the f32 operations these inputs need (their
    sweeps, summed over lanes, times a lane's cells, plus K1's policy
    pass) over the f32 peak."""
    cells = B * H * W
    t_bytes = cells * (1 + 4 + (4 if packed else 0)) / HBM_BYTES_PER_S * 1e3
    ops = sweeps_total * H * W * OPS_PER_CELL_SWEEP
    if packed:
        ops += cells * OPS_PER_CELL_POLICY
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
