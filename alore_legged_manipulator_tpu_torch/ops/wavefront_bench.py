"""Check and time the wavefront kernels at every strip length.

    python3 -m alore_legged_manipulator_tpu_torch.ops.wavefront_bench \
        [--parent DIR]

Needs one CUDA card and nvcc.  For each case (random-obstacle 80x80
grids at B=64, 192 and 4096, the mission's 80x80 map at B=64 and 4096,
the 100x100 bench map at B=4096, ragged and small grids, a serpentine grid cut short by `n_iters`, goals outside the
grid and on blocked cells, the largest grids that fit) and each strip
length whose block fits, K1 and K2 must be bit-identical to their plain
PyTorch versions, sweep counts included.  The large cases are then
timed with CUDA events, the strip lengths in turns (forward, then
backward): once as the wrapper is called and once from a CUDA graph,
which leaves the host's share out; the runtime's occupancy report is
printed for each, and each shape's plain versions are timed beside its
bound (`bound`, the least time the card could take).  With `--parent DIR`, a checkout of an earlier commit
of this repository, that commit's kernels are timed on the same inputs
in a process of their own, before and after (parent, this, this,
parent).  Then the time of one sweep in which a single strip recomputes
(a serpentine grid, one lane); a build with -DWAVEFRONT_NO_CLEAN against
the normal one at the wrapper's own strip length (what the path without
mask tests is worth); and a build with -DWAVEFRONT_PROFILE that counts,
per strip length, the share of a lane's strip-sweeps in which the strip
recomputed, the share of its warp-sweeps in which the warp had such a
strip, and the share of those warps that took the path without mask
tests.  One JSON object per line.

The grid makers, `time_ms` and `bound` here are also what chip_smoke.py
uses.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import wavefront as wf
from . import wavefront_cuda as wfc
from .esdf import esdf_from_occupancy


def random_grids(rng, B, H, W, p=0.2):
    """(occ (B, H, W) bool, goals (B, 2), starts (B, 2)): independent
    obstacles of density p, goal and start cells freed."""
    occ = rng.random((B, H, W)) < p
    goals = np.stack([rng.integers(0, H, B), rng.integers(0, W, B)], 1)
    starts = np.stack([rng.integers(0, H, B), rng.integers(0, W, B)], 1)
    lanes = np.arange(B)
    occ[lanes, goals[:, 0], goals[:, 1]] = False
    occ[lanes, starts[:, 0], starts[:, 1]] = False
    return occ, goals, starts


def bench_map_grids(rng, B):
    """The JAX package's front-end bench map: 100x100 cells of 0.1 m,
    outer walls and two bars, inflated by the front end's safe distance
    0.3 m; goals on the right, starts on the left."""
    occ = np.zeros((100, 100), bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    occ[40:44, 10:70] = True
    occ[70:74, 30:95] = True
    esdf = esdf_from_occupancy(torch.as_tensor(occ), torch.zeros(2), 0.1)
    blocked = (esdf.dist < 0.3).cpu().numpy()
    s = rng.uniform([1.0, 1.0], [3.0, 8.5], (B, 2))
    g = rng.uniform([8.0, 1.0], [9.5, 8.5], (B, 2))
    return (np.broadcast_to(blocked, (B, 100, 100)).copy(),
            (g / 0.1).astype(np.int32), (s / 0.1).astype(np.int32))


def mission_map_grids(rng, B):
    """The mission fleet's map: 80x80 cells of 0.1 m, one 1.0 x 0.6 m
    block, inflated by the fleet's wavefront safe distance 0.2 m; goals
    anywhere off the border."""
    occ = np.zeros((80, 80), bool)
    occ[30:40, 44:50] = True
    esdf = esdf_from_occupancy(torch.as_tensor(occ), torch.zeros(2), 0.1)
    blocked = np.broadcast_to((esdf.dist < 0.2).cpu().numpy(),
                              (B, 80, 80)).copy()
    goals = np.stack([rng.integers(5, 75, B), rng.integers(5, 75, B)], 1)
    blocked[np.arange(B), goals[:, 0], goals[:, 1]] = False
    return blocked, goals, goals[::-1].copy()


def serpentine_grid(H, W):
    """(occ (1, H, W), goal (1, 2), start (1, 2)): walls on every other
    row with the gap at alternating ends, so the only path from the last
    free row to the goal at (0, 0) winds through every free row -- far
    more than H + W sweeps."""
    occ = np.zeros((H, W), bool)
    for n, i in enumerate(range(1, H, 2)):
        occ[i, :] = True
        occ[i, W - 1 if n % 2 == 0 else 0] = False
    last = H - 1 if (H - 1) % 2 == 0 else H - 2
    return (occ[None], np.array([[0, 0]]), np.array([[last, W // 2]]))


# H100 SXM published peaks (NVIDIA data sheet; 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per cell: one relaxation sweep (6 mins among the eight
# candidates, 2 adds, 2 mins with the old value) and the policy pass
# (8 adds, 8 compares)
OPS_PER_CELL_SWEEP = 10
OPS_PER_CELL_POLICY = 16


def bound(B, H, W, sweeps_total, packed: bool):
    """Least time (ms) the card could take for one call, and what bounds
    it: the larger of the bytes the function must move (1 B of mask in,
    a 4 B field out, and for K1 a 4 B packed word out, per cell) over
    the HBM rate and the f32 operations these inputs need (their sweeps,
    summed over lanes, times the cells of a lane, plus K1's policy pass)
    over the f32 peak."""
    cells = B * H * W
    t_bytes = cells * (1 + 4 + (4 if packed else 0)) / HBM_BYTES_PER_S * 1e3
    ops = sweeps_total * H * W * OPS_PER_CELL_SWEEP
    if packed:
        ops += cells * OPS_PER_CELL_POLICY
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(fn, iters, warmup=2):
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


def graph_ms(fn, replays=20):
    """Device time of one call of `fn`, host overhead excluded: the call
    is captured into a CUDA graph once and the graph replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, replays, warmup=2)


def host_us(fn, calls=50):
    """Host time to enqueue one call of `fn`, in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def fitting_strips(H, W):
    out = []
    for S in wfc.STRIPS:
        try:
            wfc.strip_geometry(H, W, S)
        except ValueError:
            continue
        out.append(S)
    return out


_PARENT_SCRIPT = """
import json, sys
import numpy as np, torch
from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda as wfc
data = np.load(sys.argv[1])
for label in json.loads(sys.argv[2]):
    blk = torch.as_tensor(data[label + "/occ"], device="cuda")
    g = torch.as_tensor(data[label + "/goals"], device="cuda")
    out = {}
    for name, fn in (("k1_ms", wfc.wavefront_packed_cuda),
                     ("k2_ms", wfc.octile_distance_field_cuda)):
        for _ in range(2):
            fn(blk, g)
        torch.cuda.synchronize()
        iters = 5 if blk.shape[0] > 1000 else 30
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn(blk, g)
        e1.record()
        e1.synchronize()
        out[name] = e0.elapsed_time(e1) / iters
    print(json.dumps(dict(shape=label, parent=True, **out)), flush=True)
"""


def time_parent(parent_dir, npz_path, labels):
    """Times the kernels of the checkout at `parent_dir` on the saved
    inputs, in a process of its own (the two packages share a name)."""
    proc = subprocess.run(
        [sys.executable, "-c", _PARENT_SCRIPT, npz_path, json.dumps(labels)],
        cwd=parent_dir, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"parent timing failed:\n{proc.stderr}")
    print(proc.stdout.strip(), flush=True)


def raw_launcher(lib, occ, goals, S, profile=None):
    """A closure that launches K2 of the library `lib` (from
    `wavefront_cuda.bind`) at strip length S on these inputs, and the
    tensors it writes (dist, sweeps)."""
    B, H, W = occ.shape
    blk = torch.as_tensor(occ, device="cuda").view(torch.uint8)
    g = torch.as_tensor(goals, device="cuda").to(torch.int32).contiguous()
    dist = torch.empty((B, H, W), dtype=torch.float32, device="cuda")
    sweeps = torch.empty((B,), dtype=torch.int32, device="cuda")

    def launch():
        err = lib.wavefront_launch(
            blk.data_ptr(), g.data_ptr(), dist.data_ptr(), None,
            sweeps.data_ptr(),
            None if profile is None else profile.data_ptr(), B, H, W, S,
            H + W, 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(lib.wavefront_error_string(err).decode())
    return launch, dist, sweeps


def activity(occ, goals, S):
    """Counts of the profiling build for K2 at strip length S, as shares
    (means over the lanes)."""
    lib = wfc.bind(wfc.build(("-DWAVEFRONT_PROFILE",))[0])
    prof = torch.zeros((occ.shape[0], 5), dtype=torch.int32, device="cuda")
    launch, _, sweeps = raw_launcher(lib, occ, goals, S, prof)
    launch()
    torch.cuda.synchronize()
    p, sw = prof.double().cpu().numpy(), sweeps.double().cpu().numpy()
    return dict(strip_share=float((p[:, 0] / (p[:, 3] * sw)).mean()),
                warp_share=float((p[:, 1] / (p[:, 4] * sw)).mean()),
                clean_warp_share=float(p[:, 2].sum() / p[:, 1].sum()))


def clean_path_ab(label, occ, goals):
    """K2 with and without the path that skips the mask tests, at the
    wrapper's own strip length, in turns; identical fields."""
    B, H, W = occ.shape
    S = wfc.strip_geometry(H, W, None, B <= 2 * wfc._sm_count(0)).strip
    libs = {"with": wfc.bind(wfc.build()[0]),
            "without": wfc.bind(wfc.build(("-DWAVEFRONT_NO_CLEAN",))[0])}
    ms = {k: [] for k in libs}
    fields = []
    for order in (("with", "without"), ("without", "with")):
        for k in order:
            launch, dist, _ = raw_launcher(libs[k], occ, goals, S)
            ms[k].append(time_ms(launch, 5 if B > 1000 else 30))
            fields.append(dist)
    assert all(torch.equal(fields[0], f) for f in fields[1:])
    print(json.dumps(dict(shape=label, strip=S, clean_path_k2_ms=ms)),
          flush=True)


def check_case(label, occ, goals, n_iters=None, strips=None):
    """K1 and K2 at every fitting strip length against the plain versions:
    field, packed word and sweep count, bit for bit."""
    blk = torch.as_tensor(occ, device="cuda")
    g = torch.as_tensor(goals, device="cuda")
    d_p, p_p, s_p = wf.wavefront_packed_torch(blk, g, n_iters,
                                              return_sweeps=True)
    H, W = occ.shape[1:]
    for S in strips or fitting_strips(H, W):
        d1, p1, s1 = wfc.wavefront_packed_cuda(blk, g, n_iters,
                                               return_sweeps=True, strip=S)
        d2, s2 = wfc.octile_distance_field_cuda(blk, g, n_iters,
                                                return_sweeps=True, strip=S)
        torch.cuda.synchronize()
        for name, a, b in (("K1 dist", d1, d_p), ("K1 packed", p1, p_p),
                           ("K1 sweeps", s1, s_p), ("K2 dist", d2, d_p),
                           ("K2 sweeps", s2, s_p)):
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                raise AssertionError(
                    f"{label}, strip {S}: {name} differs from plain in "
                    f"{bad} of {a.numel()} entries")
    print(json.dumps(dict(case=label, shape=list(occ.shape), n_iters=n_iters,
                          strips=strips or fitting_strips(H, W),
                          sweeps_max=int(s_p.max()),
                          reached=int((d_p < 1e9).sum()),
                          identical=True)), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parent = argv[1] if argv[:1] == ["--parent"] else None
    if not torch.cuda.is_available():
        print("wavefront_bench: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _, log = wfc.build()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip(), flush=True)

    rng = np.random.default_rng(0)
    big = {"64x80x80": random_grids(rng, 64, 80, 80),
           "192x80x80": random_grids(rng, 192, 80, 80),
           "4096x80x80": random_grids(rng, 4096, 80, 80),
           "64x80x80 mission map": mission_map_grids(rng, 64),
           "4096x80x80 mission map": mission_map_grids(rng, 4096),
           "4096x100x100": bench_map_grids(rng, 4096)}
    for label, (occ, goals, _s) in big.items():
        check_case(label, occ, goals)
    for H, W in ((8, 8), (100, 8), (30, 34), (48, 56), (50, 83), (83, 50),
                 (1, 40), (40, 1), (5, 3)):
        occ, goals, _s = random_grids(rng, 6, H, W, p=0.3)
        check_case(f"ragged {H}x{W}", occ, goals)
    occ, goals, _s = serpentine_grid(40, 50)
    for n in (0, 1, 7, 90, None, 2000):
        check_case("serpentine 40x50", occ, goals, n_iters=n)
    occ, goals, _s = random_grids(rng, 8, 20, 24, p=0.2)
    outside = np.array([[-1, 3], [-20, -24], [-21, 3], [20, 3], [2, 24],
                        [2, -25], [1000, 1000], [5, 5]])
    occ[7, 5, 5] = True                               # a blocked goal
    check_case("goals outside / blocked 20x24", occ, outside)
    for H, W in ((150, 150), (161, 161), (900, 20)):
        occ, goals, _s = random_grids(rng, 2, H, W, p=0.25)
        check_case(f"large {H}x{W}", occ, goals)
    try:
        wfc.wavefront_packed_cuda(
            torch.zeros((1, 162, 162), dtype=torch.bool, device="cuda"),
            torch.zeros((1, 2), dtype=torch.int32, device="cuda"))
    except ValueError as e:
        print(json.dumps(dict(case="162x162 refused", error=str(e))),
              flush=True)
    else:
        raise AssertionError("a 162x162 grid was not refused")

    if parent:
        tmp = tempfile.mkdtemp()
        npz = os.path.join(tmp, "inputs.npz")
        np.savez(npz, **{f"{k}/occ": v[0] for k, v in big.items()},
                 **{f"{k}/goals": v[1] for k, v in big.items()})
        time_parent(parent, npz, list(big))

    # timings, strip lengths in turns
    for label, (occ, goals, _s) in big.items():
        B, H, W = occ.shape
        blk = torch.as_tensor(occ, device="cuda")
        g = torch.as_tensor(goals, device="cuda").to(torch.int32)
        iters = 5 if B > 1000 else 30
        strips = fitting_strips(H, W)
        times = {S: {"k1": [], "k2": [], "k1_graph": [], "k2_graph": []}
                 for S in strips}
        for order in (strips, strips[::-1]):
            for S in order:
                def k1():
                    return wfc.wavefront_packed_cuda(blk, g, strip=S)

                def k2():
                    return wfc.octile_distance_field_cuda(blk, g, strip=S)
                times[S]["k1"].append(time_ms(k1, iters))
                times[S]["k2"].append(time_ms(k2, iters))
                times[S]["k1_graph"].append(graph_ms(k1, iters))
                times[S]["k2_graph"].append(graph_ms(k2, iters))
        _, sweeps = wfc.octile_distance_field_cuda(blk, g, return_sweeps=True)
        sw = int(sweeps.to(torch.int64).sum())
        (b1, by1), (b2, by2) = (bound(B, H, W, sw, True),
                                bound(B, H, W, sw, False))
        print(json.dumps(dict(
            shape=label, enqueue_us=host_us(
                lambda: wfc.wavefront_packed_cuda(blk, g)),
            sweeps_mean=sw / B, k1_bound_ms=b1, k1_bound_by=by1,
            k2_bound_ms=b2, k2_bound_by=by2,
            k1_plain_ms=time_ms(lambda: wf.wavefront_packed_torch(blk, g), 1,
                                warmup=1),
            k2_plain_ms=time_ms(lambda: wf.octile_distance_field_torch(blk, g),
                                1, warmup=1))), flush=True)
        for S in strips:
            print(json.dumps(dict(
                shape=label, strip=S, k1_ms=times[S]["k1"],
                k2_ms=times[S]["k2"], k1_device_ms=times[S]["k1_graph"],
                k2_device_ms=times[S]["k2_graph"],
                k1=wfc.occupancy(H, W, True, S),
                k2=wfc.occupancy(H, W, False, S),
                default=wfc.strip_geometry(
                    H, W, None, B <= 2 * wfc._sm_count(0)).strip == S)),
                flush=True)
    if parent:
        time_parent(parent, npz, list(big))
    # one lane whose front is a single cell: the time of a sweep in which
    # one warp recomputes, that is the barrier and the latency of one strip
    occ, goals, _s = serpentine_grid(80, 80)
    blk = torch.as_tensor(occ, device="cuda")
    g = torch.as_tensor(goals, device="cuda").to(torch.int32)
    for S in fitting_strips(80, 80):
        _, sw = wfc.octile_distance_field_cuda(blk, g, 10000,
                                               return_sweeps=True, strip=S)
        ms = graph_ms(lambda: wfc.octile_distance_field_cuda(
            blk, g, 10000, strip=S), 5)
        print(json.dumps(dict(case="serpentine 1x80x80", strip=S,
                              sweeps=int(sw[0]), k2_device_ms=ms,
                              us_per_sweep=ms * 1e3 / int(sw[0]))), flush=True)
    for label, (occ, goals, _s) in big.items():
        clean_path_ab(label, occ, goals)
    for label, (occ, goals, _s) in big.items():
        for S in fitting_strips(*occ.shape[1:]):
            print(json.dumps(dict(shape=label, strip=S,
                                  **activity(occ, goals, S))), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
