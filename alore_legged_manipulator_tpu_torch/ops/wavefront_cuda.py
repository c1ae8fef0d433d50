"""Wrappers of the hand-written Hopper wavefront kernels.

`csrc/wavefront.cu` holds both kernels (K1 packed field + policy, K2
field only) behind a plain C interface.  `ops/cuda_build.py` compiles it
with nvcc for sm_90a into a shared library at first use, under `build/`
at the root of the checkout, keyed by a hash of the source and the
flags; it is loaded with ctypes.  Importing this module needs neither
nvcc nor a card.

Each wrapper allocates its outputs, launches on PyTorch's current
stream, raises if the launch is refused, and adds one to its count in
`LAUNCHES`.  The kernel makes its own start field from `goal_cell`: a
negative index counts from the end once, and a goal that is still
outside the grid (or on a blocked cell) leaves the whole field at 1e9,
as the plain versions in ops/wavefront.py do.  There is no fallback: a
tensor the kernel does not take, or a grid that fits no block, raises.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from . import cuda_build

_SRC = cuda_build.CSRC / "wavefront.cu"
NVCC_FLAGS = cuda_build.NVCC_FLAGS
# most dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232_448
MAX_THREADS = 1024
# strip lengths the source instantiates, and the border of a row in floats
STRIPS = (8, 20, 28)
_PAD = 4

# launches of each kernel since the last reset (plain integers)
LAUNCHES = {"wavefront_packed": 0, "octile_distance_field": 0}

_LIB = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path(extra_flags: tuple = ()) -> Path:
    return cuda_build.library_path(_SRC, extra_flags)


def build(extra_flags: tuple = ()) -> tuple[Path, str]:
    """Compile the kernels if the hashed library is missing.  Returns
    (library path, compiler log); the log holds ptxas' register and
    shared-memory report of a fresh build.  `extra_flags` go to nvcc
    after NVCC_FLAGS (-DWAVEFRONT_PROFILE makes the counting build)."""
    return cuda_build.build(_SRC, extra_flags)


def bind(so: Path):
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    lib.wavefront_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.wavefront_launch.restype = ctypes.c_int
    lib.wavefront_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.wavefront_occupancy.restype = ctypes.c_int
    lib.wavefront_error_string.argtypes = [ctypes.c_int]
    lib.wavefront_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(build()[0])
    return _LIB


class StripGeometry(NamedTuple):
    """One lane's block: strip length, strips a row, row pitch in floats,
    threads (whole warps) and dynamic shared memory in bytes.  The same
    arithmetic as `geometry` in csrc/wavefront.cu."""
    strip: int
    strips_per_row: int
    pitch: int
    threads: int
    smem: int


def _geometry(H: int, W: int, S: int) -> StripGeometry:
    def smem(pitch):
        # two bordered f32 fields, three changed-flag words per bordered row
        return (H + 2) * (8 * pitch + 12)

    ns = -(-W // S)
    pitch = ns * S + 2 * _PAD
    # 8 consecutive threads own the same strip of 8 consecutive rows: a
    # pitch of 4 mod 8 floats keeps their float4 loads out of each other's
    # banks, taken where the wider rows still fit
    if pitch % 8 == 0 and smem(pitch + 4) <= MAX_SMEM_BYTES:
        pitch += 4
    threads = -(-(H * ns) // 32) * 32
    return StripGeometry(S, ns, pitch, threads, smem(pitch))


@functools.lru_cache(maxsize=256)
def strip_geometry(H: int, W: int, strip: int | None = None,
                   few_lanes: bool = False) -> StripGeometry:
    """The block a lane of an (H, W) grid runs in.

    Of the strip lengths 8 and 20, where the block fits (at most 1024
    threads, 30 strips a row, 232,448 B) the one that pads the row's end
    least is taken.  On a tie the longest wins (20 at 80x80 and 100x100:
    fewer threads, so three and two blocks stay resident on an SM), but
    with `few_lanes` (no more lanes than two per SM, every lane resident
    anyway) the shortest (8 at 80x80: more threads work on the one lane's
    sweep).  28 is taken only where none of these fits.  `strip` forces
    one length.  Raises ValueError where no block fits."""
    def fits(g):
        return (g.threads <= MAX_THREADS and g.strips_per_row <= 30
                and g.smem <= MAX_SMEM_BYTES)

    if strip is not None:
        if strip not in STRIPS:
            raise ValueError(f"strip must be one of {STRIPS}: {strip}")
        cands = [_geometry(H, W, strip)]
    else:
        tie = 1 if few_lanes else -1
        cands = sorted((_geometry(H, W, S) for S in STRIPS[:-1]),
                       key=lambda g: (g.strips_per_row * g.strip - W,
                                      tie * g.strip))
        cands.append(_geometry(H, W, STRIPS[-1]))
    for g in cands:
        if fits(g):
            return g
    g = cands[-1]
    raise ValueError(
        f"a {H}x{W} grid fits no block: with strips of {g.strip} cells a lane "
        f"needs {g.threads} threads (at most {MAX_THREADS}) and {g.smem} B of "
        f"shared memory (at most {MAX_SMEM_BYTES} B: 8 B per bordered cell "
        f"and 12 B per bordered row)")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def smem_bytes(H: int, W: int) -> int:
    """Dynamic shared memory one lane's block needs: two f32 fields of
    (H + 2) rows by (row padded to whole strips + 8) floats, and 12 B of
    changed flags per row."""
    return strip_geometry(H, W).smem


def occupancy(H: int, W: int, packed: bool, strip: int | None = None,
              few_lanes: bool = False) -> dict:
    """What the CUDA runtime reports for the instantiation a (H, W) grid
    runs: resident blocks per SM, registers per thread, threads and
    dynamic shared memory per block, spilled bytes per thread."""
    g = strip_geometry(H, W, strip, few_lanes)
    lib = _load()
    out = (ctypes.c_int * 5)()
    err = lib.wavefront_occupancy(H, W, g.strip, 1 if packed else 0, out)
    if err != 0:
        msg = lib.wavefront_error_string(err).decode()
        raise RuntimeError(f"wavefront occupancy query failed: {msg} ({err})")
    if (out[2], out[3]) != (g.threads, g.smem):
        raise RuntimeError(f"block geometry differs between the wrapper "
                           f"{g} and the library {tuple(out)}")
    return dict(strip=g.strip, blocks_per_sm=out[0], registers=out[1],
                threads=out[2], smem_bytes=out[3], spill_bytes=out[4])


def _check(blocked, goal_cell, strip):
    if not (torch.is_tensor(blocked) and blocked.is_cuda):
        raise ValueError("wavefront kernels need a CUDA `blocked` tensor")
    if blocked.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"blocked must be bool or uint8, got {blocked.dtype}")
    if blocked.dim() != 3:
        raise ValueError(f"blocked must be (B, H, W), got {tuple(blocked.shape)}")
    if not blocked.is_contiguous():
        raise ValueError("blocked must be contiguous")
    B, H, W = blocked.shape
    if not (torch.is_tensor(goal_cell) and goal_cell.device == blocked.device
            and goal_cell.shape == (B, 2)
            and not goal_cell.dtype.is_floating_point):
        raise ValueError("goal_cell must be an integer (B, 2) tensor on the "
                         "same device as blocked")
    if H < 1 or W < 1:
        raise ValueError("empty grid")
    few = B <= 2 * _sm_count(blocked.device.index)
    return B, H, W, strip_geometry(H, W, strip, few)


def _launch(blocked, goal_cell, n_iters, packed: bool, strip=None):
    B, H, W, geo = _check(blocked, goal_cell, strip)
    n_iters = H + W if n_iters is None else int(n_iters)
    dev = blocked.device
    goal = goal_cell.to(torch.int32).contiguous()
    dist = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    pk = (torch.empty((B, H, W), dtype=torch.int32, device=dev)
          if packed else None)
    sweeps = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return dist, pk, sweeps
    lib = _load()
    blk = blocked.view(torch.uint8) if blocked.dtype == torch.bool else blocked
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wavefront_launch(
            blk.data_ptr(), goal.data_ptr(), dist.data_ptr(),
            pk.data_ptr() if packed else None, sweeps.data_ptr(), None,
            B, H, W, geo.strip, n_iters, 1 if packed else 0, stream)
    if err != 0:
        msg = lib.wavefront_error_string(err).decode()
        raise RuntimeError(f"wavefront kernel launch failed: {msg} ({err})")
    LAUNCHES["wavefront_packed" if packed else "octile_distance_field"] += 1
    return dist, pk, sweeps


def wavefront_packed_cuda(blocked, goal_cell, n_iters: int | None = None,
                          return_sweeps: bool = False,
                          strip: int | None = None):
    """Kernel K1: (dist (B, H, W) f32, packed (B, H, W) i32) [, sweeps (B,)].
    `strip` forces a strip length (for measurements)."""
    dist, pk, sweeps = _launch(blocked, goal_cell, n_iters, True, strip)
    return (dist, pk, sweeps) if return_sweeps else (dist, pk)


def octile_distance_field_cuda(blocked, goal_cell, n_iters: int | None = None,
                               return_sweeps: bool = False,
                               strip: int | None = None):
    """Kernel K2: dist (B, H, W) f32 [, sweeps (B,)]."""
    dist, _, sweeps = _launch(blocked, goal_cell, n_iters, False, strip)
    return (dist, sweeps) if return_sweeps else dist
