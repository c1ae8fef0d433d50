"""Wrappers of the hand-written Hopper wavefront kernels.

`csrc/wavefront.cu` holds both kernels (K1 packed field + policy, K2
field only) behind a plain C interface.  It is compiled with nvcc for
sm_90a into a shared library at first use, under `build/` at the root
of the checkout, keyed by a hash of the source and the flags, and
loaded with ctypes.  Importing this module needs neither nvcc nor a
card.

Each wrapper allocates its outputs, launches on PyTorch's current
stream, raises if the launch is refused, and adds one to its count in
`LAUNCHES`.  There is no fallback: a tensor the kernel does not take, or
a grid that does not fit in shared memory, raises.  The plain versions
live in ops/wavefront.py.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .wavefront import _dist0

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "wavefront.cu"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# most dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232_448

# launches of each kernel since the last reset (plain integers)
LAUNCHES = {"wavefront_packed": 0, "octile_distance_field": 0}

_LIB = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the wavefront kernels are built "
                       "from csrc/wavefront.cu on a machine with the CUDA "
                       "toolkit")


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / f"wavefront-{h.hexdigest()[:16]}" / "libwavefront.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if the hashed library is missing.  Returns
    (library path, compiler log); the log holds ptxas' register and
    shared-memory report of a fresh build."""
    so = library_path()
    log_path = so.with_suffix(".log")
    if so.exists():
        return so, log_path.read_text() if log_path.exists() else ""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".tmp-{os.getpid()}-{so.name}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return so, log


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            lib.wavefront_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.wavefront_launch.restype = ctypes.c_int
            lib.wavefront_error_string.argtypes = [ctypes.c_int]
            lib.wavefront_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def smem_bytes(H: int, W: int) -> int:
    """Dynamic shared memory one lane's block needs (10 B per cell)."""
    return 10 * H * W


def _check(blocked, goal_cell):
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
    need = smem_bytes(H, W)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"a {H}x{W} grid needs {need} B of shared memory per "
                         f"lane; the card offers {MAX_SMEM_BYTES} B")
    return B, H, W


def _launch(blocked, goal_cell, n_iters, packed: bool):
    B, H, W = _check(blocked, goal_cell)
    n_iters = H + W if n_iters is None else int(n_iters)
    dev = blocked.device
    dist0 = _dist0(blocked.to(torch.bool), goal_cell).contiguous()
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
            blk.data_ptr(), dist0.data_ptr(), dist.data_ptr(),
            pk.data_ptr() if packed else None, sweeps.data_ptr(),
            B, H, W, n_iters, 1 if packed else 0, stream)
    if err != 0:
        msg = lib.wavefront_error_string(err).decode()
        raise RuntimeError(f"wavefront kernel launch failed: {msg} ({err})")
    LAUNCHES["wavefront_packed" if packed else "octile_distance_field"] += 1
    return dist, pk, sweeps


def wavefront_packed_cuda(blocked, goal_cell, n_iters: int | None = None,
                          return_sweeps: bool = False):
    """Kernel K1: (dist (B, H, W) f32, packed (B, H, W) i32) [, sweeps (B,)]."""
    dist, pk, sweeps = _launch(blocked, goal_cell, n_iters, packed=True)
    return (dist, pk, sweeps) if return_sweeps else (dist, pk)


def octile_distance_field_cuda(blocked, goal_cell, n_iters: int | None = None,
                               return_sweeps: bool = False):
    """Kernel K2: dist (B, H, W) f32 [, sweeps (B,)]."""
    dist, _, sweeps = _launch(blocked, goal_cell, n_iters, packed=False)
    return (dist, sweeps) if return_sweeps else dist
