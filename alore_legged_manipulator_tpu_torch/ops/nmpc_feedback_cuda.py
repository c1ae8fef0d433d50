"""Wrapper of the hand-written Hopper kernel of the NMPC feedback.

`csrc/nmpc_feedback.cu` computes, per lane and in one launch, what
`control/nmpc.py::_feedback_matfree` computes: the condensing factors,
the stage weights, the QP's gradient and diagonal, the 4 x 15 PNCG box
QP (`ops/qp.py::box_qp_pncg_op`) and the expansion.  `ops/cuda_build.py`
compiles it with nvcc for sm_90a at first use, one library for each
(dtype, stages a thread) that a process launches; each is loaded with
ctypes.  Importing this module needs neither nvcc nor a card.

`nmpc_feedback_cuda` checks its tensors, allocates the two outputs,
launches on PyTorch's current stream, raises if the launch is refused,
and adds one to `LAUNCHES["nmpc_feedback"]` and to the tracer's
`nmpc.feedback_kernel` counter.  It never synchronises and copies
nothing to the card (the weights, bounds, counts and the Tikhonov term
are plain launch arguments), so a call can be captured in a CUDA graph.
There is no fallback: a tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..utils.profiling import count
from . import cuda_build

_SRC = cuda_build.CSRC / "nmpc_feedback.cu"
# the longest horizon the source instantiates: 4 stages a thread of a warp
MAX_HORIZON = 127
_DTYPES = {torch.float32: 0, torch.float64: 1}
_N_INPUTS = 11

# launches since the last reset (a plain integer)
LAUNCHES = {"nmpc_feedback": 0}

_LIBS = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["nmpc_feedback"] = 0


def stages_per_thread(horizon: int) -> int:
    """K, the stages a thread of the lane's warp holds."""
    return -(-(horizon + 1) // 32)


def _flags(dtype, horizon: int) -> tuple:
    """The nvcc flags of the one instantiation a (dtype, horizon) runs."""
    scalar = "double" if dtype == torch.float64 else "float"
    return (f"-DFEEDBACK_SCALAR={scalar}",
            f"-DFEEDBACK_K={stages_per_thread(horizon)}")


def library_path(dtype=torch.float32, horizon: int = 50):
    return cuda_build.library_path(_SRC, _flags(dtype, horizon))


def build(dtype=torch.float32, horizon: int = 50):
    """(library path, compiler log) of the instantiation a (dtype,
    horizon) runs, compiling it at first use (a few seconds each)."""
    return cuda_build.build(_SRC, _flags(dtype, horizon))


def bind(so):
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    lib.nmpc_feedback_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.nmpc_feedback_launch.restype = ctypes.c_int
    lib.nmpc_feedback_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.nmpc_feedback_occupancy.restype = ctypes.c_int
    lib.nmpc_feedback_error_string.argtypes = [ctypes.c_int]
    lib.nmpc_feedback_error_string.restype = ctypes.c_char_p
    return lib


def _load(dtype, horizon: int):
    key = (dtype, stages_per_thread(horizon))
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = bind(build(dtype, horizon)[0])
        return _LIBS[key]


def _error(lib, err, what):
    msg = lib.nmpc_feedback_error_string(err).decode()
    return RuntimeError(f"nmpc feedback {what} failed: {msg} ({err})")


def occupancy(horizon: int, dtype=torch.float32) -> dict:
    """What the CUDA runtime reports for the instantiation a horizon runs:
    resident blocks per SM, registers per thread, threads and lanes per
    block, spilled bytes per thread."""
    lib = _load(dtype, horizon)
    out = (ctypes.c_int * 5)()
    err = lib.nmpc_feedback_occupancy(out)
    if err != 0:
        raise _error(lib, err, "occupancy query")
    return dict(blocks_per_sm=out[0], registers=out[1], threads=out[2],
                lanes_per_block=out[3], spill_bytes=out[4])


def _packed_rows(t):
    """t if every axis after the lane axis is packed, else a packed copy."""
    step = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != step:
            return t.contiguous()
        step *= size
    return t


def _check(x_traj, u_traj, prep, x_est, ref_x, ref_u):
    ts = (x_traj, u_traj, *prep, x_est, ref_x, ref_u)
    if len(ts) != _N_INPUTS or not all(torch.is_tensor(t) for t in ts):
        raise ValueError("the feedback kernel takes x_traj, u_traj, the six "
                         "factors of prepare_tri, x_est, ref_x and ref_u as "
                         "tensors")
    dev, dtype = x_traj.device, x_traj.dtype
    if dev.type != "cuda":
        raise ValueError("the feedback kernel needs CUDA tensors")
    if any(t.device != dev for t in ts):
        raise ValueError("the feedback kernel needs every tensor on "
                         f"{dev}: got {sorted({str(t.device) for t in ts})}")
    if dtype not in _DTYPES:
        raise ValueError(f"the feedback kernel takes float32 or float64, "
                         f"got {dtype}")
    if any(t.dtype != dtype for t in ts):
        raise ValueError("the feedback kernel needs one dtype: got "
                         f"{sorted({str(t.dtype) for t in ts})}")
    if x_traj.dim() != 3 or x_traj.shape[2] != 3:
        raise ValueError(f"x_traj must be (B, N+1, 3), got "
                         f"{tuple(x_traj.shape)}")
    B, n = x_traj.shape[0], x_traj.shape[1] - 1
    if not 1 <= n <= MAX_HORIZON:
        raise ValueError(f"the feedback kernel takes horizons 1..{MAX_HORIZON}"
                         f", got {n}")
    x_int, a02, a12, B0, B1, B2 = prep
    want = {"u_traj": (u_traj, (B, n, 2)), "x_int": (x_int, (B, n, 3)),
            "a02": (a02, (B, n)), "a12": (a12, (B, n)),
            "B0": (B0, (B, n, 2)), "B1": (B1, (B, n, 2)),
            "B2": (B2, (B, n, 2)), "x_est": (x_est, (B, 3)),
            "ref_x": (ref_x, (B, 3, n + 1))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if ref_u.dim() != 3 or ref_u.shape[:2] != (B, 2) or ref_u.shape[2] < n:
        raise ValueError(f"ref_u must be (B, 2, >= {n}), got "
                         f"{tuple(ref_u.shape)}")
    return B, n, [_packed_rows(t) for t in ts]


def nmpc_feedback_cuda(x_traj, u_traj, prep, x_est, ref_x, ref_u, *,
                       q_diag, r_diag, state_cost_scaling, input_cost_scaling,
                       u_min, u_max, qp_iters, cg_iters, reg):
    """The matrix-free feedback of one call in one launch: (x_new
    (B, N+1, 3), u_new (B, N, 2)) from the carried guess, the factors
    (x_int, a02, a12, B0, B1, B2) of `prepare_tri`, x_est (B, 3), ref_x
    (B, 3, N+1) and ref_u (B, 2, N+1); N is read from x_traj.  The
    scalars: the stage weights' diagonals (3 and 2 values) and decay
    rates, the input box, the QP's outer and CG iterations and its
    Tikhonov term."""
    B, n, ts = _check(x_traj, u_traj, prep, x_est, ref_x, ref_u)
    dev, dtype = x_traj.device, x_traj.dtype
    x_new = torch.empty((B, n + 1, 3), dtype=dtype, device=dev)
    u_new = torch.empty((B, n, 2), dtype=dtype, device=dev)
    if B == 0:
        return x_new, u_new
    lib = _load(dtype, n)
    ptrs = (ctypes.c_void_p * _N_INPUTS)(*(t.data_ptr() for t in ts))
    strides = (ctypes.c_longlong * _N_INPUTS)(*(t.stride(0) for t in ts))
    scalars = (ctypes.c_double * 10)(
        *map(float, q_diag), *map(float, r_diag), float(state_cost_scaling),
        float(input_cost_scaling), float(u_min), float(u_max), float(reg))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nmpc_feedback_launch(
            ptrs, strides, x_new.data_ptr(), u_new.data_ptr(), scalars,
            int(qp_iters), int(cg_iters), B, n, ts[-1].shape[2],
            _DTYPES[dtype], stream)
    if err != 0:
        raise _error(lib, err, "launch")
    LAUNCHES["nmpc_feedback"] += 1
    count("nmpc.feedback_kernel")
    return x_new, u_new
