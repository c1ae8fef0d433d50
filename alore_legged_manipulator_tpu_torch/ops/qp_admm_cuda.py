"""Wrapper of the hand-written Hopper kernel of the ADMM's steps.

`csrc/qp_admm.cu` runs, per lane and in one launch, the `iters` relaxed
steps of `ops/qp.py::qp_admm_general` from the Cholesky factor of its
KKT matrix: the products with A and A' over A's pattern, the two
triangular solves over L's row envelope and the updates, with the
lane's factor and A's entries held in shared memory for the whole pass.
`ops/cuda_build.py` compiles it with nvcc for sm_90a at first use, one
library for each (dtype, warps a lane, constraint rows a thread) that a
process launches; each is loaded with ctypes.  Importing this module
needs neither nvcc nor a card.

The QP's pattern (`AdmmPattern`) says where A and L may be nonzero in
every lane: `admm_pattern(mask, hessian_mask)` builds it from boolean
masks of A and H once (a caller with a fixed structure, like the
LTV-MPC's `_qp_layout`, caches it); without one, `dense_pattern` puts
every entry in it.  The kernel reads only the pattern's entries.

`qp_admm_cuda` checks its tensors, allocates the two outputs, launches
on PyTorch's current stream, raises if the launch is refused, and adds
one to `LAUNCHES["qp_admm"]` and to the tracer's `admm.kernel` counter.
It never synchronises and copies nothing to the card (the scalars and
counts are plain launch arguments), so a call can be captured in a CUDA
graph.  There is no fallback: a tensor the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from ..utils.profiling import count
from . import cuda_build

_SRC = cuda_build.CSRC / "qp_admm.cu"
# the most variables the source instantiates: 8 row blocks of 32
MAX_VARIABLES = 256
# dynamic shared memory one block (one lane) may take on an H100
MAX_LANE_BYTES = 227 * 1024
_DTYPES = {torch.float32: 0, torch.float64: 1}
_N_INPUTS = 6

# launches since the last reset (a plain integer)
LAUNCHES = {"qp_admm": 0}

_LIBS = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES["qp_admm"] = 0


class AdmmPattern(NamedTuple):
    """Where a QP's A (m, n) and the lower factor L of its KKT matrix may
    be nonzero, the same in every lane; int32 tensors on A's device.  A
    by rows: `row_ptr` (m + 1) and, for each entry in row order, its
    column `col_idx` and row `ent_row` (nnz).  A by columns: `col_ptr`
    (n + 1) and, for each entry in column order, its position in row
    order `csc_pos` and its row `csc_row` (nnz).  L's row envelope: row i
    holds columns `l_first[i]` .. i, and its `l_entries` entries left of
    the diagonal, packed by rows, start at `l_start[i]` (n + 1)."""
    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    ent_row: torch.Tensor
    col_ptr: torch.Tensor
    csc_pos: torch.Tensor
    csc_row: torch.Tensor
    l_first: torch.Tensor
    l_start: torch.Tensor
    l_entries: int

    @property
    def arrays(self):
        return tuple(self[:8])

    @property
    def shape(self):
        return self.row_ptr.numel() - 1, self.col_ptr.numel() - 1

    @property
    def nnz(self):
        return self.col_idx.numel()


def envelope_first(kkt_mask):
    """The first column of each row of the lower triangle of a boolean
    (n, n) mask with its diagonal set.  Cholesky leaves every entry of L
    left of it an exact zero: L_ij = (K_ij - sum_k<j L_ik L_jk) / L_jj,
    and for j below the row's first column K_ij and every L_ik are 0."""
    n = kkt_mask.shape[0]
    low = torch.tril(kkt_mask.to("cpu", torch.bool)) | torch.eye(
        n, dtype=torch.bool)
    return low.to(torch.int64).argmax(1)


def admm_pattern(mask, hessian_mask=None) -> AdmmPattern:
    """The pattern of a boolean (m, n) mask of A, on the mask's device,
    with the envelope of L from the KKT matrix's pattern, H's (n, n)
    mask (every entry when None) with A'A's.  Reads the masks on the
    host: build it once, outside the hot path."""
    dev = mask.device
    mk = mask.detach().to("cpu", torch.bool)
    m, n = mk.shape
    rows, cols = mk.nonzero(as_tuple=True)          # row-major order
    row_ptr = torch.zeros(m + 1, dtype=torch.int64)
    row_ptr[1:] = torch.cumsum(mk.sum(1), 0)
    col_ptr = torch.zeros(n + 1, dtype=torch.int64)
    col_ptr[1:] = torch.cumsum(mk.sum(0), 0)
    csc_pos = torch.argsort(cols * m + rows)
    hm = (torch.ones((n, n), dtype=torch.bool) if hessian_mask is None
          else hessian_mask.detach().to("cpu", torch.bool))
    ata = (mk.T.to(torch.float64) @ mk.to(torch.float64)) > 0
    first = envelope_first(hm | ata)
    start = torch.zeros(n + 1, dtype=torch.int64)
    start[1:] = torch.cumsum(torch.arange(n) - first, 0)
    parts = (row_ptr, cols, rows, col_ptr, csc_pos, rows[csc_pos], first,
             start)
    return AdmmPattern(*(p.to(device=dev, dtype=torch.int32) for p in parts),
                       l_entries=int(start[-1]))


@functools.lru_cache(maxsize=16)
def dense_pattern(m: int, n: int, device) -> AdmmPattern:
    """Every entry of an (m, n) A and of L's lower triangle, built on
    `device` without reading anything back to the host."""
    def ar(k):
        return torch.arange(k, dtype=torch.int32, device=device)
    return AdmmPattern(
        row_ptr=ar(m + 1) * n, col_idx=ar(n).repeat(m),
        ent_row=ar(m).repeat_interleave(n), col_ptr=ar(n + 1) * m,
        csc_pos=(ar(m)[None, :] * n + ar(n)[:, None]).reshape(-1),
        csc_row=ar(m).repeat(n), l_first=ar(n) * 0,
        l_start=ar(n + 1) * (ar(n + 1) - 1) // 2,
        l_entries=n * (n - 1) // 2)


def lane_bytes(n: int, m: int, nnz: int, l_entries: int,
               dtype=torch.float32) -> int:
    """Shared memory of one lane: L's envelope left of the diagonal, A's
    entries and one vector of max(m, n), rounded up to 8 bytes, then each
    row's (first column, offset) pair and a sentinel."""
    item = torch.finfo(dtype).bits // 8
    values = item * (l_entries + nnz + max(m, n))
    return -(-values // 8) * 8 + 8 * (n + 1)


def _shape_flags(n: int, m: int) -> tuple:
    """(warps a lane, constraint rows a thread) of an n x m QP."""
    warps = -(-n // 32)
    return warps, -(-m // (32 * warps))


def _flags(dtype, n: int, m: int) -> tuple:
    """The nvcc flags of the one instantiation a (dtype, n, m) runs."""
    scalar = "double" if dtype == torch.float64 else "float"
    warps, ms = _shape_flags(n, m)
    return (f"-DADMM_SCALAR={scalar}", f"-DADMM_W={warps}",
            f"-DADMM_MS={ms}")


def library_path(dtype=torch.float32, n: int = 145, m: int = 201):
    return cuda_build.library_path(_SRC, _flags(dtype, n, m))


def build(dtype=torch.float32, n: int = 145, m: int = 201):
    """(library path, compiler log) of the instantiation a (dtype, n, m)
    runs, compiling it at first use (a few seconds each)."""
    return cuda_build.build(_SRC, _flags(dtype, n, m))


def bind(so):
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(so))
    lib.qp_admm_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_double] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.qp_admm_launch.restype = ctypes.c_int
    lib.qp_admm_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.qp_admm_occupancy.restype = ctypes.c_int
    lib.qp_admm_error_string.argtypes = [ctypes.c_int]
    lib.qp_admm_error_string.restype = ctypes.c_char_p
    return lib


def _load(dtype, n: int, m: int):
    key = (dtype, *_shape_flags(n, m))
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = bind(build(dtype, n, m)[0])
        return _LIBS[key]


def _error(lib, err, what):
    msg = lib.qp_admm_error_string(err).decode()
    return RuntimeError(f"qp admm {what} failed: {msg} ({err})")


def occupancy(n: int, m: int, nnz: int, l_entries: int,
              dtype=torch.float32) -> dict:
    """What the CUDA runtime reports for the instantiation of a shape:
    resident blocks (lanes) per SM, registers per thread, threads and
    shared bytes per block, spilled bytes per thread."""
    lib = _load(dtype, n, m)
    out = (ctypes.c_int * 5)()
    err = lib.qp_admm_occupancy(n, m, nnz, l_entries, out)
    if err != 0:
        raise _error(lib, err, "occupancy query")
    return dict(blocks_per_sm=out[0], registers=out[1], threads=out[2],
                shared_bytes=out[3], spill_bytes=out[4])


def _packed_rows(t):
    """t if every axis after the lane axis is packed, else a packed copy."""
    step = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != step:
            return t.contiguous()
        step *= size
    return t


def _factor_layout(L):
    """(L or a packed copy, 1 if each lane is stored by columns)."""
    n = L.shape[1]
    if n == 1 or L.stride()[1:] == (n, 1):
        return L, 0
    if L.stride()[1:] == (1, n):
        return L, 1
    return L.contiguous(), 0


def _check(L, A, g, lb, ub, x0, pattern):
    ts = [L, A, g, lb, ub] + ([] if x0 is None else [x0])
    if not all(torch.is_tensor(t) for t in ts):
        raise ValueError("the ADMM kernel takes L, A, g, lb, ub and x0 as "
                         "tensors")
    dev, dtype = g.device, g.dtype
    if dev.type != "cuda":
        raise ValueError("the ADMM kernel needs CUDA tensors")
    if any(t.device != dev for t in ts):
        raise ValueError("the ADMM kernel needs every tensor on "
                         f"{dev}: got {sorted({str(t.device) for t in ts})}")
    if dtype not in _DTYPES:
        raise ValueError(f"the ADMM kernel takes float32 or float64, got "
                         f"{dtype}")
    if any(t.dtype != dtype for t in ts):
        raise ValueError("the ADMM kernel needs one dtype: got "
                         f"{sorted({str(t.dtype) for t in ts})}")
    if g.dim() != 2 or A.dim() != 3:
        raise ValueError(f"g must be (B, n) and A (B, m, n), got "
                         f"{tuple(g.shape)} and {tuple(A.shape)}")
    B, n = g.shape
    m = A.shape[1]
    if not 1 <= n <= MAX_VARIABLES or m < 1:
        raise ValueError(f"the ADMM kernel takes 1..{MAX_VARIABLES} "
                         f"variables and at least one row, got n={n}, m={m}")
    want = {"L": (L, (B, n, n)), "A": (A, (B, m, n)), "lb": (lb, (B, m)),
            "ub": (ub, (B, m))}
    if x0 is not None:
        want["x0"] = (x0, (B, n))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if pattern is None:
        pattern = dense_pattern(m, n, dev)
    if not isinstance(pattern, AdmmPattern):
        raise ValueError("pattern must be an AdmmPattern")
    if pattern.shape != (m, n):
        raise ValueError(f"the pattern is of a {pattern.shape} matrix, A of "
                         f"{(m, n)}")
    if pattern.l_first.numel() != n or pattern.l_start.numel() != n + 1:
        raise ValueError(f"the pattern's envelope of L is not of {n} rows")
    if any(p.device != dev or p.dtype != torch.int32 or not p.is_contiguous()
           for p in pattern.arrays):
        raise ValueError(f"the pattern's arrays must be packed int32 on {dev}")
    nbytes = lane_bytes(n, m, pattern.nnz, pattern.l_entries, dtype)
    if nbytes > MAX_LANE_BYTES:
        raise ValueError(f"a lane of the ADMM kernel needs {nbytes} bytes of "
                         f"shared memory (n={n}, m={m}, {pattern.nnz} entries "
                         f"of A, {pattern.l_entries} of L, {dtype}), more "
                         f"than a block's {MAX_LANE_BYTES}")
    return B, n, m, pattern


def qp_admm_cuda(L, A, g, lb, ub, x0=None, *, rho: float, sigma: float,
                 alpha: float, iters: int, pattern: AdmmPattern = None):
    """`iters` ADMM steps of `qp_admm_general` in one launch: (x (B, n),
    y (B, m)) from the lower factor L (B, n, n) of its KKT matrix, A
    (B, m, n), g (B, n), lb, ub (B, m) and the warm start x0 (B, n) or
    None for zeros.  A and L are read only at `pattern`'s entries (every
    entry without one)."""
    B, n, m, pattern = _check(L, A, g, lb, ub, x0, pattern)
    dev, dtype = g.device, g.dtype
    x = torch.empty((B, n), dtype=dtype, device=dev)
    y = torch.empty((B, m), dtype=dtype, device=dev)
    if B == 0:
        return x, y
    L, colmajor = _factor_layout(L)
    ts = [L] + [_packed_rows(t) for t in (A, g, lb, ub)]
    ts.append(None if x0 is None else _packed_rows(x0))
    lib = _load(dtype, n, m)
    ptrs = (ctypes.c_void_p * _N_INPUTS)(
        *(None if t is None else t.data_ptr() for t in ts))
    strides = (ctypes.c_longlong * _N_INPUTS)(
        *(0 if t is None else t.stride(0) for t in ts))
    pats = (ctypes.c_void_p * 8)(*(p.data_ptr() for p in pattern.arrays))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qp_admm_launch(
            ptrs, strides, colmajor, pats, x.data_ptr(), y.data_ptr(),
            float(rho), float(sigma), float(alpha), int(iters), B, n, m,
            pattern.nnz, pattern.l_entries, _DTYPES[dtype], stream)
    if err != 0:
        raise _error(lib, err, "launch")
    LAUNCHES["qp_admm"] += 1
    count("admm.kernel")
    return x, y
