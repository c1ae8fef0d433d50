"""The ADMM kernel (`csrc/qp_admm.cu`, wrapped by `ops/qp_admm_cuda.py`)
against its plain version, `ops/qp.py::admm_steps`, the eager loop of
`qp_admm_general`.

On the CPU: the wrapper imports without nvcc or a card and its nvcc
flags name the instantiation of each shape; the patterns (`admm_pattern`
of a mask, `dense_pattern`) list A's entries by rows and by columns and
L's row envelope; the pattern `_qp_layout` builds equals the nonzeros of
`_build_qp`'s A at random linearisation points, and holds them at v = 0,
where the heading entries are exactly zero; cholesky_ex leaves exact
zeros left of the envelope there; a torch model of the kernel's per-lane
order (the sums over A's entries by rows and by columns, the column-wise
solves over L's envelope packed by rows, the diagonal's reciprocals)
equals the eager loop in float64 within 1e-12, on random general QPs
through the dense pattern and on the LTV-MPC's QP through its layout's
pattern.

On the card (marked `cuda`, skipped without one): the kernel against the
eager loop on the same CUDA inputs at B in {1, 7, 131, 132, 4096},
float64 within 1e-10 and float32 as close to the float64 solution as the
float32 loop (see `_assert_f32_close`); the layout's pattern and the
dense one bit for bit; cholesky_ex's exact zeros outside the envelope
at 4096 lanes; the dense route on a random general QP and on a golden;
one launch and one `admm.kernel` count a pass, `admm.iters` still 150 a
pass; a CUDA graph's replay bit for bit the eager launch; the raises.
Run there with `python -m pytest --noconftest -m cuda
tests/test_torch_qp_admm_cuda.py` (the conftest imports JAX; this file
does not).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.control import ltv_mpc as tl
from alore_legged_manipulator_tpu_torch.ops import cuda_build
from alore_legged_manipulator_tpu_torch.ops import qp_admm_cuda as qac
from alore_legged_manipulator_tpu_torch.ops.qp import (
    admm_steps, qp_admm_general)
from alore_legged_manipulator_tpu_torch.utils import profiling as tp

torch.set_num_threads(1)

F64 = torch.float64
LTV = tl.LtvMpcConfig()


def _random_qp(B, n, m_eq, m_box, m_in, dtype=F64, device="cpu", seed=0):
    """(H, g, A, lb, ub) of B general QPs: equality rows, a box on the
    first m_box variables and m_in two-sided dense rows."""
    rng = np.random.default_rng(seed)
    Ms = rng.standard_normal((B, n, n))
    H = np.einsum("bij,bkj->bik", Ms, Ms) / n + 0.1 * np.eye(n)
    g = rng.standard_normal((B, n))
    A = np.concatenate([rng.standard_normal((B, m_eq, n)),
                        np.broadcast_to(np.eye(n)[:m_box], (B, m_box, n)),
                        rng.standard_normal((B, m_in, n))], axis=1)
    beq = rng.standard_normal((B, m_eq)) * 0.3
    lb = np.concatenate([beq, -np.full((B, m_box), 0.5),
                         -np.full((B, m_in), 1.0)], axis=1)
    ub = np.concatenate([beq, np.full((B, m_box), 0.5),
                         rng.uniform(0.0, 1.0, (B, m_in))], axis=1)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (H, g, A, lb, ub))


def _ltv_qp(B, dtype=F64, device="cpu", seed=0, speed=(-0.5, 2.0)):
    """(H, g, A, lb, ub) of the LTV-MPC's first pass at B random states,
    references and carried plans, v drawn from `speed`."""
    rng = np.random.default_rng(seed)
    T = LTV.horizon
    x0 = np.stack([rng.uniform(-1, 1, B), rng.uniform(-1, 1, B),
                   rng.uniform(-3, 3, B)], -1)
    output = np.stack([rng.uniform(*speed, (B, T)),
                       rng.uniform(-4.0, 4.0, (B, T))], 1)
    ts = 0.01 * np.arange(1, T + 1)
    xref = np.stack([x0[:, :1] + ts, x0[:, 1:2] + 0.3 * ts,
                     np.zeros((B, T)), x0[:, 2:3] + 0.5 * ts], 1)
    dref = np.stack([np.full((B, T), 1.0), np.full((B, T), 0.5)], 1)
    buff = rng.uniform(-1, 1, (B, 1, 2))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    carry = tl.LtvMpcCarry(output=t(output), delay_buff=t(buff))
    xbar = tl._rollout(t(x0), carry.output, LTV)
    H, g, A, lb, ub = tl._build_qp(xbar, t(xref), t(dref), carry, LTV)
    return H.contiguous(), g, A, lb, ub


def _factor(H, A, lb, ub, rho, sigma=1e-6):
    """qp_admm_general's rho_vec and lower factor, as it computes them."""
    n = H.shape[-1]
    rho_vec = torch.where(torch.abs(ub - lb) < 1e-12,
                          torch.full_like(lb, rho * 1e3),
                          torch.full_like(lb, rho))
    At = A.transpose(1, 2)
    K = (H + sigma * torch.eye(n, dtype=H.dtype, device=H.device)
         + torch.matmul(At * rho_vec[:, None, :], A))
    return rho_vec, torch.linalg.cholesky_ex(K).L


# -- on the CPU --------------------------------------------------------------

def test_wrapper_needs_no_library_off_the_card(monkeypatch):
    def no_build(*args):
        raise AssertionError("built a library")
    monkeypatch.setattr(qac, "_load", no_build)
    H, g, A, lb, ub = _random_qp(2, 6, 1, 2, 2)
    L = _factor(H, A, lb, ub, 0.4)[1]
    with pytest.raises(ValueError, match="CUDA tensors"):
        qac.qp_admm_cuda(L, A, g, lb, ub, rho=0.4, sigma=1e-6, alpha=1.6,
                         iters=3)
    # the CPU path is the eager loop, whatever the pattern
    pat = qac.dense_pattern(A.shape[1], 6, torch.device("cpu"))
    got = qp_admm_general(H, g, A, lb, ub, iters=20, pattern=pat)
    want = qp_admm_general(H, g, A, lb, ub, iters=20)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flags_name_each_instantiation():
    # the LTV-MPC's shape: 5 warps of 32 variables, 201 rows on 160 threads
    assert qac._flags(torch.float32, 145, 201) == (
        "-DADMM_SCALAR=float", "-DADMM_W=5", "-DADMM_MS=2")
    assert qac._flags(F64, 37, 34) == (
        "-DADMM_SCALAR=double", "-DADMM_W=2", "-DADMM_MS=1")
    paths = {qac.library_path(dt, n, m)
             for dt in (torch.float32, F64) for n, m in
             ((145, 201), (140, 194), (150, 208), (37, 34))}
    # delay 2's (140, 194) and delay 0's (150, 208) instantiate (145, 201)
    assert len(paths) == 4
    assert all(p.parent.parent == cuda_build.BUILD_ROOT for p in paths)


def test_lane_bytes_of_the_shapes():
    # the cells' shape: L's envelope, 4,627 entries of 10,440
    pat = tl._qp_layout(LTV, torch.float32, torch.device("cpu")).pattern
    assert pat.l_entries == 4627
    assert qac.lane_bytes(145, 201, 484, 4627) == 4 * (4627 + 484 + 201) \
        + 8 * 146
    # nine lanes an SM by shared memory (228 KB, 1 KB a block reserved)
    assert 9 * (qac.lane_bytes(145, 201, 484, 4627) + 1024) <= 228 * 1024
    # the dense route of the golden's shape fits in float32, not float64
    dense = (145, 201, 145 * 201, 145 * 144 // 2)
    assert qac.lane_bytes(*dense) <= qac.MAX_LANE_BYTES
    assert qac.lane_bytes(*dense, F64) > qac.MAX_LANE_BYTES


def _assert_pattern_lists(pat, mask):
    m, n = mask.shape
    assert pat.shape == (m, n) and pat.nnz == int(mask.sum())
    assert all(p.dtype == torch.int32 for p in pat.arrays)
    rows, cols = pat.ent_row.long(), pat.col_idx.long()
    got = torch.zeros_like(mask)
    got[rows, cols] = True
    assert torch.equal(got, mask)
    # by rows, in increasing column; the row pointers bracket each row
    assert torch.equal(torch.diff(pat.row_ptr.long()), mask.sum(1))
    assert bool((rows * n + cols).diff().gt(0).all())
    # by columns, in increasing row, pointing into the row order
    pos = pat.csc_pos.long()
    assert torch.equal(torch.diff(pat.col_ptr.long()), mask.sum(0))
    assert torch.equal(pat.csc_row.long(), rows[pos])
    assert bool((cols[pos] * m + rows[pos]).diff().gt(0).all())
    assert torch.equal(pos.sort().values, torch.arange(pat.nnz))


def test_patterns_list_their_entries_by_rows_and_columns():
    rng = np.random.default_rng(3)
    mask = torch.as_tensor(rng.random((9, 7)) < 0.3)
    mask[4] = False                         # an empty row
    mask[:, 2] = False                      # an empty column
    _assert_pattern_lists(qac.admm_pattern(mask), mask)
    dense = qac.dense_pattern(5, 4, torch.device("cpu"))
    _assert_pattern_lists(dense, torch.ones(5, 4, dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(
        dense.arrays,
        qac.admm_pattern(torch.ones(5, 4, dtype=torch.bool)).arrays))
    # the dense envelope is the whole lower triangle, packed by rows
    assert dense.l_first.tolist() == [0, 0, 0, 0]
    assert dense.l_start.tolist() == [0, 0, 1, 3, 6]
    assert dense.l_entries == 6


def test_envelope_of_a_kkt_pattern():
    k = torch.zeros((6, 6), dtype=torch.bool)
    k[3, 1] = k[1, 3] = True
    k[5, 2] = k[2, 5] = True
    assert qac.envelope_first(k).tolist() == [0, 1, 2, 1, 4, 2]
    mask = torch.zeros((2, 6), dtype=torch.bool)
    mask[0, [0, 4]] = True                  # A'A couples 0 and 4
    pat = qac.admm_pattern(mask, hessian_mask=k)
    assert pat.l_first.tolist() == [0, 1, 2, 1, 0, 2]
    assert pat.l_start.tolist() == [0, 0, 0, 0, 2, 6, 9]
    assert pat.l_entries == 9


def _outside_envelope(pattern):
    n = pattern.shape[1]
    j = torch.arange(n)
    return j[None, :] < pattern.l_first.long().cpu()[:, None]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_cholesky_leaves_exact_zeros_outside_the_envelope(dtype):
    """The kernel reads L only inside its row envelope: cholesky_ex gives
    exact zeros (not small values) left of it, at random linearisation
    points and at v = 0."""
    pat = tl._qp_layout(LTV, dtype, torch.device("cpu")).pattern
    out = _outside_envelope(pat)
    assert int(out.sum()) == 145 * 144 // 2 - 4627
    for seed, speed in ((0, (-0.5, 2.0)), (1, (0.0, 3.0)), (2, (0.0, 0.0))):
        H, g, A, lb, ub = _ltv_qp(16, dtype, seed=seed, speed=speed)
        L = _factor(H, A, lb, ub, LTV.admm_rho)[1]
        assert bool((L[:, out] == 0).all())
        assert bool(torch.isfinite(L).all())


@pytest.mark.parametrize("delay", [0, 1, 2])
def test_layout_pattern_equals_the_nonzeros_of_a(delay):
    cfg = tl.LtvMpcConfig(delay_num=delay)
    lay = tl._qp_layout(cfg, F64, torch.device("cpu"))
    pat = lay.pattern
    mask = torch.zeros(pat.shape, dtype=torch.bool)
    mask[pat.ent_row.long(), pat.col_idx.long()] = True
    global LTV
    saved, LTV = LTV, cfg
    try:
        for seed in range(4):
            A = _ltv_qp(3, seed=seed)[2]
            assert torch.equal(A != 0, mask.expand_as(A))
        # v = 0: the heading entries -A02, -A12 are exactly zero, inside
        # the pattern; nothing else moves
        A0 = _ltv_qp(2, seed=9, speed=(0.0, 0.0))[2]
    finally:
        LTV = saved
    assert bool(((A0 != 0) <= mask).all())
    n_st = cfg.horizon - delay
    heading = torch.zeros_like(mask)
    heading[lay.rows[2 * n_st:], lay.cols[2 * n_st:]] = True
    assert torch.equal((A0 == 0) & mask, heading.expand_as(A0))
    # the cells' shape: 484 entries of 29,145 (portbench/ltv_work.py)
    if delay == 1:
        assert pat.shape == (201, 145) and pat.nnz == 484


def _padded(starts, idx, count):
    """(slots, entries) index matrices of a pattern's rows or columns,
    padded with -1: entry k of each row or column in its order."""
    starts = starts.long()
    lens = torch.diff(starts)
    width = int(lens.max()) if lens.numel() else 0
    k = torch.arange(width)
    pos = starts[:-1, None] + k[None, :]
    ok = k[None, :] < lens[:, None]
    return torch.where(ok, pos, torch.full_like(pos, -1)), ok, width


def _kernel_model(L, A, g, lb, ub, rho_vec, pattern, sigma, alpha, iters,
                  x0=None):
    """The kernel's per-lane arithmetic, in its order, in torch: A's
    entries in the pattern's row order; zt_r and (A'q)_i sums from 0 over
    the row's (column's) entries in increasing index; L's envelope packed
    by rows (row i from column l_first[i] at l_start[i]); the forward
    solve by columns, each row updated in increasing column; the
    backward solve by columns of L' (rows of L), each row updated in
    decreasing column; the unknowns as products with the diagonal's
    reciprocals."""
    B, n = g.shape
    m = A.shape[1]
    pat = [p.long().cpu() for p in pattern.arrays]
    row_ptr, col_idx, ent_row, col_ptr, csc_pos, csc_row, first, start = pat
    Av = A[:, ent_row, col_idx]
    rows = torch.repeat_interleave(torch.arange(n), start.diff())
    cols = torch.arange(pattern.l_entries) - start[rows] + first[rows]
    Lp = L[:, rows, cols]
    off = start[:-1] - first           # (i, j) at Lp[off[i] + j]
    rinv = 1.0 / torch.diagonal(L, dim1=1, dim2=2)
    r_pos, r_ok, r_w = _padded(row_ptr, col_idx, m)
    c_pos, c_ok, c_w = _padded(col_ptr, csc_pos, n)
    ar = torch.arange(n)

    def a_times(v):
        acc = torch.zeros((B, m), dtype=g.dtype)
        for k in range(r_w):
            p = r_pos[:, k].clamp(min=0)
            term = Av[:, p] * v[:, col_idx[p]]
            acc = torch.where(r_ok[:, k], acc + term, acc)
        return acc

    def at_times(q):
        acc = torch.zeros((B, n), dtype=g.dtype)
        for k in range(c_w):
            e = c_pos[:, k].clamp(min=0)
            term = Av[:, csc_pos[e]] * q[:, csc_row[e]]
            acc = torch.where(c_ok[:, k], acc + term, acc)
        return acc

    x = torch.zeros_like(g) if x0 is None else x0.clone()
    z = torch.minimum(torch.maximum(a_times(x), lb), ub)
    y = torch.zeros_like(lb)
    for _ in range(iters):
        b = (sigma * x - g) + at_times(rho_vec * z - y)
        for j in range(n):
            wj = b[:, j] * rinv[:, j]
            b[:, j] = wj
            below = ar[(ar > j) & (first <= j)]
            b[:, below] = b[:, below] - Lp[:, off[below] + j] * wj[:, None]
        for j in reversed(range(n)):
            xj = b[:, j] * rinv[:, j]
            b[:, j] = xj
            f = int(first[j])
            row = Lp[:, int(off[j]) + f:int(off[j]) + j]
            b[:, f:j] = b[:, f:j] - row * xj[:, None]
        zt = a_times(b)
        x = alpha * b + (1.0 - alpha) * x
        zr = alpha * zt + (1.0 - alpha) * z
        zn = torch.minimum(torch.maximum(zr + y / rho_vec, lb), ub)
        y = y + rho_vec * (zr - zn)
        z = zn
    return x, y


def _model_vs_eager(H, g, A, lb, ub, pattern, iters, rho=0.4, x0=None):
    rho_vec, L = _factor(H, A, lb, ub, rho)
    want = admm_steps(L, A, g, lb, ub, rho_vec, x0, 1e-6, 1.6, iters)
    got = _kernel_model(L, A, g, lb, ub, rho_vec, pattern, 1e-6, 1.6, iters,
                        x0)
    return [float((a - b).abs().max()) for a, b in zip(got, want)]


# tests/test_torch_ltv_mpc.py's random QP and a smaller one.  The gap is
# rounding that 150 steps carry through K (equality rows weigh 400): it
# grows with n and K's conditioning, 1.3e-12 at n = 20.
@pytest.mark.parametrize("n,m_eq,m_box,m_in", [(6, 2, 3, 2), (12, 4, 6, 3)])
def test_kernel_model_matches_eager_dense_pattern(n, m_eq, m_box, m_in):
    H, g, A, lb, ub = _random_qp(3, n, m_eq, m_box, m_in, seed=n)
    pat = qac.dense_pattern(A.shape[1], n, torch.device("cpu"))
    x0 = torch.as_tensor(np.random.default_rng(n).standard_normal((3, n)))
    for start in (None, x0):
        gaps = _model_vs_eager(H, g, A, lb, ub, pat, 150, x0=start)
        assert max(gaps) < 1e-12, gaps


def test_kernel_model_matches_eager_ltv_pattern():
    H, g, A, lb, ub = _ltv_qp(2, seed=4)
    pat = tl._qp_layout(LTV, F64, torch.device("cpu")).pattern
    gaps = _model_vs_eager(H, g, A, lb, ub, pat, LTV.admm_iters,
                           rho=LTV.admm_rho)
    assert max(gaps) < 1e-12, gaps


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.init()
    return torch.device("cuda")


def _plain(H, g, A, lb, ub, iters, rho, x0=None):
    """The eager loop on H's device, from qp_admm_general's factor."""
    rho_vec, L = _factor(H, A, lb, ub, rho)
    return admm_steps(L, A, g, lb, ub, rho_vec, x0, 1e-6, 1.6, iters)


def _assert_f32_close(got, qp64, iters, rho, x0=None):
    """float32: the kernel and the float32 loop sum in other orders, and
    the ADMM, unconverged after a pass and its KKT matrix conditioned
    ~1e4 (PERF.md section 2), carries that rounding into x and y.  So
    the kernel is held to the float64 solution: on every lane its gap
    to it is at most twice the float32 loop's, plus 1e-5 (x in m and
    m/s of O(1)), in x and in y relative to y's scale."""
    H, g, A, lb, ub = qp64
    x64, y64 = _plain(H, g, A, lb, ub, iters, rho, x0)
    x32, y32 = _plain(*(t.float() for t in qp64), iters, rho,
                      None if x0 is None else x0.float())
    for k, p, r in ((got[0], x32, x64), (got[1], y32, y64)):
        scale = float(r.abs().max()) or 1.0
        gk = (k.double() - r).abs().flatten(1).amax(1) / scale
        gp = (p.double() - r).abs().flatten(1).amax(1) / scale
        assert bool((gk <= 2.0 * gp + 1e-5).all()), (
            float(gk.max()), float(gp.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 7, 131, 132, 4096])
def test_kernel_matches_eager_on_card(cuda_device, B, dtype):
    qp = _ltv_qp(B, F64, cuda_device, seed=B)
    pat = tl._qp_layout(LTV, dtype, cuda_device).pattern
    rho, iters = LTV.admm_rho, LTV.admm_iters
    args = tuple(t.to(dtype) for t in qp)
    before = qac.LAUNCHES["qp_admm"]
    got = qp_admm_general(*args, iters=iters, rho=rho, pattern=pat)
    torch.cuda.synchronize()
    assert qac.LAUNCHES["qp_admm"] == before + 1
    if dtype == F64:
        want = _plain(*args, iters, rho)
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < 1e-10
    else:
        _assert_f32_close(got, qp, iters, rho)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 300])
def test_layout_and_dense_patterns_give_the_same_bits(cuda_device, B):
    """The entries the layout's pattern skips are exact zeros, so the
    kernel adds the same terms in the same order either way."""
    H, g, A, lb, ub = _ltv_qp(B, torch.float32, cuda_device, seed=5)
    L = _factor(H, A, lb, ub, 0.4)[1]
    outs = [qac.qp_admm_cuda(L, A, g, lb, ub, rho=0.4, sigma=1e-6,
                             alpha=1.6, iters=150, pattern=pat)
            for pat in (tl._qp_layout(LTV, torch.float32,
                                      cuda_device).pattern, None)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cholesky_leaves_exact_zeros_on_card(cuda_device, dtype):
    pat = tl._qp_layout(LTV, dtype, cuda_device).pattern
    out = _outside_envelope(pat).to(cuda_device)
    for seed, speed in ((0, (-0.5, 2.0)), (2, (0.0, 0.0))):
        H, g, A, lb, ub = _ltv_qp(4096, dtype, cuda_device, seed=seed,
                                  speed=speed)
        L = _factor(H, A, lb, ub, LTV.admm_rho)[1]
        assert bool((L[:, out] == 0).all())
        assert bool(torch.isfinite(L).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [3, 500])
def test_dense_route_on_a_random_general_qp(cuda_device, B, dtype):
    qp = _random_qp(B, 37, 5, 20, 9, F64, cuda_device, seed=B)
    x0 = torch.randn((B, 37), dtype=F64, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(1))
    args = tuple(t.to(dtype) for t in qp)
    got = qp_admm_general(*args, z0=x0.to(dtype), iters=200, rho=0.4)
    if dtype == F64:
        want = _plain(*args, 200, 0.4, x0)
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) < 1e-10
    else:
        _assert_f32_close(got, qp, 200, 0.4, x0)


def _golden(name):
    with gzip.open(GOLDEN_DIR / f"{name}.json.gz", "rt") as f:
        return json.load(f)


@pytest.mark.cuda
def test_dense_route_on_a_golden(cuda_device):
    """The first LTV golden's own QP through the dense pattern: float32
    fits a block (the float64 lane does not, see the raises)."""
    spec = importlib.util.spec_from_file_location(
        "torch_golden_io", Path(__file__).resolve().parent
        / "torch_golden_io.py")
    gio = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gio)
    g = gio.ltv_case(gio.LTV_CASES[0])[-1]
    qp64 = tuple(torch.tensor(np.asarray(g[k])[None], dtype=F64,
                              device=cuda_device)
                 for k in ("P", "q", "A", "lb", "ub"))
    qp32 = tuple(t.float() for t in qp64)
    got = qp_admm_general(*qp32, iters=150, rho=0.4)
    _assert_f32_close(got, qp64, 150, 0.4)


@pytest.mark.cuda
def test_one_launch_and_one_count_a_pass(cuda_device):
    x_est = torch.zeros((4, 3), device=cuda_device)
    T = LTV.horizon
    ts = 0.01 * torch.arange(1, T + 1, device=cuda_device)
    xref = torch.stack([ts, 0.3 * ts, 0 * ts, 0.5 * ts])[None].repeat(4, 1, 1)
    dref = torch.stack([1 + 0 * ts, 0.5 + 0 * ts])[None].repeat(4, 1, 1)
    carry = tl.ltv_mpc_init(LTV, torch.float32, 4, cuda_device)
    carry = tl.ltv_mpc_tick(carry, x_est, xref, dref, LTV)[0]
    torch.cuda.synchronize()
    tp.disable()
    tp.reset()
    before = qac.LAUNCHES["qp_admm"]
    tp.enable()
    try:
        with tp.span("tick"):
            tl.ltv_mpc_tick(carry, x_est, xref, dref, LTV)
    finally:
        tp.disable()
    assert qac.LAUNCHES["qp_admm"] == before + LTV.sqp_iters
    (q,) = tp.snapshot()["requests"]
    tp.reset()
    it = q["spans"]["admm.iterate"]["counts"]
    assert it.get("admm.kernel") == LTV.sqp_iters
    assert it.get("admm.iters") == LTV.sqp_iters * LTV.admm_iters
    assert q["counts"]["admm.kernel"] == LTV.sqp_iters
    assert "host_syncs" not in it


@pytest.mark.cuda
def test_graph_replay_equals_eager_launch(cuda_device):
    args = _ltv_qp(16, torch.float32, cuda_device, seed=2)
    pat = tl._qp_layout(LTV, torch.float32, cuda_device).pattern

    def run():
        return qp_admm_general(*args, iters=150, rho=0.4, pattern=pat)
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], eager[0])
    assert torch.equal(captured[1], eager[1])


@pytest.mark.cuda
def test_inputs_the_kernel_does_not_take_raise(cuda_device):
    H, g, A, lb, ub = _ltv_qp(2, torch.float32, cuda_device)
    L = _factor(H, A, lb, ub, 0.4)[1]
    kw = dict(rho=0.4, sigma=1e-6, alpha=1.6, iters=3)
    pat = tl._qp_layout(LTV, torch.float32, cuda_device).pattern
    with pytest.raises(ValueError, match="float32 or float64"):
        qac.qp_admm_cuda(*(t.half() for t in (L, A, g, lb, ub)), **kw)
    with pytest.raises(ValueError, match="one dtype"):
        qac.qp_admm_cuda(L, A.double(), g, lb, ub, **kw)
    with pytest.raises(ValueError, match="every tensor on"):
        qac.qp_admm_cuda(L, A, g, lb, ub.cpu(), pattern=pat, **kw)
    with pytest.raises(ValueError, match="lb must be"):
        qac.qp_admm_cuda(L, A, g, lb[:, 1:], ub[:, 1:], **kw)
    with pytest.raises(ValueError, match="pattern is of"):
        qac.qp_admm_cuda(L, A, g, lb, ub, pattern=qac.dense_pattern(
            5, 4, cuda_device), **kw)
    with pytest.raises(ValueError, match="variables"):
        big = torch.zeros((1, 257), device=cuda_device)
        qac.qp_admm_cuda(torch.eye(257, device=cuda_device)[None],
                         torch.zeros((1, 1, 257), device=cuda_device), big,
                         big[:, :1], big[:, :1], **kw)
    # the float64 lane of the dense route does not fit a block
    H64, g64, A64, lb64, ub64 = (t.double() for t in (H, g, A, lb, ub))
    with pytest.raises(ValueError, match="shared memory"):
        qp_admm_general(H64, g64, A64, lb64, ub64, iters=3)
