"""Batched on-device grid search: octile wavefront + path extraction
(port of ops/wavefront.py).

The exact 8-connected octile distance-to-goal field (costs 1 and
sqrt(2), the reference's diagonal corner rule: a diagonal move is
forbidden only when BOTH adjacent orthogonal cells are blocked) by
min-plus relaxation, followed by greedy policy descent.  Every function
takes a leading lane axis: blocked (B, H, W) bool, cells (B, 2) int.

`impl` selects the field's implementation: "cuda" runs the hand-written
Hopper kernels (ops/wavefront_cuda.py, csrc/wavefront.cu), "torch" the
plain PyTorch versions below, and "auto" picks "cuda" for CUDA tensors
and "torch" for CPU tensors.  Both give bit-identical fields and packed
words.  Costs are in CELL units.
"""
from __future__ import annotations

import torch

SQ2 = 1.4142135623730951
# (dx, dy, cost) for the 8-connected moves
_MOVES = [(1, 0, 1.0), (-1, 0, 1.0), (0, 1, 1.0), (0, -1, 1.0),
          (1, 1, SQ2), (1, -1, SQ2), (-1, 1, SQ2), (-1, -1, SQ2)]

_BIG = 1e9
# run lengths in the packed word are capped at 2^(RUN_LEVELS-1) = 16:
# the JAX kernel's doubling loop runs for spans 1, 2, 4, 8
RUN_LEVELS = 5
RUN_CAP = 1 << (RUN_LEVELS - 1)


def _check_impl(impl: str, t: torch.Tensor) -> str:
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"impl must be 'auto', 'torch' or 'cuda': {impl!r}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "torch"
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f"{t.device}")
    return impl


def _shifted(a, dx: int, dy: int, fill):
    """out[..., i, j] = a[..., i + dx, j + dy], `fill` past the border."""
    H, W = a.shape[-2:]
    out = torch.full_like(a, fill)
    i0, i1 = max(0, -dx), min(H, H - dx)
    j0, j1 = max(0, -dy), min(W, W - dy)
    if i0 < i1 and j0 < j1:
        out[..., i0:i1, j0:j1] = a[..., i0 + dx:i1 + dx, j0 + dy:j1 + dy]
    return out


def _dist0(blocked, goal_cell):
    """Initial field: 0 at the goal (if free), _BIG elsewhere; (B, H, W)."""
    B = blocked.shape[0]
    dist0 = torch.full(blocked.shape, _BIG, dtype=torch.float32,
                       device=blocked.device)
    lanes = torch.arange(B, device=blocked.device)
    g = goal_cell.to(torch.int64)
    dist0[lanes, g[:, 0], g[:, 1]] = 0.0
    return torch.where(blocked, torch.full_like(dist0, _BIG), dist0)


def _invalid_masks(blocked):
    """Per-move invalid mask: out-of-grid OR (diagonals) the corner rule."""
    H, W = blocked.shape[-2:]
    rows = torch.arange(H, device=blocked.device)[:, None]
    cols = torch.arange(W, device=blocked.device)[None, :]
    inval = []
    for dx, dy, _w in _MOVES:
        border = ((rows + dx < 0) | (rows + dx >= H)
                  | (cols + dy < 0) | (cols + dy >= W))
        bad = border.expand(blocked.shape)
        if dx and dy:
            o1 = _shifted(blocked, dx, 0, True)
            o2 = _shifted(blocked, 0, dy, True)
            bad = bad | (o1 & o2)
        inval.append(bad)
    return inval


def _relax(dist0, blocked, inval, n_iters: int):
    """Early-exit Jacobi min-plus relaxation, the minimum grouped before
    the add (min(a, b) + w == min(a + w, b + w) exactly in f32), so the
    field is bit-identical to the add-then-min sweep of the JAX package's
    XLA path and to the kernels."""
    big = dist0.new_tensor(_BIG)
    one = dist0.new_tensor(1.0)
    sq2 = dist0.new_tensor(SQ2)
    d = dist0
    for _ in range(n_iters):
        ms = mo = None
        for (dx, dy, _w), bad in zip(_MOVES, inval):
            cand = torch.where(bad, big, _shifted(d, dx, dy, _BIG))
            if dx and dy:
                mo = cand if mo is None else torch.minimum(mo, cand)
            else:
                ms = cand if ms is None else torch.minimum(ms, cand)
        best = torch.minimum(d, torch.minimum(ms + one, mo + sq2))
        best = torch.where(blocked, big, best)
        changed = bool((best < d).any())
        d = best
        if not changed:
            break
    return d


def octile_distance_field_torch(blocked, goal_cell, n_iters: int | None = None):
    """Plain PyTorch version of the field kernel (K2): (B, H, W) float32
    octile distance to each lane's goal; _BIG where unreachable/blocked."""
    H, W = blocked.shape[-2:]
    n_iters = H + W if n_iters is None else n_iters
    return _relax(_dist0(blocked, goal_cell), blocked,
                  _invalid_masks(blocked), n_iters)


def _policy_flags(d, inval):
    """Greedy move (strict <, first min in _MOVES order) and the stuck /
    at-goal / disconnected flags, from a converged field."""
    big = d.new_tensor(_BIG)
    best_sc = best_mv = None
    for mi, ((dx, dy, w), bad) in enumerate(zip(_MOVES, inval)):
        cand = _shifted(d, dx, dy, _BIG) + d.new_tensor(w)
        cand = torch.where(bad, big, cand)
        if best_sc is None:
            best_sc = cand
            best_mv = torch.zeros(d.shape, dtype=torch.int32, device=d.device)
        else:
            take = cand < best_sc
            best_sc = torch.where(take, cand, best_sc)
            best_mv = torch.where(take, torch.full_like(best_mv, mi), best_mv)
    flags = (((best_sc >= big).to(torch.int32) << 3)
             | ((d <= 0.0).to(torch.int32) << 4)
             | ((d >= big).to(torch.int32) << 5))
    return best_mv, flags


def wavefront_packed_torch(blocked, goal_cell, n_iters: int | None = None):
    """Plain PyTorch version of the packed kernel (K1).

    Returns (dist (B, H, W) f32, packed (B, H, W) i32): move (bits 0-2) |
    stuck (3) | at_goal (4) | disconnected (5) | straight run length
    (bits 6+, min(true run, 16), by the JAX kernel's chain doubling).
    """
    H, W = blocked.shape[-2:]
    n_iters = H + W if n_iters is None else n_iters
    inval = _invalid_masks(blocked)
    d = _relax(_dist0(blocked, goal_cell), blocked, inval, n_iters)
    best_mv, flags = _policy_flags(d, inval)
    done_cell = flags != 0
    runlen = torch.zeros_like(d)
    for mi, (dx, dy, _w) in enumerate(_MOVES):
        L = ((best_mv == mi) & ~done_cell).to(torch.float32)
        span = 1
        while span < RUN_CAP:
            Ls = _shifted(L, dx * span, dy * span, 0.0)
            L = L + torch.where(L == float(span), Ls, torch.zeros_like(Ls))
            span *= 2
        runlen = torch.where(best_mv == mi, L, runlen)
    packed = best_mv | flags | (runlen.to(torch.int32) << 6)
    return d, packed


def octile_distance_field(blocked, goal_cell, n_iters: int | None = None,
                          impl: str = "auto"):
    """(B, H, W) octile distance to each lane's goal cell, in cells."""
    if _check_impl(impl, blocked) == "cuda":
        from .wavefront_cuda import octile_distance_field_cuda
        return octile_distance_field_cuda(blocked, goal_cell, n_iters)
    return octile_distance_field_torch(blocked, goal_cell, n_iters)


def _gather_cell(grid, ci, cj):
    B, H, W = grid.shape
    return torch.gather(grid.reshape(B, H * W), 1,
                        (ci * W + cj).to(torch.int64)[:, None])[:, 0]


def _move_tables(device):
    mdx = torch.tensor([m[0] for m in _MOVES], dtype=torch.int32,
                       device=device)
    mdy = torch.tensor([m[1] for m in _MOVES], dtype=torch.int32,
                       device=device)
    return mdx, mdy


def extract_path(dist, blocked, start_cell, max_len: int):
    """Per-cell greedy policy descent from each lane's start cell.

    Returns (cells (B, max_len + 1, 2) int32, valid (B, max_len + 1)
    bool); cells[:, 0] is the start, the final cell repeats once the goal
    is reached; a disconnected start leaves only the start valid.
    """
    best_mv, flags = _policy_flags(dist, _invalid_masks(blocked))
    packed = best_mv | flags
    mdx, mdy = _move_tables(dist.device)
    c = start_cell.to(torch.int32)
    ci, cj = c[:, 0], c[:, 1]
    done = (_gather_cell(packed, ci, cj) & (1 << 5)) != 0
    cells = [torch.stack([ci, cj], -1)]
    valid = [torch.ones_like(done)]
    for _ in range(max_len):
        v = _gather_cell(packed, ci, cj)
        mv = (v & 7).to(torch.int64)
        done = done | ((v & 0b11000) != 0)
        ci = torch.where(done, ci, ci + mdx[mv])
        cj = torch.where(done, cj, cj + mdy[mv])
        cells.append(torch.stack([ci, cj], -1))
        valid.append(~done)
    return torch.stack(cells, 1), torch.stack(valid, 1)


def extract_path_turns(packed, start_cell, max_len: int):
    """Turn-compressed greedy descent over a packed policy + flags + run
    length field: each loop trip jumps a whole straight run, so the trip
    count is the path's turn count.  Bit-identical (cells, valid) to
    `extract_path` on the same field.  Lanes that finish are frozen while
    the others go on, as the JAX while_loop does under vmap.
    """
    B, H, W = packed.shape
    dev = packed.device
    mdx, mdy = _move_tables(dev)
    start = start_cell.to(torch.int32)
    ci, cj = start[:, 0].clone(), start[:, 1].clone()
    idx = torch.arange(max_len + 1, dtype=torch.int32, device=dev)
    done = (_gather_cell(packed, ci, cj) & (1 << 5)) != 0
    p = (ci * W + cj)[:, None].expand(B, max_len + 1).clone()
    k0 = torch.zeros(B, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(k0)
    while True:
        active = ~done & (k0 < max_len)
        if not bool(active.any()):
            break
        v = _gather_cell(packed, ci, cj)
        ndone = done | ((v & 0b11000) != 0)
        mv = (v & 7).to(torch.int64)
        dx, dy = mdx[mv], mdy[mv]
        L = torch.where(ndone, zero, torch.minimum(v >> 6, max_len - k0))
        m = (idx > k0[:, None]) & (idx <= (k0 + L)[:, None])
        stride = dx * W + dy
        p_new = torch.where(m, (ci * W + cj)[:, None]
                            + (idx - k0[:, None]) * stride[:, None], p)
        a = active
        p = torch.where(a[:, None], p_new, p)
        ci = torch.where(a, ci + L * dx, ci)
        cj = torch.where(a, cj + L * dy, cj)
        k0 = torch.where(a, k0 + L, k0)
        done = torch.where(a, ndone, done)
    valid = idx[None, :] <= k0[:, None]
    p = torch.where(valid, p, (ci * W + cj)[:, None])
    return torch.stack([p // W, p % W], dim=-1), valid


def wavefront_path(blocked, goal_cell, start_cell, max_len: int,
                   impl: str = "auto"):
    """Field + path in one call: returns (dist, cells, valid).

    The packed field (kernel K1 on the card, its plain version on the
    CPU) feeds the turn-compressed descent `extract_path_turns`."""
    if _check_impl(impl, blocked) == "cuda":
        from .wavefront_cuda import wavefront_packed_cuda
        dist, packed = wavefront_packed_cuda(blocked, goal_cell)
    else:
        dist, packed = wavefront_packed_torch(blocked, goal_cell)
    cells, valid = extract_path_turns(packed, start_cell, max_len)
    return dist, cells, valid


def _trapezoid_duration(length, start_v, max_v, max_a):
    """evaluate_duration (jps_planner.cpp:378-397), end_v = 0."""
    sv = torch.clamp(start_v, max=max_v)
    sv2, mv2 = sv * sv, max_v * max_v
    critical = (mv2 - sv2) / (2 * max_a) + mv2 / (2 * max_a)
    t_long = ((max_v - start_v) / max_a + max_v / max_a
              + (length - critical) / max_v)
    tmpv = torch.sqrt(0.5 * (sv2 + 2 * max_a * length))
    t_short = (tmpv - start_v) / max_a + tmpv / max_a
    return torch.where(length >= critical, t_long, t_short)


def _trapezoid_length(curt, locallength, start_v, max_v, max_a):
    """evaluate_length (jps_planner.cpp:403-441), end_v = 0."""
    sv = torch.clamp(start_v, max=max_v)
    sv2, mv2 = sv * sv, max_v * max_v
    critical = (mv2 - sv2) / (2 * max_a) + mv2 / (2 * max_a)
    t1 = (max_v - start_v) / max_a
    t2 = t1 + (locallength - critical) / max_v
    s_acc = start_v * curt + 0.5 * max_a * curt * curt
    s_t1 = start_v * t1 + 0.5 * max_a * t1 * t1
    long_val = torch.where(
        curt <= t1, s_acc,
        torch.where(curt <= t2, s_t1 + (curt - t1) * max_v,
                    s_t1 + (t2 - t1) * max_v + max_v * (curt - t2)
                    - 0.5 * max_a * (curt - t2) ** 2))
    tmpv = torch.sqrt(0.5 * (sv2 + 2 * max_a * locallength))
    tmpt = (tmpv - start_v) / max_a
    short_val = torch.where(
        curt <= tmpt, s_acc,
        start_v * tmpt + 0.5 * max_a * tmpt * tmpt
        + tmpv * (curt - tmpt) - 0.5 * max_a * (curt - tmpt) ** 2)
    return torch.where(locallength >= critical, long_val, short_val)
