"""Plain MINCO splines, their flat-output flow and an ESDF, in any dtype.

The reference for the benchmark's `correct`: straightforward PyTorch
written from the planner's equations, sharing no code with the program.
Every function takes the working dtype from its inputs, so the same code
runs as the float64 reference and as the bfloat16 control.

Flat output sigma(t) = (yaw(t), s(t)), one quintic per piece, ascending
powers: coeffs (B, N, 6, 2), times (B, N).  The ICR flow is

    xdot = sdot cos(yaw) + yawdot xv sin(yaw)
    ydot = sdot sin(yaw) - yawdot xv cos(yaw)
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch


def gauss_solve(A, b):
    """x with A x = b by Gaussian elimination with partial pivoting;
    A (B, n, n), b (B, n, k).  Written out, without updates in place,
    so that it runs and differentiates in bfloat16."""
    B, n = A.shape[0], A.shape[-1]
    lanes = torch.arange(B, device=A.device)
    for k in range(n):
        p = torch.argmax(A[:, k:, k].abs(), dim=1) + k
        perm = torch.arange(n, device=A.device).repeat(B, 1)
        perm[lanes, k] = p
        perm[lanes, p] = k
        A = torch.gather(A, 1, perm[..., None].expand(B, n, n))
        b = torch.gather(b, 1, perm[..., None].expand(B, n, b.shape[-1]))
        f = A[:, k + 1:, k] / A[:, k, k][:, None]
        A = torch.cat([A[:, :k + 1], A[:, k + 1:] - f[..., None]
                       * A[:, k:k + 1]], 1)
        b = torch.cat([b[:, :k + 1], b[:, k + 1:] - f[..., None]
                       * b[:, k:k + 1]], 1)
    xs = []
    for k in range(n - 1, -1, -1):
        r = b[:, k]
        if xs:
            r = r - torch.sum(A[:, k, k + 1:, None]
                              * torch.stack(xs[::-1], 1), 1)
        xs.append(r / A[:, k, k][:, None])
    return torch.stack(xs[::-1], 1)


_FACT = [math.factorial(k) for k in range(6)]
# d^r/dt^r of t^k = COEF[r, k] t^POW[r, k]
_COEF = [[_FACT[k] / _FACT[k - r] if k >= r else 0.0 for k in range(6)]
         for r in range(6)]
_POW = [[max(k - r, 0) for k in range(6)] for r in range(6)]
_LAYOUT = {}


def _layout(N):
    """Where each entry of the 6N conditions goes: (rows, cols, sources)
    into the values [derivative blocks of the N pieces at their ends,
    -D(0), D(0)], and the rows of the right-hand side."""
    if N not in _LAYOUT:
        rows, cols, src = [], [], []
        neg0, pos0 = 36 * N, 36 * N + 36

        def put(row, piece, r, base):
            for k in range(6):
                rows.append(row)
                cols.append(6 * piece + k)
                src.append(base + 6 * r + k)
        for d in range(3):                       # the head
            put(d, 0, d, pos0)
        row = 3
        for i in range(N - 1):                   # waypoint, continuity
            put(row, i, 0, 36 * i)
            for d in range(5):
                put(row + 1 + d, i, d, 36 * i)
                put(row + 1 + d, i + 1, d, neg0)
            row += 6
        for d in range(3):                       # the tail
            put(row + d, N - 1, d, 36 * (N - 1))
        rhs_rows = [0, 1, 2] + [3 + 6 * i for i in range(N - 1)] + \
            [6 * N - 3, 6 * N - 2, 6 * N - 1]
        _LAYOUT[N] = tuple(torch.tensor(v) for v in (rows, cols, src,
                                                     rhs_rows))
    return _LAYOUT[N]


def minco_coeffs(head, tail, inner, times):
    """The minimum-jerk quintic spline through the inner points.

    head, tail (B, 2, 3): (position, velocity, acceleration) of (yaw, s)
    at the ends; inner (B, 2, N-1) waypoints; times (B, N).  The 6N
    conditions: the head's three, at each joint the waypoint and the
    continuity of derivatives 0-4, the tail's three.  Solved by LU in
    float32 and float64, by `gauss_solve` below them."""
    B, N = times.shape
    dt = times.dtype
    coef = torch.tensor(_COEF, dtype=dt, device=times.device)
    pw = torch.tensor(_POW, dtype=dt, device=times.device)
    ends = coef * times[..., None, None] ** pw            # (B, N, 6, 6)
    d0 = coef * torch.zeros((), dtype=dt, device=times.device) ** pw
    vals = torch.cat([ends.reshape(B, -1), (-d0).reshape(1, -1).expand(B, 36),
                      d0.reshape(1, -1).expand(B, 36)], 1)
    rows, cols, src, rhs_rows = (t.to(times.device) for t in _layout(N))
    lanes = torch.arange(B, device=times.device)[:, None]
    A = times.new_zeros((B, 6 * N, 6 * N)).index_put(
        (lanes, rows[None], cols[None]), vals[:, src])
    rhs = times.new_zeros((B, 6 * N, 2)).index_put(
        (lanes, rhs_rows[None]),
        torch.cat([head.transpose(1, 2), inner.transpose(1, 2),
                   tail.transpose(1, 2)], 1))
    if dt in (torch.float32, torch.float64):
        c = torch.linalg.solve(A, rhs)
    else:
        c = gauss_solve(A, rhs)
    return c.reshape(B, N, 6, 2)


def eval_local(coeffs, tau, order):
    """Pieces coeffs (..., 6, 2) at local times tau (...) -> (..., 2)."""
    out = torch.zeros(coeffs.shape[:-2] + (2,), dtype=coeffs.dtype,
                      device=coeffs.device)
    for k in range(order, 6):
        c = math.factorial(k) / math.factorial(k - order)
        out = out + (c * tau ** (k - order))[..., None] * coeffs[..., k, :]
    return out


def locate(times, t):
    """Global times t (B, M), clamped to the trajectory -> (piece index,
    local time): the first piece whose end lies beyond t."""
    ends = torch.cumsum(times, -1)
    t = torch.minimum(torch.clamp(t, min=0.0), ends[:, -1:])
    idx = torch.sum(ends[:, None, :] <= t[..., None], -1)
    idx = torch.clamp(idx, max=times.shape[1] - 1)
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    return idx, t - torch.gather(starts, 1, idx)


def eval_global(coeffs, times, t, order):
    """sigma^(order) at global times t (B, M) -> (B, M, 2)."""
    idx, tau = locate(times, t)
    c = torch.gather(coeffs, 1, idx[..., None, None].expand(
        *idx.shape, 6, 2))
    return eval_local(c, tau, order)


def flow_velocity(sig, dsig, xv):
    yaw, dyaw, ds = sig[..., 0], dsig[..., 0], dsig[..., 1]
    c, s = torch.cos(yaw), torch.sin(yaw)
    return ds * c + dyaw * xv * s, ds * s - dyaw * xv * c


def simpson_nodes(coeffs, times, start_xy, xv, n_sub):
    """The flow integrated with composite Simpson, n_sub panels a piece
    (the planner's own quadrature): world XY at the panel ends,
    (B, N, n_sub + 1, 2), and at the end of the trajectory (B, 2).
    xv a float or (B,)."""
    B, N = times.shape
    frac = torch.arange(2 * n_sub + 1, dtype=times.dtype,
                        device=times.device) / (2 * n_sub)
    tau = times[..., None] * frac                         # (B, N, 2n+1)
    c = coeffs[:, :, None].expand(B, N, tau.shape[-1], 6, 2)
    xv = torch.as_tensor(xv, dtype=times.dtype, device=times.device)
    xv = xv.reshape(-1, 1, 1) if xv.dim() == 1 else xv
    gx, gy = flow_velocity(eval_local(c, tau, 0), eval_local(c, tau, 1), xv)
    w = (times / (6.0 * n_sub))[..., None]
    incx = w * (gx[..., 0:-1:2] + 4 * gx[..., 1::2] + gx[..., 2::2])
    incy = w * (gy[..., 0:-1:2] + 4 * gy[..., 1::2] + gy[..., 2::2])
    inc = torch.stack([incx, incy], -1).reshape(B, N * n_sub, 2)
    cum = torch.cat([torch.zeros_like(inc[:, :1]), torch.cumsum(inc, 1)], 1)
    xy = start_xy[:, None, :] + cum                       # (B, N n + 1, 2)
    j = (torch.arange(N, device=times.device)[:, None] * n_sub
         + torch.arange(n_sub + 1, device=times.device)[None, :])
    return xy[:, j], xy[:, -1]


# Gauss-Legendre nodes and weights on [0, 1], 8 points
_GL_X, _GL_W = np.polynomial.legendre.leggauss(8)
_GL_X, _GL_W = (_GL_X + 1.0) / 2.0, _GL_W / 2.0


def _gl_integral(coeffs_sel, t0, t1, xv, n_panels):
    """The flow's integral over [t0, t1] (local times of the pieces
    coeffs_sel (..., 6, 2)), n_panels Gauss-Legendre panels -> (..., 2)."""
    x = torch.as_tensor(_GL_X, dtype=t0.dtype, device=t0.device)
    w = torch.as_tensor(_GL_W, dtype=t0.dtype, device=t0.device)
    h = (t1 - t0) / n_panels
    k = torch.arange(n_panels, dtype=t0.dtype, device=t0.device)
    tau = (t0[..., None, None] + h[..., None, None]
           * (k[:, None] + x[None, :]))                  # (..., P, 8)
    c = coeffs_sel[..., None, None, :, :].expand(*tau.shape, 6, 2)
    gx, gy = flow_velocity(eval_local(c, tau, 0), eval_local(c, tau, 1),
                           xv[..., None, None])
    ix = h * torch.sum(w * gx, dim=(-2, -1))
    iy = h * torch.sum(w * gy, dim=(-2, -1))
    return torch.stack([ix, iy], -1)


class WorldTraj:
    """A Polynome as the controller reads it: the spline of its flat
    outputs and the world pose at any time, the flow integrated to
    rounding (Gauss-Legendre, 8 x 8 points a piece)."""

    def __init__(self, init_state, tail_state, inner, times, start_xy, icr,
                 panels: int = 8):
        self.coeffs = minco_coeffs(init_state, tail_state, inner, times)
        self.times = times
        self.start_xy = start_xy                         # (B, 2)
        self.icr = icr                                   # (B, 3) yr, yl, xv
        self.duration = torch.sum(times, -1)
        self.panels = panels
        zero = torch.zeros_like(times)
        inc = _gl_integral(self.coeffs, zero, times, icr[:, 2:3], panels)
        self.piece_start_xy = start_xy[:, None] + torch.cat(
            [torch.zeros_like(inc[:, :1]), torch.cumsum(inc, 1)[:, :-1]], 1)

    def to(self, dtype, device):
        """This route read in another dtype and place, not solved again."""
        out = copy.copy(self)
        for name in ("coeffs", "times", "start_xy", "icr", "duration",
                     "piece_start_xy"):
            setattr(out, name, getattr(self, name).to(dtype=dtype,
                                                      device=device))
        return out

    def pose(self, t):
        """World (x, y, yaw) at global times t (B, M) -> (B, M, 3)."""
        idx, tau = locate(self.times, t)
        c = torch.gather(self.coeffs, 1, idx[..., None, None].expand(
            *idx.shape, 6, 2))
        base = torch.gather(self.piece_start_xy, 1,
                            idx[..., None].expand(*idx.shape, 2))
        xv = self.icr[:, 2:3].expand(idx.shape)
        xy = base + _gl_integral(c, torch.zeros_like(tau), tau, xv,
                                 self.panels)
        yaw = eval_local(c, tau, 0)[..., 0]
        return torch.cat([xy, yaw[..., None]], -1)

    def flat_velocity(self, t):
        """(yawdot, sdot) at global times t (B, M) -> (B, M, 2)."""
        return eval_global(self.coeffs, self.times, t, 1)


# ---------------------------------------------------------------------------
# distance field
# ---------------------------------------------------------------------------

def esdf(occ, res, dtype):
    """Signed distance of every cell centre (H, W), in meters: the
    distance to the nearest occupied centre where free; where occupied,
    res minus the distance to the nearest free centre.  occ: numpy bool.
    Brute force over the source cells."""
    H, W = occ.shape
    ij = np.stack(np.meshgrid(np.arange(H), np.arange(W), indexing="ij"),
                  -1).reshape(-1, 2).astype(np.float64)

    def nearest(mask):
        src = ij[mask.reshape(-1)]
        if len(src) == 0:
            return np.zeros(H * W)
        d2 = ((ij[:, None, :] - src[None, :, :]) ** 2).sum(-1)
        return np.sqrt(d2.min(1))

    d_out = nearest(occ)
    d_in = nearest(~occ)
    d = np.where(occ.reshape(-1), res - res * d_in, res * d_out)
    return torch.as_tensor(d.reshape(H, W), dtype=dtype)


def bilinear(dist, lower, res, pts, out_value=1e10):
    """The field between cell centres at world points pts (..., 2); a
    point off the map, or in its last row or column of cells, reads
    out_value."""
    H, W = dist.shape
    p = (pts - torch.as_tensor(lower, dtype=pts.dtype,
                               device=pts.device)) / res - 0.5
    i0 = torch.floor(p).to(torch.int64)
    ix = torch.clamp(i0[..., 0], 0, H - 1)
    iy = torch.clamp(i0[..., 1], 0, W - 1)
    fx = p[..., 0] - ix.to(p.dtype)
    fy = p[..., 1] - iy.to(p.dtype)
    ix1 = torch.clamp(ix + 1, max=H - 1)
    iy1 = torch.clamp(iy + 1, max=W - 1)
    d = dist.to(pts.device)
    v = ((1 - fx) * (1 - fy) * d[ix, iy] + fx * (1 - fy) * d[ix1, iy]
         + (1 - fx) * fy * d[ix, iy1] + fx * fy * d[ix1, iy1])
    lo = torch.as_tensor(lower, dtype=pts.dtype, device=pts.device)
    hi = lo + torch.tensor([H * res, W * res], dtype=pts.dtype,
                           device=pts.device)
    inside = torch.all((pts >= lo) & (pts <= hi), -1)
    inside = inside & (ix < H - 1) & (iy < W - 1)
    return torch.where(inside, v, torch.full_like(v, out_value))
