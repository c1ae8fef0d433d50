"""MINCO quintic (s=3) spline with non-uniform times (port of
solvers/minco.py).

Each piece is parameterized by its endpoint states (p, v, a); the only
unknowns are (v_j, a_j) at the N-1 interior joints, fixed by jerk and
snap continuity: a 2(N-1) x 2(N-1) block-tridiagonal system.  Below
CR_MIN_JOINTS interior joints it is solved densely (SMALL_N_SOLVER
"lu"; `set_small_n_solver` switches to block Thomas elimination or
cyclic reduction); from CR_MIN_JOINTS on by block cyclic reduction, at
logarithmic depth in the horizon.  The closed-form quintic Hermite map
then gives the monomial coefficients.  `minco_coeffs_dense` solves the
reference's full 6N x 6N system and is kept for parity tests.

Gradients w.r.t. inner points, tail state and times come from autograd
through the solve; no solver writes into a tensor the backward pass
needs.  Batched over a leading lane axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.poly import PolyTraj

NCOEF = 6


class MincoProblem(NamedTuple):
    """Boundary conditions for a MINCO_S3NU spline (2 flat outputs)."""

    head: torch.Tensor  # (B, 2, 3) columns: pos, vel, acc (minco.hpp:772)
    tail: torch.Tensor  # (B, 2, 3)
    energy_weights: torch.Tensor  # (2,) diag weights (theta, s)


def _time_powers(times):
    t1 = times
    t2 = t1 * t1
    t3 = t2 * t1
    t4 = t2 * t2
    t5 = t4 * t1
    return t1, t2, t3, t4, t5


def minco_system(head, tail, inner, times):
    """Assemble the 6N x 6N MINCO linear system A c = b, batched:
    A (B, 6N, 6N), b (B, 6N, 2).

    Row layout matches minco.hpp:829-892 exactly:
      rows 0..2                 : head pos/vel/acc at t=0
      per interior joint i (0..N-2), rows 6i+3..6i+8:
        jerk continuity, snap continuity, waypoint position,
        pos/vel/acc continuity
      rows 6N-3..6N-1           : tail pos/vel/acc at t=T_{N-1}
    """
    nb, n = times.shape
    t1, t2, t3, t4, t5 = _time_powers(times)
    A = times.new_zeros((nb, 6 * n, 6 * n))
    b = times.new_zeros((nb, 6 * n, 2))

    A[:, 0, 0] = 1.0
    A[:, 1, 1] = 1.0
    A[:, 2, 2] = 2.0
    b[:, 0:3] = head.transpose(1, 2)

    if n > 1:
        r = 6 * torch.arange(n - 1, device=times.device)
        T1, T2, T3, T4, T5 = (t[:, :-1] for t in (t1, t2, t3, t4, t5))
        # jerk continuity: 6 c3 + 24 T c4 + 60 T^2 c5 - 6 c3'
        A[:, r + 3, r + 3] = 6.0
        A[:, r + 3, r + 4] = 24.0 * T1
        A[:, r + 3, r + 5] = 60.0 * T2
        A[:, r + 3, r + 9] = -6.0
        # snap continuity: 24 c4 + 120 T c5 - 24 c4'
        A[:, r + 4, r + 4] = 24.0
        A[:, r + 4, r + 5] = 120.0 * T1
        A[:, r + 4, r + 10] = -24.0
        # waypoint position, then position continuity
        for row in (5, 6):
            A[:, r + row, r + 0] = 1.0
            A[:, r + row, r + 1] = T1
            A[:, r + row, r + 2] = T2
            A[:, r + row, r + 3] = T3
            A[:, r + row, r + 4] = T4
            A[:, r + row, r + 5] = T5
        b[:, r + 5] = inner.transpose(1, 2)
        A[:, r + 6, r + 6] = -1.0
        # velocity continuity
        A[:, r + 7, r + 1] = 1.0
        A[:, r + 7, r + 2] = 2.0 * T1
        A[:, r + 7, r + 3] = 3.0 * T2
        A[:, r + 7, r + 4] = 4.0 * T3
        A[:, r + 7, r + 5] = 5.0 * T4
        A[:, r + 7, r + 7] = -1.0
        # acceleration continuity
        A[:, r + 8, r + 2] = 2.0
        A[:, r + 8, r + 3] = 6.0 * T1
        A[:, r + 8, r + 4] = 12.0 * T2
        A[:, r + 8, r + 5] = 20.0 * T3
        A[:, r + 8, r + 8] = -2.0

    # tail conditions at T_{N-1}
    m = 6 * n
    e1, e2, e3, e4, e5 = (t[:, -1] for t in (t1, t2, t3, t4, t5))
    A[:, m - 3, m - 6] = 1.0
    A[:, m - 3, m - 5] = e1
    A[:, m - 3, m - 4] = e2
    A[:, m - 3, m - 3] = e3
    A[:, m - 3, m - 2] = e4
    A[:, m - 3, m - 1] = e5
    A[:, m - 2, m - 5] = 1.0
    A[:, m - 2, m - 4] = 2.0 * e1
    A[:, m - 2, m - 3] = 3.0 * e2
    A[:, m - 2, m - 2] = 4.0 * e3
    A[:, m - 2, m - 1] = 5.0 * e4
    A[:, m - 1, m - 4] = 2.0
    A[:, m - 1, m - 3] = 6.0 * e1
    A[:, m - 1, m - 2] = 12.0 * e2
    A[:, m - 1, m - 1] = 20.0 * e3
    b[:, m - 3:] = tail.transpose(1, 2)
    return A, b


def minco_coeffs_dense(head, tail, inner, times):
    """Reference-layout solve of the full 6N x 6N system; the structural
    twin of minco.hpp:829-892, kept for parity tests (minco_coeffs gives
    the same spline from a ~13x smaller system)."""
    nb, n = times.shape
    A, b = minco_system(head, tail, inner, times)
    c, _ = torch.linalg.solve_ex(A, b)
    return c.reshape(nb, n, NCOEF, 2)


def _hermite_to_monomial(p0, v0, a0, p1, v1, a1, T):
    """Quintic Hermite -> ascending monomial coefficients.

    All args (..., D); T (...,).  Returns (..., 6, D)."""
    T = T[..., None]
    dp = p1 - p0
    T2 = T * T
    T3 = T2 * T
    c0 = p0
    c1 = v0
    c2 = 0.5 * a0
    c3 = (20.0 * dp - (8.0 * v1 + 12.0 * v0) * T
          - (3.0 * a0 - a1) * T2) / (2.0 * T3)
    c4 = (-30.0 * dp + (14.0 * v1 + 16.0 * v0) * T
          + (3.0 * a0 - 2.0 * a1) * T2) / (2.0 * T3 * T)
    c5 = (12.0 * dp - 6.0 * (v1 + v0) * T
          + (a1 - a0) * T2) / (2.0 * T3 * T2)
    return torch.stack([c0, c1, c2, c3, c4, c5], dim=-2)


def _reduced_system(head, tail, inner, times):
    """Assemble the batched 2(N-1) x 2(N-1) jerk/snap continuity system.

    head/tail (B, 2, 3) columns (pos, vel, acc); inner (B, 2, N-1);
    times (B, N).  Returns (A (B, 2m, 2m), b (B, 2m, 2), p (B, N+1, 2));
    unknowns interleaved [v_1, a_1, v_2, a_2, ...].
    """
    n = times.shape[-1]
    B = times.shape[0]
    p = torch.cat([head[:, None, :, 0], inner.transpose(1, 2),
                   tail[:, None, :, 0]], dim=1)           # (B, N+1, 2)
    dp = p[:, 1:] - p[:, :-1]

    L = times[:, :-1]
    R = times[:, 1:]
    Li = 1.0 / L
    Ri = 1.0 / R
    Li2, Ri2 = Li * Li, Ri * Ri
    Li3, Ri3 = Li2 * Li, Ri2 * Ri
    dpL = dp[:, :-1]
    dpR = dp[:, 1:]

    m = n - 1
    A = times.new_zeros((B, 2 * m, 2 * m))
    j = torch.arange(m, device=times.device)
    rj, rs = 2 * j, 2 * j + 1
    cv, ca = 2 * j, 2 * j + 1

    A[:, rj, cv] = 36.0 * Ri2 - 36.0 * Li2
    A[:, rj, ca] = 9.0 * Li + 9.0 * Ri
    A[:, rj[1:], cv[:-1]] = -24.0 * Li2[:, 1:]
    A[:, rj[1:], ca[:-1]] = -3.0 * Li[:, 1:]
    A[:, rj[:-1], cv[1:]] = 24.0 * Ri2[:, :-1]
    A[:, rj[:-1], ca[1:]] = -3.0 * Ri[:, :-1]
    rhs_j = -60.0 * dpL * Li3[..., None] + 60.0 * dpR * Ri3[..., None]

    A[:, rs, cv] = -192.0 * Li3 - 192.0 * Ri3
    A[:, rs, ca] = 36.0 * Li2 - 36.0 * Ri2
    A[:, rs[1:], cv[:-1]] = -168.0 * Li3[:, 1:]
    A[:, rs[1:], ca[:-1]] = -24.0 * Li2[:, 1:]
    A[:, rs[:-1], cv[1:]] = -168.0 * Ri3[:, :-1]
    A[:, rs[:-1], ca[1:]] = 24.0 * Ri2[:, :-1]
    rhs_s = -360.0 * dpL * (Li3 * Li)[..., None] \
        - 360.0 * dpR * (Ri3 * Ri)[..., None]

    rhs_j, rhs_s = _boundary_rhs(rhs_j, rhs_s, head, tail, Li, Li2, Li3,
                                 Ri, Ri2, Ri3)
    b = torch.stack([rhs_j, rhs_s], dim=2).reshape(B, 2 * m, 2)
    return A, b, p


def _boundary_rhs(rhs_j, rhs_s, head, tail, Li, Li2, Li3, Ri, Ri2, Ri3):
    """Move the boundary knowns (v_0, a_0) and (v_N, a_N) to the RHS of
    the first and last joint's rows."""
    m = rhs_j.shape[1]
    first_j = 24.0 * Li2[:, :1] * head[:, :, 1] + 3.0 * Li[:, :1] * head[:, :, 2]
    first_s = 168.0 * Li3[:, :1] * head[:, :, 1] + 24.0 * Li2[:, :1] * head[:, :, 2]
    last_j = -24.0 * Ri2[:, -1:] * tail[:, :, 1] + 3.0 * Ri[:, -1:] * tail[:, :, 2]
    last_s = 168.0 * Ri3[:, -1:] * tail[:, :, 1] - 24.0 * Ri2[:, -1:] * tail[:, :, 2]
    if m == 1:
        return (rhs_j + (first_j + last_j)[:, None],
                rhs_s + (first_s + last_s)[:, None])
    mid = [torch.zeros_like(rhs_j[:, :1])] * (m - 2)
    return (rhs_j + torch.cat([first_j[:, None], *mid, last_j[:, None]], 1),
            rhs_s + torch.cat([first_s[:, None], *mid, last_s[:, None]], 1))


# number of interior joints at which the cyclic-reduction path takes
# over from the small dense solve
CR_MIN_JOINTS = 16

# small-N (m < CR_MIN_JOINTS) solver: "lu" (default), "thomas_scan" or
# "cr".  Read at every call of minco_coeffs.
SMALL_N_SOLVER = "lu"


def set_small_n_solver(mode: str):
    """Select the small-N spline solve of later minco_coeffs calls.
    Returns the previous mode (restore it afterwards)."""
    global SMALL_N_SOLVER
    if mode not in ("lu", "thomas_scan", "cr"):
        raise ValueError(f"unknown small-N solver {mode!r}")
    prev = SMALL_N_SOLVER
    SMALL_N_SOLVER = mode
    return prev


def _reduced_blocks(head, tail, inner, times):
    """The jerk/snap continuity system in block-tridiagonal form.

    Returns (D, L, U, rhs, p): diagonal/sub/super 2x2 blocks of shape
    (B, m, 2, 2) (L[:, 0] and U[:, m-1] are zero: their couplings are the
    known head/tail states, already folded into rhs), rhs (B, m, 2, 2)
    and the (B, N+1, 2) joint positions.  Same equations as
    _reduced_system.
    """
    p = torch.cat([head[:, None, :, 0], inner.transpose(1, 2),
                   tail[:, None, :, 0]], dim=1)
    dp = p[:, 1:] - p[:, :-1]
    Li = 1.0 / times[:, :-1]
    Ri = 1.0 / times[:, 1:]
    Li2, Ri2 = Li * Li, Ri * Ri
    Li3, Ri3 = Li2 * Li, Ri2 * Ri
    dpL = dp[:, :-1]
    dpR = dp[:, 1:]
    m = times.shape[-1] - 1

    def blocks(a, b, c, d):
        return torch.stack([torch.stack([a, b], -1),
                            torch.stack([c, d], -1)], -2)     # (B, m, 2, 2)

    D = blocks(36.0 * Ri2 - 36.0 * Li2, 9.0 * Li + 9.0 * Ri,
               -192.0 * Li3 - 192.0 * Ri3, 36.0 * Li2 - 36.0 * Ri2)
    Lb = blocks(-24.0 * Li2, -3.0 * Li, -168.0 * Li3, -24.0 * Li2)
    Ub = blocks(24.0 * Ri2, -3.0 * Ri, -168.0 * Ri3, 24.0 * Ri2)
    j = torch.arange(m, device=times.device)
    Lb = Lb * (j > 0).to(times.dtype)[:, None, None]
    Ub = Ub * (j < m - 1).to(times.dtype)[:, None, None]

    rhs_j = -60.0 * dpL * Li3[..., None] + 60.0 * dpR * Ri3[..., None]
    rhs_s = -360.0 * dpL * (Li3 * Li)[..., None] \
        - 360.0 * dpR * (Ri3 * Ri)[..., None]
    rhs_j, rhs_s = _boundary_rhs(rhs_j, rhs_s, head, tail, Li, Li2, Li3,
                                 Ri, Ri2, Ri3)
    return D, Lb, Ub, torch.stack([rhs_j, rhs_s], -2), p


def _inv2(M):
    """Batched closed-form 2x2 inverse."""
    a = M[..., 0, 0]
    b = M[..., 0, 1]
    c = M[..., 1, 0]
    d = M[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) > 1e-300, det,
                      torch.sign(det) * 1e-300 + (det == 0) * 1e-300)
    inv = torch.stack([torch.stack([d, -b], -1),
                       torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def solve_block_tridiag_thomas(D, L, U, b):
    """Block Thomas elimination (no pivoting).

    D, L, U: (B, m, k, k) diagonal / sub / super blocks (L[:, 0] and
    U[:, m-1] ignored); b: (B, m, k, nrhs); k = 2.  No pivoting for the
    same reason the reference's banded LU has none (minco.hpp:99-199):
    the continuity system is block diagonally dominant for positive
    piece times.
    """
    m = D.shape[1]
    Dp = [D[:, 0]]
    bp = [b[:, 0]]
    for i in range(1, m):
        W = L[:, i] @ _inv2(Dp[i - 1])
        Dp.append(D[:, i] - W @ U[:, i - 1])
        bp.append(b[:, i] - W @ bp[i - 1])
    xs = [None] * m
    xs[m - 1] = _inv2(Dp[m - 1]) @ bp[m - 1]
    for i in range(m - 2, -1, -1):
        xs[i] = _inv2(Dp[i]) @ (bp[i] - U[:, i] @ xs[i + 1])
    return torch.stack(xs, 1)


def solve_block_tridiag_thomas_scan(D, L, U, b):
    """The JAX package's scan-shaped block Thomas elimination.  It
    differs from solve_block_tridiag_thomas only in how the loop is
    traced there; run eagerly, the two are one elimination."""
    return solve_block_tridiag_thomas(D, L, U, b)


def solve_block_tridiag_cr(D, L, U, b):
    """Block cyclic reduction for a block-tridiagonal system.

    D, L, U: (B, m, k, k) diagonal / sub / super blocks (L[:, 0] and
    U[:, m-1] ignored); b: (B, m, k, nrhs).  Returns x (B, m, k, nrhs).

    Each reduction level eliminates all odd blocks at once as batched
    k x k products, so the solve has O(log m) dependent levels where the
    reference's banded LU (minco.hpp:99-199) has 6N sequential rows.  No
    pivoting; the MINCO continuity blocks are far from singular at
    physical piece times.  Differentiable: every level builds new
    tensors.
    """
    nb, m, k, _ = D.shape
    nrhs = b.shape[-1]
    # pad to 2^ceil(log2(m)) with decoupled identity blocks
    m2 = 1
    while m2 < m:
        m2 *= 2
    pad = m2 - m
    if pad:
        eye = torch.eye(k, dtype=D.dtype, device=D.device).expand(
            nb, pad, k, k)
        zero = torch.zeros_like(eye)
        D = torch.cat([D, eye], 1)
        L = torch.cat([L, zero], 1)
        U = torch.cat([U, zero], 1)
        b = torch.cat([b, b.new_zeros((nb, pad, k, nrhs))], 1)

    def inv(M):
        return _inv2(M) if k == 2 else torch.linalg.inv(M)

    levels = []
    while D.shape[1] > 1:
        De, Le, Ue, be = D[:, 0::2], L[:, 0::2], U[:, 0::2], b[:, 0::2]
        Do, Lo, Uo, bo = D[:, 1::2], L[:, 1::2], U[:, 1::2], b[:, 1::2]
        levels.append((Lo, Uo, bo, inv(Do)))
        Doi = levels[-1][3]
        # even block j sits between odd[j-1] (below) and odd[j] (above);
        # the first even block has no odd below it: its L is zero, and a
        # zero block stands in for the missing neighbour
        def below(t):
            return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], 1)
        Le = torch.cat([torch.zeros_like(Le[:, :1]), Le[:, 1:]], 1)
        LDb = Le @ below(Doi)
        UDo = Ue @ Doi
        D_new = De - LDb @ below(Uo) - UDo @ Lo
        L_new = -(LDb @ below(Lo))
        U_new = -(UDo @ Uo)
        b_new = be - LDb @ below(bo) - UDo @ bo
        D, L, U, b = D_new, L_new, U_new, b_new

    x = inv(D) @ b                                   # (B, 1, k, nrhs)

    for Lo, Uo, bo, Doi in reversed(levels):
        # odd j sits between even j and even j+1 (x_e[j], x_e[j+1])
        xe = x
        xe_above = torch.cat([xe[:, 1:], torch.zeros_like(xe[:, :1])], 1)
        xo = Doi @ (bo - Lo @ xe - Uo @ xe_above)
        x = torch.stack([xe, xo], 2).reshape(nb, 2 * xe.shape[1], k, nrhs)
    return x[:, :m]


def minco_coeffs(head, tail, inner, times):
    """Piece coefficients (B, N, 6, 2), ascending powers.

    head/tail (B, 2, 3); inner (B, 2, N-1); times (B, N).
    """
    n = times.shape[-1]
    if n == 1:
        return _hermite_to_monomial(
            head[:, None, :, 0], head[:, None, :, 1], head[:, None, :, 2],
            tail[:, None, :, 0], tail[:, None, :, 1], tail[:, None, :, 2],
            times)
    if n - 1 >= CR_MIN_JOINTS or SMALL_N_SOLVER != "lu":
        D, L, U, rhs, p = _reduced_blocks(head, tail, inner, times)
        if n - 1 >= CR_MIN_JOINTS or SMALL_N_SOLVER == "cr":
            u = solve_block_tridiag_cr(D, L, U, rhs)       # (B, m, 2, 2)
        else:
            u = solve_block_tridiag_thomas_scan(D, L, U, rhs)
    else:
        A, b, p = _reduced_system(head, tail, inner, times)
        # dense LU with partial pivoting, as jnp.linalg.solve; solve_ex
        # does not synchronize with the host to check for singular lanes
        u2, _ = torch.linalg.solve_ex(A, b)
        u = u2.reshape(times.shape[0], n - 1, 2, 2)    # (B, m, [v, a], D)
    v = torch.cat([head[:, None, :, 1], u[:, :, 0], tail[:, None, :, 1]], 1)
    a = torch.cat([head[:, None, :, 2], u[:, :, 1], tail[:, None, :, 2]], 1)
    return _hermite_to_monomial(p[:, :-1], v[:, :-1], a[:, :-1],
                                p[:, 1:], v[:, 1:], a[:, 1:], times)


def minco_traj(head, tail, inner, times) -> PolyTraj:
    return PolyTraj(coeffs=minco_coeffs(head, tail, inner, times),
                    times=times)


def minco_energy(coeffs, times, weights):
    """Weighted jerk energy integral, (B,); closed form of
    minco.hpp:915-932.  weights: (2,) diagonal (theta, s) weights."""
    c3 = coeffs[..., 3, :]
    c4 = coeffs[..., 4, :]
    c5 = coeffs[..., 5, :]
    t1, t2, t3, t4, t5 = _time_powers(times)

    def wdot(a, bb):
        return torch.sum(a * weights * bb, dim=-1)

    e = (36.0 * wdot(c3, c3) * t1
         + 144.0 * wdot(c4, c3) * t2
         + 192.0 * wdot(c4, c4) * t3
         + 240.0 * wdot(c5, c3) * t3
         + 720.0 * wdot(c5, c4) * t4
         + 720.0 * wdot(c5, c5) * t5)
    return torch.sum(e, dim=-1)
