"""MINCO quintic (s=3) spline with non-uniform times (port of
solvers/minco.py, small-N path).

Each piece is parameterized by its endpoint states (p, v, a); the only
unknowns are (v_j, a_j) at the N-1 interior joints, fixed by jerk and
snap continuity: a 2(N-1) x 2(N-1) system solved densely (the JAX
package's default SMALL_N_SOLVER="lu" below CR_MIN_JOINTS), then the
closed-form quintic Hermite map gives the monomial coefficients.
Gradients w.r.t. inner points, tail state and times come from autograd
through the solve.  Batched over a leading lane axis.
"""
from __future__ import annotations

import torch

NCOEF = 6
# the JAX package switches to block cyclic reduction from this many
# interior joints on; the port implements only the small-N dense path
CR_MIN_JOINTS = 16
SMALL_N_SOLVER = "lu"


def _time_powers(times):
    t1 = times
    t2 = t1 * t1
    t3 = t2 * t1
    t4 = t2 * t2
    t5 = t4 * t1
    return t1, t2, t3, t4, t5


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

    # boundary knowns (v_0, a_0) and (v_N, a_N) move to the RHS
    first_j = 24.0 * Li2[:, :1] * head[:, :, 1] + 3.0 * Li[:, :1] * head[:, :, 2]
    first_s = 168.0 * Li3[:, :1] * head[:, :, 1] + 24.0 * Li2[:, :1] * head[:, :, 2]
    last_j = -24.0 * Ri2[:, -1:] * tail[:, :, 1] + 3.0 * Ri[:, -1:] * tail[:, :, 2]
    last_s = 168.0 * Ri3[:, -1:] * tail[:, :, 1] - 24.0 * Ri2[:, -1:] * tail[:, :, 2]
    zero = torch.zeros_like(rhs_j[:, :1])
    if m == 1:
        rhs_j = rhs_j + (first_j + last_j)[:, None]
        rhs_s = rhs_s + (first_s + last_s)[:, None]
    else:
        mid = [zero] * (m - 2)
        rhs_j = rhs_j + torch.cat([first_j[:, None], *mid, last_j[:, None]], 1)
        rhs_s = rhs_s + torch.cat([first_s[:, None], *mid, last_s[:, None]], 1)

    b = torch.stack([rhs_j, rhs_s], dim=2).reshape(B, 2 * m, 2)
    return A, b, p


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
    if n - 1 >= CR_MIN_JOINTS:
        raise NotImplementedError(
            "minco_coeffs: the block cyclic-reduction path (>= "
            f"{CR_MIN_JOINTS} interior joints) is not ported yet")
    A, b, p = _reduced_system(head, tail, inner, times)
    # dense LU with partial pivoting, as jnp.linalg.solve; solve_ex does
    # not synchronize with the host to check for singular lanes
    u2, _ = torch.linalg.solve_ex(A, b)
    B = times.shape[0]
    u = u2.reshape(B, n - 1, 2, 2)                 # (B, m, [v, a], D)
    v = torch.cat([head[:, None, :, 1], u[:, :, 0], tail[:, None, :, 1]], 1)
    a = torch.cat([head[:, None, :, 2], u[:, :, 1], tail[:, None, :, 2]], 1)
    return _hermite_to_monomial(p[:, :-1], v[:, :-1], a[:, :-1],
                                p[:, 1:], v[:, 1:], a[:, 1:], times)


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
