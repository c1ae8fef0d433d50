"""MINCO_S4NU: the septic (degree-7) member of the MINCO family (port of
solvers/minco_s4.py).

Rebuild of gcopter/minco.hpp MINCO_S4NU (back_end/include/gcopter/
minco.hpp:202-556): minimum-snap spline through N-1 interior waypoints
with full (p, v, a, j) boundary states, 8 coefficients per piece.  The
planning path instantiates only the quintic S3NU (solvers/minco.py); the
septic variant completes the gcopter family.

The reference solves its 8N x 8N banded system with a sequential LU
(BandedSystem::factorizeLU); here the system is assembled densely for a
batch of lanes and solved with the batched `torch.linalg.solve`, as the
JAX package solves it with `jnp.linalg.solve` outside any kernel of its
own.  Gradients come from autograd through the solve (the solve's
backward IS the adjoint system the reference hand-codes in
propogateGrad, minco.hpp:312-410).  Lanes lead every argument.
"""
from __future__ import annotations

import torch

NCOEF = 8   # degree-7


def _dbasis(o: int, t):
    """d^o/ds^o s^k at s = t for k = 0..7: (..., 8)."""
    k = torch.arange(NCOEF, device=t.device)
    ff = torch.ones(NCOEF, dtype=t.dtype, device=t.device)
    for d in range(o):
        ff = ff * torch.clamp(k - d, min=0)
    pw = t[..., None] ** torch.clamp(k - o, min=0)
    return ff * torch.where(k >= o, pw, torch.zeros_like(pw))


def minco_s4_coeffs(head, tail, inner, times):
    """Piece coefficients (B, N, 8, 2), ascending powers.

    head/tail: (B, 2, 4) boundary [dim, (p, v, a, j)]; inner: (B, 2, N-1)
    interior waypoints; times: (B, N).  The row layout of
    MINCO_S4NU::setParameters (minco.hpp:275-434), solved densely."""
    B, n = times.shape
    m = 8 * n
    T = times
    A = torch.zeros((B, m, m), dtype=T.dtype, device=T.device)
    b = torch.zeros((B, m, 2), dtype=T.dtype, device=T.device)

    # head boundary (rows 0-3): p, v, a, j at s=0
    for r, v in enumerate((1.0, 1.0, 2.0, 6.0)):
        A[:, r, r] = v
    b[:, 0:4] = head.transpose(1, 2)

    if n > 1:
        r0 = 8 * torch.arange(n - 1, device=T.device)
        Ti = T[:, :-1]
        # snap / crackle / pop continuity (rows 8i+4..6)
        A[:, r0 + 4, r0 + 4] = 24.0
        A[:, r0 + 4, r0 + 5] = 120.0 * Ti
        A[:, r0 + 4, r0 + 6] = 360.0 * Ti ** 2
        A[:, r0 + 4, r0 + 7] = 840.0 * Ti ** 3
        A[:, r0 + 4, r0 + 12] = -24.0
        A[:, r0 + 5, r0 + 5] = 120.0
        A[:, r0 + 5, r0 + 6] = 720.0 * Ti
        A[:, r0 + 5, r0 + 7] = 2520.0 * Ti ** 2
        A[:, r0 + 5, r0 + 13] = -120.0
        A[:, r0 + 6, r0 + 6] = 720.0
        A[:, r0 + 6, r0 + 7] = 5040.0 * Ti
        A[:, r0 + 6, r0 + 14] = -720.0
        # waypoint (row 8i+7) + C0..C3 continuity (rows 8i+8..11)
        beta = _dbasis(0, Ti)                             # (B, n-1, 8)
        for k in range(NCOEF):
            A[:, r0 + 7, r0 + k] = beta[..., k]
            A[:, r0 + 8, r0 + k] = beta[..., k]
        A[:, r0 + 8, r0 + 8] = -1.0
        for o, scale in ((1, 1.0), (2, 2.0), (3, 6.0)):
            db = _dbasis(o, Ti)
            for k in range(NCOEF):
                A[:, r0 + 8 + o, r0 + k] = db[..., k]
            A[:, r0 + 8 + o, r0 + 8 + o] = -scale
        b[:, r0 + 7] = inner.transpose(1, 2)

    # tail boundary (rows 8N-4..8N-1): p, v, a, j at T_{N-1}
    c0 = 8 * (n - 1)
    for o in range(4):
        A[:, m - 4 + o, c0:c0 + NCOEF] = _dbasis(o, T[:, -1])
    b[:, m - 4:] = tail.transpose(1, 2)

    c = torch.linalg.solve(A, b)
    return c.reshape(B, n, NCOEF, 2)


def minco_s4_energy(coeffs, times, weights=(1.0, 1.0)):
    """Integral of the weighted squared snap per lane (B,) (getEnergy,
    minco.hpp:205-237): closed form in the ascending coefficients c4..c7
    of each piece."""
    w = torch.as_tensor(weights, dtype=coeffs.dtype, device=coeffs.device)
    c4, c5, c6, c7 = (coeffs[..., 4, :], coeffs[..., 5, :],
                      coeffs[..., 6, :], coeffs[..., 7, :])
    T1 = times
    T2, T3 = T1 ** 2, T1 ** 3
    T4, T5 = T2 ** 2, T2 ** 2 * T1
    T6, T7 = T3 ** 2, T3 ** 2 * T1

    def wdot(a, bb):
        return torch.sum(a * w * bb, dim=-1)

    e = (576.0 * wdot(c4, c4) * T1
         + 2880.0 * wdot(c4, c5) * T2
         + 4800.0 * wdot(c5, c5) * T3
         + 5760.0 * wdot(c4, c6) * T3
         + 21600.0 * wdot(c5, c6) * T4
         + 10080.0 * wdot(c4, c7) * T4
         + 25920.0 * wdot(c6, c6) * T5
         + 40320.0 * wdot(c5, c7) * T5
         + 100800.0 * wdot(c6, c7) * T6
         + 100800.0 * wdot(c7, c7) * T7)
    return torch.sum(e, dim=-1)


def minco_s4_energy_grads(head, tail, inner, times, weights=(1.0, 1.0)):
    """(gradByPoints (B, 2, N-1), gradByTimes (B, N)) of each lane's snap
    energy, by autograd through the solve (the reference's hand-coded
    adjoint chain, getEnergyPartialGradByCoeffs/Times + propogateGrad,
    minco.hpp:239-410)."""
    with torch.enable_grad():
        inner = inner.detach().requires_grad_(True)
        times = times.detach().requires_grad_(True)
        e = minco_s4_energy(minco_s4_coeffs(head, tail, inner, times), times,
                            weights)
        gp, gt = torch.autograd.grad(e.sum(), (inner, times))
    return gp, gt
