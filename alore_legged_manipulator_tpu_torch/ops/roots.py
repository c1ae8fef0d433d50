"""Polynomial real roots and trajectory extremum rates (port of
ops/roots.py).

Fills the role of gcopter/root_finder.hpp (Sturm-sequence isolation +
safe Newton, used by trajectory.hpp getMaxVelRate/getMaxAccRate for
post-hoc limit checks).  As in the reference, nothing on the planning
path calls it: the back end enforces rate limits through its penalty
terms.  The capability stays for profiles that want a certificate-grade
limit check.

Sturm bisection is branchy scalar code; the eigenvalues of the companion
matrix give all roots at once as one batched dense eigendecomposition
(`torch.linalg.eigvals`).  On CUDA that call synchronizes the host with
the device (its result's size is checked on the host), so a caller in a
loop pays one round trip per call.  The order of the roots is not
defined: compare masks and maxima, not root lists.  Leading axes batch.
"""
from __future__ import annotations

import torch


def companion_roots(coeffs):
    """All complex roots of sum_k coeffs[..., k] x^k (ascending order).

    coeffs: (..., n+1) with coeffs[..., -1] the leading term.  A
    degenerate leading zero is regularized (it produces huge spurious
    roots which callers filter by interval).  Returns (..., n) complex
    roots."""
    n = coeffs.shape[-1] - 1
    lead = coeffs[..., -1:]
    safe_lead = torch.where(torch.abs(lead) > 1e-12, lead,
                            torch.full_like(lead, 1e-12))
    monic = coeffs[..., :-1] / safe_lead
    C = torch.zeros(coeffs.shape[:-1] + (n, n), dtype=coeffs.dtype,
                    device=coeffs.device)
    C[..., 1:, :-1] = torch.eye(n - 1, dtype=coeffs.dtype,
                                device=coeffs.device)
    C[..., :, -1] = -monic
    return torch.linalg.eigvals(C)


def real_roots_in(coeffs, lo, hi, tol: float = 1e-7):
    """Mask and values of the real roots within [lo, hi] (broadcast over
    the leading axes).  Returns (roots (..., n), mask (..., n)) with
    non-real or out-of-range entries set to lo and masked False."""
    r = companion_roots(coeffs)
    x = r.real
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    lo_b, hi_b = lo[..., None], hi[..., None]
    is_real = torch.abs(r.imag) < tol * (1.0 + torch.abs(x))
    mask = is_real & (x >= lo_b) & (x <= hi_b)
    return torch.where(mask, x, lo_b.expand_as(x)), mask


def poly_max_abs_on(coeffs, lo, hi):
    """max |p(x)| over [lo, hi] via the critical points and the ends."""
    n = coeffs.shape[-1]
    k = torch.arange(1, n, dtype=coeffs.dtype, device=coeffs.device)
    crit, mask = real_roots_in(coeffs[..., 1:] * k, lo, hi)
    lo = torch.as_tensor(lo, dtype=coeffs.dtype,
                         device=coeffs.device).expand(crit.shape[:-1])
    hi = torch.as_tensor(hi, dtype=coeffs.dtype,
                         device=coeffs.device).expand(crit.shape[:-1])
    xs = torch.cat([lo[..., None], hi[..., None], crit], dim=-1)
    ms = torch.cat([torch.ones(mask.shape[:-1] + (2,), dtype=torch.bool,
                               device=mask.device), mask], dim=-1)
    powers = xs[..., None] ** torch.arange(n, device=xs.device)
    vals = torch.abs(torch.sum(powers * coeffs[..., None, :], dim=-1))
    return torch.amax(torch.where(ms, vals, -torch.inf), dim=-1)


def max_rates(traj_coeffs, times):
    """(max |yawdot|, max |sdot|, max |yawddot|, max |sddot|) over a
    piecewise trajectory (..., N, 6, 2) with piece times (..., N), each
    (...,): the trajectory.hpp getMaxVelRate / getMaxAccRate analogue."""
    out = []
    for order in (1, 2):
        dc = traj_coeffs
        for _ in range(order):
            kk = torch.arange(1, dc.shape[-2], dtype=dc.dtype,
                              device=dc.device)
            dc = dc[..., 1:, :] * kk[:, None]
        for dim in (0, 1):
            out.append(poly_max_abs_on(dc[..., dim], 0.0, times))
    per = torch.stack(out, dim=-1)                 # (..., N, 4)
    m = torch.amax(per, dim=-2)
    return m[..., 0], m[..., 1], m[..., 2], m[..., 3]
