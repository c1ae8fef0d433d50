"""Batched box-constrained QP (port of ops/qp.py::box_qp_pncg_op).

    minimize 0.5 z' H z + g' z   s.t.  lb <= z <= ub

Projected Newton with Jacobi-preconditioned CG on the free subspace and
a projected line search over the candidates {1, a*, 1/2, 1/8} on the
exact quadratic, first minimum wins.  H is given as an operator.  Every
tensor has a leading lane axis: g, lb, ub, diag_h (B, n).
"""
from __future__ import annotations

import torch

from ..utils.precision import hdot


def _safe(x):
    return torch.where(torch.abs(x) > 1e-30, x, torch.full_like(x, 1e-30))


def box_qp_pncg_op(matvec, diag_h, g, lb, ub, z0=None, iters: int = 6,
                   cg_iters: int = 25, reg: float = 1e-7):
    """box_qp_pncg with the Hessian as an OPERATOR: matvec(p (..., n))
    -> H p (any leading axes after the lane axis); diag_h the diagonal."""
    z = torch.zeros_like(g) if z0 is None else z0
    z = torch.minimum(torch.maximum(z, lb), ub)
    diagH = diag_h + reg

    for _ in range(iters):
        grad = matvec(z) + g
        at_lb = (z <= lb) & (grad > 0)
        at_ub = (z >= ub) & (grad < 0)
        free = (~(at_lb | at_ub)).to(g.dtype)

        def mv(p):
            return free * matvec(free * p) + (1.0 - free) * p + reg * p

        b = -grad * free
        minv = free / diagH + (1.0 - free)
        x = torch.zeros_like(b)
        hx = torch.zeros_like(b)
        r = b
        pdir = minv * r
        rz = hdot(r, pdir)
        for _ in range(cg_iters):
            Ap = mv(pdir)
            alpha = (rz / _safe(hdot(pdir, Ap)))[..., None]
            x = x + alpha * pdir
            hx = hx + alpha * Ap
            r = r - alpha * Ap
            znew = minv * r
            rz_new = hdot(r, znew)
            beta = (rz_new / _safe(rz))[..., None]
            pdir = znew + beta * pdir
            rz = rz_new
        dz, m_dz = x, hx

        gTdz = hdot(grad, dz)
        a_star = torch.clamp(-gTdz / _safe(hdot(dz, m_dz)), 0.0, 1.0)
        alphas = torch.stack([torch.ones_like(a_star), a_star,
                              torch.full_like(a_star, 0.5),
                              torch.full_like(a_star, 0.125)], dim=1)
        zt = z[:, None, :] + alphas[..., None] * dz[:, None, :]   # (B, 4, n)
        zt = torch.minimum(torch.maximum(zt, lb[:, None]), ub[:, None])
        d = zt - z[:, None, :]
        dfs = hdot(grad[:, None, :], d) + 0.5 * hdot(d, matvec(d))
        best = torch.argmin(dfs, dim=1)
        lanes = torch.arange(g.shape[0], device=g.device)
        z_best = zt[lanes, best]
        z = torch.where((dfs[lanes, best] < 0.0)[:, None], z_best, z)
    return z
