"""Batched box-constrained QP solvers (port of ops/qp.py).

    minimize 0.5 z' H z + g' z   s.t.  lb <= z <= ub

* box_qp_pncg / box_qp_pncg_op: projected Newton with Jacobi-
  preconditioned CG on the free subspace and a projected line search
  over the candidates {1, a*, 1/2, 1/8} on the exact quadratic, first
  minimum wins.  H is a dense matrix or an operator.
* box_qp_projected_newton: the same outer iteration with a masked dense
  solve for the free variables and a line search over 8 halvings.
* box_qp_admm: OSQP-style splitting with one Cholesky factorization of
  H + rho*I.
* qp_admm_general: OSQP-style dense ADMM for general constraints
  lb <= A z <= ub (the LTV-MPC's solver); its steps are one hand-written
  kernel launch on a card.

All run a fixed number of iterations and can be warm started (z0).
Every tensor has a leading lane axis: g, lb, ub, diag_h (B, n),
H (B, n, n) and A (B, m, n).
"""
from __future__ import annotations

import torch

from ..utils.precision import hdot
from ..utils.profiling import count, span
from .qp_admm_cuda import qp_admm_cuda

# the Tikhonov term of the PNCG solves (box_qp_pncg, box_qp_pncg_op)
PNCG_REG = 1e-7


def _safe(x):
    return torch.where(torch.abs(x) > 1e-30, x, torch.full_like(x, 1e-30))


def _hmv(H, p):
    """H @ p for H (B, n, n) and p (B, n) or (B, k, n)."""
    if p.dim() == 2:
        return torch.matmul(H, p[..., None])[..., 0]
    return torch.matmul(p, H.transpose(1, 2))


def box_qp_kkt_residual(H, g, lb, ub, z):
    """Projected-gradient KKT residual || z - clip(z - (Hz+g)) ||_inf, (B,)."""
    grad = _hmv(H, z) + g
    proj = torch.minimum(torch.maximum(z - grad, lb), ub)
    return torch.amax(torch.abs(z - proj), dim=-1)


def box_qp_projected_newton(H, g, lb, ub, z0=None, iters: int = 12,
                            reg: float = 1e-8):
    """Projected Newton for strictly convex box QPs; returns z (B, n)."""
    B, n = g.shape
    z = torch.zeros_like(g) if z0 is None else z0
    z = torch.minimum(torch.maximum(z, lb), ub)
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    alphas = 2.0 ** -torch.arange(8, dtype=g.dtype, device=g.device)
    lanes = torch.arange(B, device=g.device)
    for _ in range(iters):
        grad = _hmv(H, z) + g
        at_lb = (z <= lb) & (grad > 0)
        at_ub = (z >= ub) & (grad < 0)
        free = (~(at_lb | at_ub)).to(g.dtype)
        # masked KKT: rows/cols of active variables replaced by identity
        M = (H * (free[:, :, None] * free[:, None, :])
             + torch.diag_embed(1.0 - free) + reg * eye)
        dz = torch.linalg.solve(M, (-grad * free)[..., None])[..., 0]
        # projected line search: full step, then backtrack by halves
        zt = z[:, None, :] + alphas[None, :, None] * dz[:, None, :]
        zt = torch.minimum(torch.maximum(zt, lb[:, None]), ub[:, None])
        fs = 0.5 * hdot(zt, _hmv(H, zt)) + hdot(g[:, None, :], zt)
        f0 = 0.5 * hdot(z, _hmv(H, z)) + hdot(g, z)
        best = torch.argmin(fs, dim=1)
        improved = fs[lanes, best] < f0
        z = torch.where(improved[:, None], zt[lanes, best], z)
    return z


def box_qp_pncg(H, g, lb, ub, z0=None, iters: int = 6, cg_iters: int = 25,
                reg: float = PNCG_REG):
    """Projected Newton with CG inner solves on a dense H (B, n, n): the
    fixed point of box_qp_projected_newton without a factorization."""
    return box_qp_pncg_op(lambda p: _hmv(H, p),
                          torch.diagonal(H, dim1=-2, dim2=-1), g, lb, ub,
                          z0=z0, iters=iters, cg_iters=cg_iters, reg=reg)


def box_qp_admm(H, g, lb, ub, z0=None, rho: float = 1.0, iters: int = 100,
                over_relax: float = 1.6):
    """ADMM (OSQP-style splitting) for box QPs; one factorization total."""
    n = g.shape[-1]
    z = torch.zeros_like(g) if z0 is None else z0
    z = torch.minimum(torch.maximum(z, lb), ub)
    u = torch.zeros_like(g)
    L = torch.linalg.cholesky(
        H + rho * torch.eye(n, dtype=g.dtype, device=g.device))
    for _ in range(iters):
        x = torch.cholesky_solve((-g + rho * (z - u))[..., None], L)[..., 0]
        x_r = over_relax * x + (1.0 - over_relax) * z
        z_new = torch.minimum(torch.maximum(x_r + u, lb), ub)
        u = u + x_r - z_new
        z = z_new
    return z


def box_qp_pncg_op(matvec, diag_h, g, lb, ub, z0=None, iters: int = 6,
                   cg_iters: int = 25, reg: float = PNCG_REG):
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


def qp_admm_general(H, g, A, lb, ub, z0=None, rho: float = 0.4,
                    sigma: float = 1e-6, alpha: float = 1.6,
                    iters: int = 200, pattern=None):
    """OSQP-style dense ADMM:  min 0.5 x'Hx + g'x  s.t. lb <= A x <= ub.

    The operator splitting of OSQP (the reference LTV-MPC's solver,
    mpc_controller/src/mpc.cpp:494-532) with one dense Cholesky of the
    reduced KKT matrix H + sigma*I + A' diag(rho) A, then `iters` relaxed
    steps of two triangular solves each.  Equality rows (lb == ub) get
    rho * 1e3, as OSQP scales them.  H (B, n, n), g (B, n), A (B, m, n),
    lb/ub (B, m).  Returns (x, y): primal solution and constraint dual.

    On a card the steps run as one launch of the hand-written kernel
    (`ops/qp_admm_cuda.py`, `csrc/qp_admm.cu`), which reads A and the
    factor only at `pattern`'s entries (an `AdmmPattern`: where they may
    be nonzero in every lane; every entry when None); a tensor it does
    not take raises.  On the CPU they run as `admm_steps`, the plain version,
    which ignores the pattern.

    Spans `admm.factor` (the KKT product and the Cholesky) and
    `admm.iterate` (the steps), and the counter `admm.iters` (+1 a step
    run).  Nothing is read back to the host: K is positive definite by
    construction (sigma > 0), so the factorisation's error check is left
    out on purpose (`cholesky_ex`, its `info` not read).  A K that is not
    positive definite, from a non-finite or diverged input, gives NaN in
    the result rather than an error.  Each eager step solves with the
    two triangular factors, the LAPACK calls of `cholesky_solve` on the
    CPU (the same bits).
    """
    n = g.shape[-1]
    rho_vec = torch.where(torch.abs(ub - lb) < 1e-12,
                          torch.full_like(lb, rho * 1e3),
                          torch.full_like(lb, rho))
    At = A.transpose(1, 2)
    with span("admm.factor"):
        K = (H + sigma * torch.eye(n, dtype=g.dtype, device=g.device)
             + torch.matmul(At * rho_vec[:, None, :], A))
        L = torch.linalg.cholesky_ex(K).L
    with span("admm.iterate"):
        if g.is_cuda:
            x, y = qp_admm_cuda(L, A, g, lb, ub, z0, rho=rho, sigma=sigma,
                                alpha=alpha, iters=iters, pattern=pattern)
            count("admm.iters", iters)
        else:
            x, y = admm_steps(L, A, g, lb, ub, rho_vec, z0, sigma, alpha,
                              iters)
    return x, y


def admm_steps(L, A, g, lb, ub, rho_vec, z0, sigma: float, alpha: float,
               iters: int):
    """The plain version of `qp_admm_general`'s steps, on any device: from
    the lower factor L of its KKT matrix and the rows' rho_vec, `iters`
    relaxed steps of eager operations, each adding one to the counter
    `admm.iters`.  Returns (x, y)."""
    x = torch.zeros_like(g) if z0 is None else z0
    z = torch.minimum(torch.maximum(_hmv(A, x), lb), ub)
    y = torch.zeros_like(lb)
    At, Lt = A.transpose(1, 2), L.transpose(1, 2)
    for _ in range(iters):
        rhs = sigma * x - g + _hmv(At, rho_vec * z - y)
        w = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
        xt = torch.linalg.solve_triangular(Lt, w, upper=True)[..., 0]
        zt = _hmv(A, xt)
        x = alpha * xt + (1.0 - alpha) * x
        z_relaxed = alpha * zt + (1.0 - alpha) * z
        z_new = torch.minimum(torch.maximum(z_relaxed + y / rho_vec, lb), ub)
        y = y + rho_vec * (z_relaxed - z_new)
        z = z_new
        count("admm.iters")
    return x, y
