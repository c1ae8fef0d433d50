"""Batched L-BFGS with Lewis-Overton weak-Wolfe line search (port of
solvers/lbfgs.py).

`lbfgs_minimize` nests the line search inside the iteration loop, as the
reference optimizer does (gcopter/lbfgs.hpp:440-751 lbfgs_optimize,
:276-390 line_search_lewisoverton): two-loop recursion over an m-slot
ring of (s, y) pairs, the cautious update gate, the line search's fast
exit and the g_epsilon / past-delta tests.  The flat one-eval-per-trip
solvers in solvers/bfgs.py share its parameters, statuses and two-loop
recursion.

Batching: every tensor has a leading lane axis.  The inner loop runs
while any lane still searches and the outer loop while any lane is
active; a finished lane is frozen by select, so each lane's iterates
are what it gets alone, and the batch pays the longest line search of
every iteration.

Status codes: 0 converged (g_epsilon) / 1 past-delta stop / 2 max
iterations / -1 line-search failure.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.precision import hdot


class LbfgsParams(NamedTuple):
    mem_size: int = 8
    g_epsilon: float = 1.0e-5
    past: int = 3
    delta: float = 1.0e-6
    max_iterations: int = 0          # 0 => a hard cap is applied
    max_linesearch: int = 64
    min_step: float = 1.0e-20
    max_step: float = 1.0e20
    f_dec_coeff: float = 1.0e-4
    s_curv_coeff: float = 0.9
    cautious_factor: float = 1.0e-6
    machine_prec: float = 1.0e-16
    hard_iter_cap: int = 2000
    two_loop_unroll: int = 1         # XLA unroll knob; no effect here


STATUS_CONVERGED = 0
STATUS_STOP = 1
STATUS_MAXITER = 2
STATUS_LS_FAIL = -1


def _newest_first(buf, end, m: int, nb: int):
    """buf (B, m, ...) ring slots reordered newest first, first nb slots."""
    B = buf.shape[0]
    pos = torch.arange(nb, device=buf.device)
    order = torch.remainder(end[:, None] - 1 - pos[None, :], m)   # (B, nb)
    idx = order.reshape(B, nb, *([1] * (buf.dim() - 2))).expand(
        B, nb, *buf.shape[2:])
    return torch.gather(buf, 1, idx)


def two_loop_direction(lm_s, lm_y, lm_ys, end, bound, g, scale, m: int):
    """-H g by the two-loop recursion over the ring (lbfgs.hpp:709-739).

    lm_s, lm_y (B, m, n), lm_ys (B, m), end / bound (B,) ring head and
    live pair count, scale (B,) the H0 factor of lanes with bound > 0.
    A lane with no pair gets -g.  Reads the largest pair count back to
    the host to size the loops.
    """
    nb = int(bound.max())
    d = -g
    if nb == 0:
        return d
    zf = torch.zeros_like(scale)
    S = _newest_first(lm_s, end, m, nb)
    Y = _newest_first(lm_y, end, m, nb)
    YS = _newest_first(lm_ys, end, m, nb)
    alphas = []
    for i in range(nb):
        a = torch.where(i < bound, hdot(S[:, i], d) / YS[:, i], zf)
        d = d - a[:, None] * Y[:, i]
        alphas.append(a)
    d = d * torch.where(bound > 0, scale, torch.ones_like(scale))[:, None]
    for q in range(nb - 1, -1, -1):
        beta = torch.where(q < bound, hdot(Y[:, q], d) / YS[:, q], zf)
        d = d + (alphas[q] - beta)[:, None] * S[:, q]
    return d


def _line_search(fun, xp, fp, gp, d, step0, p: LbfgsParams, skip):
    """Lewis-Overton search; lbfgs.hpp:276-390.  All arguments carry a
    lane axis; lanes in `skip` (B,) bool do not search.

    Returns (x, f, g, step, ok).  `ok` False means the search errored
    (the caller reverts), matching ls < 0.
    """
    dginit = hdot(gp, d)
    dgtest = p.f_dec_coeff * dginit
    dstest = p.s_curv_coeff * dginit
    descent_ok = dginit < 0.0

    x, f, g, step = xp, fp, gp, step0
    mu = torch.zeros_like(fp)
    nu = torch.full_like(fp, p.max_step)
    brackt = torch.zeros_like(descent_ok)
    touched = torch.zeros_like(descent_ok)
    done = ~descent_ok | skip
    ok = descent_ok
    iters = 0
    while bool((~done).any()):
        x_new = xp + step[:, None] * d
        f_new, g_new = fun(x_new)
        iters += 1

        bad = ~torch.isfinite(f_new)
        # fast exit (lbfgs.hpp:327-330)
        fast = (torch.abs(fp - f_new) / (torch.abs(fp) + 1.0)
                < (p.delta / max(p.past, 1)))
        armijo_fail = f_new > fp + step * dgtest
        wolfe_fail = hdot(g_new, d) < dstest
        accept = ((~armijo_fail & ~wolfe_fail) | fast) & ~bad

        nu_n = torch.where(armijo_fail, step, nu)
        brackt_n = brackt | armijo_fail
        mu_n = torch.where(~armijo_fail & wolfe_fail, step, mu)
        width_fail = brackt_n & ((nu_n - mu_n) < p.machine_prec * nu_n)
        count_fail = iters >= p.max_linesearch
        step_next = torch.where(brackt_n, 0.5 * (mu_n + nu_n), step * 2.0)
        min_fail = step_next < p.min_step
        over_max = step_next > p.max_step
        step_next = torch.where(over_max & ~touched,
                                torch.full_like(step_next, p.max_step),
                                step_next)
        max_fail = over_max & touched
        fail = bad | width_fail | min_fail | max_fail
        if count_fail:
            fail = torch.ones_like(fail)

        # on accept keep the evaluated point; on failure the caller reverts
        live = ~done
        take = live & accept
        x = torch.where(take[:, None], x_new, x)
        f = torch.where(take, f_new, f)
        g = torch.where(take[:, None], g_new, g)
        step = torch.where(live & ~accept, step_next, step)
        mu = torch.where(live, mu_n, mu)
        nu = torch.where(live, nu_n, nu)
        brackt = torch.where(live, brackt_n, brackt)
        touched = torch.where(live, touched | over_max, touched)
        ok = torch.where(live, ok & ~fail, ok)
        done = done | accept | fail
    return x, f, g, step, ok


def lbfgs_minimize(fun: Callable, x0, params: LbfgsParams = LbfgsParams()):
    """Minimize fun: x (B, n) -> (f (B,), grad (B, n)).

    Returns (x, f, status, n_iters), each per lane.
    """
    p = params
    B, n = x0.shape
    m = p.mem_size
    past = max(p.past, 1)
    dtype, dev = x0.dtype, x0.device
    max_iter = p.max_iterations if p.max_iterations > 0 else p.hard_iter_cap
    max_iter = min(max_iter, p.hard_iter_cap)

    f0, g0 = fun(x0)
    lanes = torch.arange(B, device=dev)
    already = (torch.amax(g0.abs(), -1)
               / torch.clamp(torch.amax(x0.abs(), -1), min=1.0)) < p.g_epsilon
    pf = torch.full((B, past), float("inf"), dtype=dtype, device=dev)
    pf[:, 0] = f0
    c = dict(
        x=x0, f=f0, g=g0, d=-g0,
        step=1.0 / torch.clamp(torch.linalg.vector_norm(g0, dim=-1),
                               min=1e-30),
        lm_s=torch.zeros((B, m, n), dtype=dtype, device=dev),
        lm_y=torch.zeros((B, m, n), dtype=dtype, device=dev),
        lm_ys=torch.ones((B, m), dtype=dtype, device=dev),
        end=torch.zeros(B, dtype=torch.int64, device=dev),
        bound=torch.zeros(B, dtype=torch.int64, device=dev),
        k=torch.ones(B, dtype=torch.int64, device=dev), pf=pf,
        done=already,
        status=torch.where(already, STATUS_CONVERGED, STATUS_MAXITER))

    while bool((~c["done"]).any()):
        xp, gp = c["x"], c["g"]
        x, f, g, step, ok = _line_search(fun, xp, c["f"], gp, c["d"],
                                         c["step"], p, c["done"])

        # convergence tests
        conv = (torch.amax(g.abs(), -1)
                / torch.clamp(torch.amax(x.abs(), -1), min=1.0)) < p.g_epsilon
        k = c["k"]
        kmod = torch.remainder(k, past)
        pf_k = torch.gather(c["pf"], 1, kmod[:, None])[:, 0]
        rate = torch.abs(pf_k - f) / torch.clamp(torch.abs(f), min=1.0)
        if p.past > 0:
            stop = (k >= past) & (rate < p.delta)
        else:
            stop = torch.zeros_like(conv)
        pf = c["pf"].clone()
        pf[lanes, kmod] = f
        maxed = k >= max_iter

        done = ~ok | conv | stop | maxed
        status = torch.where(
            ~ok, STATUS_LS_FAIL,
            torch.where(conv, STATUS_CONVERGED,
                        torch.where(stop, STATUS_STOP, STATUS_MAXITER)))

        # revert on line-search failure (lbfgs.hpp:609-614)
        x = torch.where(ok[:, None], x, xp)
        f = torch.where(ok, f, c["f"])
        g = torch.where(ok[:, None], g, gp)

        # memory update
        s_new = x - xp
        y_new = g - gp
        ys = hdot(y_new, s_new)
        yy = hdot(y_new, y_new)
        cau = (hdot(s_new, s_new) * torch.linalg.vector_norm(gp, dim=-1)
               * p.cautious_factor)
        use = (ys > cau) & ~done

        end = c["end"]
        lm_s, lm_y, lm_ys = c["lm_s"].clone(), c["lm_y"].clone(), \
            c["lm_ys"].clone()
        lm_s[lanes, end] = torch.where(use[:, None], s_new, lm_s[lanes, end])
        lm_y[lanes, end] = torch.where(use[:, None], y_new, lm_y[lanes, end])
        lm_ys[lanes, end] = torch.where(use, ys, lm_ys[lanes, end])
        bound = torch.where(use, torch.clamp(c["bound"] + 1, max=m),
                            c["bound"])
        end = torch.where(use, torch.remainder(end + 1, m), end)

        # two-loop recursion (lbfgs.hpp:709-739); a rejected pair leaves
        # the scale at 1 and the direction at steepest descent
        gamma = torch.where(use, ys / torch.clamp(yy, min=1e-30),
                            torch.ones_like(ys))
        d = two_loop_direction(lm_s, lm_y, lm_ys, end, bound, g, gamma, m)
        d = torch.where(use[:, None], d, -g)

        new = dict(x=x, f=f, g=g, d=d, step=torch.ones_like(step),
                   lm_s=lm_s, lm_y=lm_y, lm_ys=lm_ys, end=end, bound=bound,
                   k=k + 1, pf=pf, done=done,
                   status=torch.where(done, status, c["status"]))
        frozen = c["done"]
        c = {key: torch.where(
            frozen.reshape(B, *([1] * (new[key].dim() - 1))), c[key],
            new[key]) for key in new}
    return c["x"], c["f"], c["status"], c["k"]
