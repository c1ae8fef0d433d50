"""Flat one-eval-per-trip BFGS / L-BFGS / ALM solvers (port of
solvers/bfgs.py).

Same outer semantics as the reference optimizer (gcopter/lbfgs.hpp:
440-751): weak-Wolfe Lewis-Overton search with its fast exit, the
cautious update gate and the g_epsilon / past-delta tests.  Line search
and iteration advance are one flat state machine (each trip evaluates
the cost once), and the ALM outer loop lives in the same machine
(`alm_minimize`).  Three search directions:

* ``ring``: the two-loop recursion over an m-slot ring of (s, y) pairs
  with the per-iteration gamma rescale (lbfgs.hpp:709-739).
* ``compact``: the same operator in the Byrd-Nocedal-Schnabel compact
  inverse form.  The pairs sit in chronological rows, Y^T Y and the
  explicit R^{-1} are kept up to date per accepted pair, and a
  direction is about ten small matvecs of constant depth.  A trip reads
  nothing back to the host but the loop condition.
* ``dense``: the full inverse Hessian, one (n, n) matvec and three
  outer products per trip; for smooth, well-scaled problems only.

Batching: every state tensor has a leading lane axis.  The loop runs
while any lane is active; a finished lane is frozen by select, exactly
as the JAX while_loop runs under vmap, so each lane's iterates are what
that lane gets alone.  The two-loop recursion runs over the ring in
newest-first order up to the largest live pair count in the batch; the
slots past a lane's own count are exact no-ops for that lane, as in the
JAX loop over all m slots.  Every contraction is an elementwise product
and a sum over one axis, so a lane's numbers do not depend on which
other lanes share its batch.

Statuses: 0 converged / 1 past-delta stop / 2 max iterations /
-1 line-search failure.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils.precision import hdot
from .lbfgs import (LbfgsParams, STATUS_CONVERGED, STATUS_LS_FAIL,
                    STATUS_MAXITER, STATUS_STOP, two_loop_direction)


def _sel(mask, a, b):
    """Per-lane select over tensors, tuples and dicts; mask (B,) bool."""
    if isinstance(a, dict):
        return {k: _sel(mask, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_sel(mask, u, v) for u, v in zip(a, b))
    m = mask.reshape(mask.shape[0], *([1] * (a.dim() - 1)))
    return torch.where(m, a, b)


def _mv(A, v):
    """Batched A @ v: A (B, r, c), v (B, c) -> (B, r)."""
    return torch.sum(A * v[:, None, :], dim=-1)


def _mtv(A, w):
    """Batched A.T @ w: A (B, r, c), w (B, r) -> (B, c)."""
    return torch.sum(A * w[:, :, None], dim=1)


def _flat_minimize(fun, x0, params: LbfgsParams, direction, ostate0,
                   outer_update, max_outer):
    """Shared flat loop.  fun(x, ostate) -> (f (B,), g (B, n), aux tuple).

    outer_update(ostate, x, aux) -> (ostate', outer_done (B,) bool).
    Returns the final state dict.
    """
    if direction not in ("dense", "ring", "compact"):
        raise ValueError(f"unknown direction {direction!r}; "
                         "expected 'dense', 'ring' or 'compact'")
    dense = direction == "dense"
    compact = direction == "compact"
    p = params
    B, n = x0.shape
    m = p.mem_size
    lm = 0 if dense else m          # rows of the (s, y) store
    cm = m if compact else 0        # side of Y^T Y and R^{-1}
    past = max(p.past, 1)
    dtype, dev = x0.dtype, x0.device
    max_iter = p.max_iterations if p.max_iterations > 0 else p.hard_iter_cap
    max_iter = min(max_iter, p.hard_iter_cap)
    max_evals = max_outer * (2 * max_iter + 4 * p.max_linesearch)

    f0, g0, aux0 = fun(x0, ostate0)
    zi = torch.zeros(B, dtype=torch.int64, device=dev)
    zf = torch.zeros(B, dtype=dtype, device=dev)
    fb = torch.zeros(B, dtype=torch.bool, device=dev)
    already = (torch.amax(g0.abs(), -1)
               / torch.clamp(torch.amax(x0.abs(), -1), min=1.0)) < p.g_epsilon

    idxs = torch.arange(m, device=dev)
    if dense:
        eye = torch.eye(n, dtype=dtype, device=dev).expand(B, n, n)
    if compact:
        not_last = (idxs < m - 1).to(dtype)
        not_last2 = not_last[:, None] * not_last[None, :]

    def fresh_pf(f):
        pf = torch.full((B, past), float("inf"), dtype=dtype, device=dev)
        pf[:, 0] = f
        return pf

    def restart_fields(f, g):
        return dict(
            f=f, g=g, d=-g,
            step=1.0 / torch.clamp(torch.linalg.vector_norm(g, dim=-1),
                                   min=1e-30),
            dginit=-hdot(g, g), mu=zf, nu=torch.full_like(zf, p.max_step),
            brackt=fb, touched=fb, ls_iters=zi,
            first_update=~fb,
            lm_s=torch.zeros((B, lm, n), dtype=dtype, device=dev),
            lm_y=torch.zeros((B, lm, n), dtype=dtype, device=dev),
            lm_ys=torch.ones((B, lm), dtype=dtype, device=dev),
            end=zi, bound=zi,
            cYtY=torch.zeros((B, cm, cm), dtype=dtype, device=dev),
            cRinv=torch.zeros((B, cm, cm), dtype=dtype, device=dev),
            k=zi + 1, pf=fresh_pf(f))

    H_init = eye if dense else torch.zeros((B, 0, 0), dtype=dtype, device=dev)
    s = dict(restart_fields(f0, g0), x=x0, aux=aux0, H=H_init,
             k_total=zi, evals=zi,
             status=torch.where(already, STATUS_CONVERGED, STATUS_MAXITER),
             ostate=ostate0, outer=zi, reinit=fb,
             done=already & (max_outer == 1))
    lanes = torch.arange(B, device=dev)

    while bool((~s["done"]).any()):
        reinit = s["reinit"]
        x_trial = torch.where(reinit[:, None], s["x"],
                              s["x"] + s["step"][:, None] * s["d"])
        f_new, g_new, aux_new = fun(x_trial, s["ostate"])
        evals = s["evals"] + 1
        ls_iters = s["ls_iters"] + 1

        # ============ restart-evaluation trip ============
        re = dict(restart_fields(f_new, g_new), x=s["x"], aux=aux_new,
                  H=H_init, k_total=s["k_total"], evals=evals, status=s["status"],
                  ostate=s["ostate"], outer=s["outer"], reinit=fb, done=fb)

        # ============ normal trip ============
        bad = ~torch.isfinite(f_new)
        dgtest = p.f_dec_coeff * s["dginit"]
        dstest = p.s_curv_coeff * s["dginit"]
        fast = (torch.abs(s["f"] - f_new) / (torch.abs(s["f"]) + 1.0)
                < (p.delta / past))
        armijo_fail = f_new > s["f"] + s["step"] * dgtest
        wolfe_fail = hdot(g_new, s["d"]) < dstest
        accept = (~armijo_fail & ~wolfe_fail) | fast
        accept = accept & ~bad

        # --- line-search bracket advance (lbfgs.hpp:332-371) ---
        nu_n = torch.where(armijo_fail, s["step"], s["nu"])
        brackt_n = s["brackt"] | armijo_fail
        mu_n = torch.where(~armijo_fail & wolfe_fail, s["step"], s["mu"])
        width_fail = brackt_n & ((nu_n - mu_n) < p.machine_prec * nu_n)
        count_fail = ls_iters >= p.max_linesearch
        step_next = torch.where(brackt_n, 0.5 * (mu_n + nu_n),
                                s["step"] * 2.0)
        min_fail = step_next < p.min_step
        over_max = step_next > p.max_step
        step_next = torch.where(over_max & ~s["touched"],
                                torch.full_like(step_next, p.max_step),
                                step_next)
        max_fail = over_max & s["touched"]
        touched_n = s["touched"] | over_max
        ls_fail = (bad | width_fail | count_fail | min_fail | max_fail) \
            & ~accept

        # --- accepted-step bookkeeping ---
        s_vec = x_trial - s["x"]
        y_vec = g_new - s["g"]
        ys = hdot(y_vec, s_vec)
        yy = hdot(y_vec, y_vec)
        cau = (hdot(s_vec, s_vec) * torch.linalg.vector_norm(s["g"], dim=-1)
               * p.cautious_factor)
        conv = (torch.amax(g_new.abs(), -1)
                / torch.clamp(torch.amax(x_trial.abs(), -1), min=1.0)
                ) < p.g_epsilon
        kmod = torch.remainder(s["k"], past)
        pf_k = torch.gather(s["pf"], 1, kmod[:, None])[:, 0]
        rate = torch.abs(pf_k - f_new) / torch.clamp(torch.abs(f_new),
                                                     min=1.0)
        if p.past > 0:
            stop = (s["k"] >= past) & (rate < p.delta)
        else:
            stop = fb
        maxed = s["k"] >= max_iter
        finished = conv | stop | maxed
        use = accept & (ys > cau) & ~finished
        gamma = ys / torch.clamp(yy, min=1e-30)

        one = torch.ones_like(gamma)
        H, first_update = s["H"], s["first_update"]
        lm_s, lm_y, lm_ys = s["lm_s"], s["lm_y"], s["lm_ys"]
        end, bound = s["end"], s["bound"]
        cYtY, cRinv = s["cYtY"], s["cRinv"]
        if dense:
            # BFGS inverse update (first accepted pair rescales H0)
            H0 = torch.where(first_update[:, None, None],
                             gamma[:, None, None] * eye, H)
            rho_i = 1.0 / torch.clamp(ys, min=1e-30)
            Hy = _mv(H0, y_vec)
            yHy = hdot(y_vec, Hy)
            sHy = s_vec[:, :, None] * Hy[:, None, :]
            H_new = (H0 - rho_i[:, None, None] * (sHy + sHy.transpose(1, 2))
                     + (rho_i + rho_i * rho_i * yHy)[:, None, None]
                     * (s_vec[:, :, None] * s_vec[:, None, :]))
            H = torch.where(use[:, None, None], H_new, H)
            first_update = first_update & ~use
            d_new = torch.where(first_update[:, None], -g_new, -_mv(H, g_new))
        elif compact:
            # Compact inverse form (Byrd-Nocedal-Schnabel 1994):
            #   H = gI + [S gY] W [S^T; gY^T],
            #   W = [[R^{-T}(D + g Y^TY)R^{-1}, -R^{-T}], [-R^{-1}, 0]]
            # with S, Y the stored pairs in CHRONOLOGICAL row order
            # [0, bound), D = diag(s_i^T y_i) and R the upper-triangular
            # part of S^T Y.  Appending a pair is one matvec and a column
            # write; dropping the oldest uses the fact that the inverse
            # of R without its first row and column is exactly the
            # trailing block of R^{-1}.
            is_full = bound >= m
            full3 = is_full[:, None, None]
            ys_safe = torch.clamp(ys, min=1e-30)
            S1 = torch.where(full3, torch.roll(lm_s, -1, 1), lm_s)
            Y1 = torch.where(full3, torch.roll(lm_y, -1, 1), lm_y)
            ys1 = torch.where(is_full[:, None], torch.roll(lm_ys, -1, 1),
                              lm_ys)
            YtY1 = torch.where(full3, torch.roll(cYtY, (-1, -1), (1, 2)),
                               cYtY)
            R1 = torch.where(
                full3, torch.roll(cRinv, (-1, -1), (1, 2)) * not_last2, cRinv)
            idx = torch.where(is_full, torch.full_like(bound, m - 1), bound)

            S1[lanes, idx] = s_vec
            Y1[lanes, idx] = y_vec
            ys1[lanes, idx] = ys
            ycol = _mv(Y1, y_vec)               # rows > idx are zero rows
            YtY1[lanes, idx, :] = ycol
            YtY1[lanes, :, idx] = ycol
            r = _mv(S1, y_vec) * (idxs[None, :] < idx[:, None]).to(dtype)
            c = -_mv(R1, r) / ys_safe[:, None]  # rows >= idx of R1 are zero
            c[lanes, idx] = 1.0 / ys_safe
            R1[lanes, :, idx] = c

            use3 = use[:, None, None]
            lm_s = torch.where(use3, S1, lm_s)
            lm_y = torch.where(use3, Y1, lm_y)
            lm_ys = torch.where(use[:, None], ys1, lm_ys)
            cYtY = torch.where(use3, YtY1, cYtY)
            cRinv = torch.where(use3, R1, cRinv)
            bound = torch.where(use, torch.clamp(bound + 1, max=m), bound)

            # d = -(g*g_new + S w - g*Y u): ring-mode gamma semantics
            # (rescale only on the trip that stored a pair)
            gam = torch.where(use, gamma, one)[:, None]
            u = _mv(cRinv, _mv(lm_s, g_new))
            t = lm_ys * u + gam * _mv(cYtY, u) - gam * _mv(lm_y, g_new)
            w = _mtv(cRinv, t)
            Hg = gam * g_new + _mtv(lm_s, w) - gam * _mtv(lm_y, u)
            d_new = torch.where((bound > 0)[:, None], -Hg, -g_new)
        else:
            # ring buffer + two-loop recursion (lbfgs.hpp:709-739); the
            # model only changes on a used (hence accepted) step
            lm_s, lm_y, lm_ys = lm_s.clone(), lm_y.clone(), lm_ys.clone()
            lm_s[lanes, end] = torch.where(use[:, None], s_vec,
                                           lm_s[lanes, end])
            lm_y[lanes, end] = torch.where(use[:, None], y_vec,
                                           lm_y[lanes, end])
            lm_ys[lanes, end] = torch.where(use, ys, lm_ys[lanes, end])
            bound = torch.where(use, torch.clamp(bound + 1, max=m), bound)
            end = torch.where(use, torch.remainder(end + 1, m), end)
            d_new = two_loop_direction(lm_s, lm_y, lm_ys, end, bound, g_new,
                                       torch.where(use, gamma, one), m)

        dginit_new = hdot(g_new, d_new)
        descent_bad = dginit_new >= 0.0
        d_new = torch.where(descent_bad[:, None], -g_new, d_new)
        dginit_new = torch.where(descent_bad, -hdot(g_new, g_new), dginit_new)
        if dense:
            # the model may only change on an accepted step (the trial
            # point is otherwise a mid-line-search point)
            H = torch.where((accept & descent_bad)[:, None, None], eye, H)
            H = torch.where(accept[:, None, None], H, s["H"])
            first_update = torch.where(accept, first_update | descent_bad,
                                       s["first_update"])

        evals_out = evals >= max_evals
        inner_done = ls_fail | (accept & finished)
        status = torch.where(
            ls_fail, STATUS_LS_FAIL,
            torch.where(conv, STATUS_CONVERGED,
                        torch.where(stop, STATUS_STOP, STATUS_MAXITER)))
        status = torch.where(inner_done, status, s["status"])

        x_acc = _sel(accept, x_trial, s["x"])
        f_acc = _sel(accept, f_new, s["f"])
        g_acc = _sel(accept, g_new, s["g"])
        aux_acc = _sel(accept, aux_new, s["aux"])

        # --- outer transition on inner finish ---
        ostate_next, outer_ok = outer_update(s["ostate"], x_acc, aux_acc)
        outer_next = s["outer"] + 1
        fire = inner_done
        done = (fire & (outer_ok | (outer_next >= max_outer))) | evals_out
        pf_new = s["pf"].clone()
        pf_new[lanes, kmod] = f_new

        nrm = dict(
            x=x_acc, f=f_acc, g=g_acc, aux=aux_acc,
            d=_sel(accept, d_new, s["d"]),
            step=torch.where(accept, torch.ones_like(step_next), step_next),
            dginit=torch.where(accept, dginit_new, s["dginit"]),
            mu=torch.where(accept, zf, mu_n),
            nu=torch.where(accept, torch.full_like(nu_n, p.max_step), nu_n),
            brackt=~accept & brackt_n, touched=~accept & touched_n,
            ls_iters=torch.where(accept, zi, ls_iters),
            H=H, first_update=first_update,
            lm_s=lm_s, lm_y=lm_y, lm_ys=lm_ys, end=end, bound=bound,
            cYtY=cYtY, cRinv=cRinv,
            k=torch.where(accept, s["k"] + 1, s["k"]),
            k_total=torch.where(accept, s["k_total"] + 1, s["k_total"]),
            evals=evals,
            pf=_sel(accept, pf_new, s["pf"]),
            status=status,
            ostate=_sel(fire, ostate_next, s["ostate"]),
            outer=torch.where(fire, outer_next, s["outer"]),
            reinit=fire & ~done, done=done)

        new = _sel(reinit, re, nrm)
        s = _sel(s["done"], s, new)
    return s


def bfgs_minimize(fun: Callable, x0, params: LbfgsParams = LbfgsParams(),
                  direction: str = "dense"):
    """Minimize fun: x (B, n) -> (f (B,), grad (B, n)).  Returns (x, f,
    status, n_iters) per lane; `n_iters` counts accepted iterations
    (line-search evaluations excluded), as lbfgs_minimize's counter."""
    def fun2(x, _):
        f, g = fun(x)
        return f, g, ()

    def no_outer(ostate, x, aux):
        return ostate, torch.ones(x.shape[0], dtype=torch.bool,
                                  device=x.device)

    out = _flat_minimize(fun2, x0, params, direction, (), no_outer, 1)
    return out["x"], out["f"], out["status"], out["k"]


def flat_lbfgs_minimize(fun: Callable, x0,
                        params: LbfgsParams = LbfgsParams(),
                        direction: str = "ring"):
    """L-BFGS iterates in the flat one-eval-per-trip loop.
    direction='compact' swaps the two-loop recursion for the compact
    inverse form: the same operator at constant depth per trip."""
    return bfgs_minimize(fun, x0, params, direction=direction)


def alm_minimize(fun: Callable, x0, ostate0, outer_update,
                 params: LbfgsParams = LbfgsParams(), max_outer: int = 10,
                 direction: str = "ring"):
    """Inner solver + ALM-style outer updates in ONE flat loop.

    fun(x, ostate) -> (f, grad, aux tuple); outer_update(ostate, x, aux)
    -> (ostate', outer_done).  Returns (x, f, aux, status,
    total_accepted_iters, n_outer), each per lane.
    """
    out = _flat_minimize(fun, x0, params, direction, ostate0,
                         outer_update, max_outer)
    return (out["x"], out["f"], out["aux"], out["status"], out["k_total"],
            out["outer"])
