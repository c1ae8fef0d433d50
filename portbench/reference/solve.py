"""A plain solve of the back end's problem, and its objective, in any dtype.

The same problem as the planner's `back_end` on the configuration's
profile (optimizer.cpp:169-472), written from its equations: the
decision variables are the inner waypoints of (yaw, s), the tail's arc
length and the virtual piece times; stage 1 pulls the flow's piece ends
onto the front end's positions; stage 2 trades the jerk energy and the
time against penalties on the acceleration, the angular acceleration,
the velocity diamond, the centripetal acceleration and the clearance of
two body points, under an augmented Lagrangian on the final XY; a plan
whose flow comes closer than `final_min_safe_dis` to an obstacle is
solved again from stage 1's answer with a lighter time weight.  Each
stage is minimised by a plain L-BFGS with the Lewis-Overton weak-Wolfe
line search and the configuration's stopping rules.  Lanes are solved
one at a time.  Gradients come from autograd through the reference's
own spline, flow and distance field (`spline.py`).
"""
from __future__ import annotations

import math

import torch

from . import spline

INF = 1e30


def real_time(tau):
    """Virtual piece times to real ones (always positive)."""
    return torch.where(tau > 0, (0.5 * tau + 1.0) * tau + 1.0,
                       1.0 / ((0.5 * tau - 1.0) * tau + 1.0))


def virtual_time(T):
    return torch.where(T > 1, torch.sqrt(2.0 * T - 1.0) - 1.0,
                       1.0 - torch.sqrt(2.0 / T - 1.0))


def hinge(x, eps):
    """The C2-smooth hinge: 0 below 0, x - eps/2 above eps, and
    x^3/eps^2 - x^4/(2 eps^3) between."""
    xp = torch.clamp(x, min=0.0)
    return torch.where(xp < eps, xp ** 3 / eps ** 2 - xp ** 4 / (2 * eps ** 3),
                       xp - 0.5 * eps)


# Gauss-Legendre with 3 points is exact for the squared jerk (degree 4)
_GL3_X = (0.5 - math.sqrt(0.15), 0.5, 0.5 + math.sqrt(0.15))
_GL3_W = (5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0)


def jerk_energy(coeffs, times, weights):
    """The weighted integral of the squared jerk of (yaw, s), (B,)."""
    e = 0.0
    for x, w in zip(_GL3_X, _GL3_W):
        j = spline.eval_local(coeffs, times * x, 3)          # (B, N, 2)
        e = e + w * times * torch.sum(weights * j * j, -1)
    return torch.sum(e, -1)


def node_derivatives(coeffs, times, n_sub):
    """(yaw, s) and its first two derivatives at the n_sub + 1 panel ends
    of every piece, each (B, N, n_sub + 1, 2), and the trapezoid weight
    of each node (B, N, n_sub + 1)."""
    frac = torch.arange(n_sub + 1, dtype=times.dtype) / n_sub
    tau = times[..., None] * frac
    c = coeffs[:, :, None].expand(*tau.shape, 6, 2)
    d = [spline.eval_local(c, tau, k) for k in range(3)]
    w = torch.ones(n_sub + 1, dtype=times.dtype)
    w[0] = w[-1] = 0.5
    return d, w * (times / n_sub)[..., None]


def kinodynamic(d, wq, b, acc_w, domega_w, moment_w, cen_w):
    """Penalties on the configuration's limits at the nodes, (B,)."""
    _, d1, d2 = d
    dyaw, ds, ddyaw, dds = d1[..., 0], d1[..., 1], d2[..., 0], d2[..., 1]
    eps = b["smooth_eps"]

    def cost(v):
        return torch.sum(wq * hinge(v, eps), (-2, -1))

    vmax, wmax, vmin = b["max_vel"], b["max_omega"], b["min_vel"]
    out = acc_w * cost(dds * dds - b["max_acc"] ** 2)
    out = out + domega_w * cost(ddyaw * ddyaw - b["max_domega"] ** 2)
    # the velocity diamond: |v| / vmax + |omega| / wmax <= 1, v >= vmin
    for sgn in (-1.0, 1.0):
        out = out + moment_w * cost(sgn * vmax * dyaw + wmax * ds
                                    - vmax * wmax)
        out = out + moment_w * cost(-sgn * vmin * dyaw - wmax * ds
                                    + vmin * wmax)
    out = out + cen_w * cost(dyaw * dyaw * ds * ds - b["max_cen_acc"] ** 2)
    return out


class Problem:
    """One request: its start, goal and front-end guess, the map's
    distance field and the configuration, in the working dtype."""

    def __init__(self, req, dist, cfg, dtype):
        self.cfg, self.dtype = cfg, dtype
        b = cfg["backend"]
        self.b = b
        self.xv = 0.0 if b["standard_diff"] else b["icr_xv"]
        self.head = req["start_state"].to(dtype)
        self.final = req["final_state"].to(dtype)
        self.start_xy = req["start_xytheta"][:, :2].to(dtype)
        self.goal_xy = req["final_xytheta"][:, :2].to(dtype)
        self.piece_ends = req["inner_positions"][..., :2].to(dtype)
        self.inner0 = req["inner_yaw_s"].to(dtype)
        self.t0 = req["init_piece_time"].to(dtype)
        self.N = self.piece_ends.shape[1]
        self.dist = dist.to(dtype)
        m = cfg["map"]
        self.lower, self.res = m["lower"], m["res"]
        self.ew = torch.tensor(cfg["energy_weights"], dtype=dtype)
        self.cps = torch.tensor(cfg["checkpoints"], dtype=dtype)
        # the clearance asked for: less where the start itself is near an
        # obstacle (the cell it lies in, 85% of its distance)
        H, W = self.dist.shape
        ij = torch.floor((self.start_xy[0].double()
                          - torch.tensor(self.lower, dtype=torch.float64))
                         / self.res).long()
        d0 = self.dist[min(max(int(ij[0]), 0), H - 1),
                       min(max(int(ij[1]), 0), W - 1)]
        self.safe = torch.clamp(0.85 * d0, max=b["safe_dis"])

    # decision vector: inner (2, N-1) row-major, tail s, virtual times (N)
    def pack(self, inner, tail_s, tau):
        return torch.cat([inner.reshape(-1), tail_s.reshape(1), tau])

    def unpack(self, x):
        n = 2 * (self.N - 1)
        return x[:n].reshape(1, 2, self.N - 1), x[n:n + 1], x[n + 1:][None]

    def spline_of(self, inner, tail_s, times):
        tail = self.final.clone()
        tail[:, 1, 0] = tail_s
        return spline.minco_coeffs(self.head, tail, inner, times)

    def terms(self, inner, tail_s, times, w, time_w):
        """(objective without the final-XY term, final-XY residual) of
        the plan (inner, tail_s, times), under weights w."""
        b = self.b
        coeffs = self.spline_of(inner, tail_s, times)
        n_sub = b["sparse_resolution"]
        nodes, end = spline.simpson_nodes(coeffs, times, self.start_xy,
                                          self.xv, n_sub)
        d, wq = node_derivatives(coeffs, times, n_sub)
        f = jerk_energy(coeffs, times, self.ew)
        f = f + kinodynamic(d, wq, b, w["acc_weight"], w["domega_weight"],
                            w["moment_weight"], w.get("cen_acc_weight", 0.0))
        f = f + time_w * torch.sum(times, -1)
        if "collision_weight" in w:
            yaw = d[0][..., 0]
            c, s = torch.cos(yaw), torch.sin(yaw)
            bx = nodes[..., 0:1] + c[..., None] * self.cps[:, 0] \
                - s[..., None] * self.cps[:, 1]
            by = nodes[..., 1:2] + s[..., None] * self.cps[:, 0] \
                + c[..., None] * self.cps[:, 1]
            dist = spline.bilinear(self.dist, self.lower, self.res,
                                   torch.stack([bx, by], -1))
            f = f + w["collision_weight"] * torch.sum(
                wq[..., None] * hinge(self.safe - dist, b["smooth_eps"]),
                (1, 2, 3))
        else:
            err = nodes[:, :, -1] - self.piece_ends
            f = f + w["bigpath_weight"] * torch.sum(err * err, (1, 2))
        return f, end - self.goal_xy

    def objective(self, inner, tail_s, times):
        """The stage-2 objective at the configuration's time weight,
        without the final-XY term: what a plan is judged by, (B,)."""
        w = self.cfg["weights"]
        return self.terms(inner, tail_s, times, w, w["time_weight"])[0]

    def clearance(self, coeffs, times):
        """Least distance of the flow at the final check's resolution."""
        nodes, _ = spline.simpson_nodes(
            coeffs, times, self.start_xy, self.xv,
            self.b["final_check_resolution"])
        d = spline.bilinear(self.dist, self.lower, self.res,
                            nodes.reshape(1, -1, 2))
        return torch.amin(d, -1)


def _guarded(x, f):
    """f, or INF (with a zero gradient) where x has run away."""
    far = torch.linalg.vector_norm(x.detach()) > 1e4
    return torch.where(far, torch.full_like(f, INF), f)


def value_and_grad(fn, x):
    with torch.enable_grad():
        q = x.detach().requires_grad_(True)
        f = fn(q)
        (g,) = torch.autograd.grad(f, q)
    return f.detach(), g


def lbfgs(fn, x, p):
    """Minimise fn (a scalar of the vector x) by L-BFGS; p: mem_size,
    past, delta, min_step, hard_iter_cap and the line search's
    f_dec_coeff, s_curv_coeff, max_linesearch.  Stops when the objective
    fell by less than delta (relative) over the last `past` iterations,
    at the iteration cap, or when the line search fails (keeping the
    last accepted point).  Returns (x, iterations)."""
    f, g = value_and_grad(fn, x)
    hist = [float(f)]
    S, Y = [], []
    d = -g
    step = 1.0 / max(float(torch.linalg.vector_norm(g.double())), 1e-30)
    k = 1
    while True:
        ok, x_n, f_n, g_n = _line_search(fn, x, f, g, d, step, p)
        if not ok:
            break
        s, y = x_n - x, g_n - g
        g_old = g
        x, f, g = x_n, f_n, g_n
        past = max(p["past"], 1)
        if k >= past and abs(hist[-past] - float(f)) \
                / max(abs(float(f)), 1.0) < p["delta"]:
            break
        hist.append(float(f))
        if k >= p["hard_iter_cap"]:
            break
        ys = float(torch.dot(y, s))
        if ys > float(torch.dot(s, s)) * float(
                torch.linalg.vector_norm(g_old)) * 1e-6:
            S.append(s)
            Y.append(y)
            if len(S) > p["mem_size"]:
                S.pop(0)
                Y.pop(0)
            d = _two_loop(S, Y, g)
        else:
            d = -g
        step = 1.0
        k += 1
    return x, k


def _two_loop(S, Y, g):
    q = g.clone()
    alphas = []
    for s, y in zip(reversed(S), reversed(Y)):
        a = torch.dot(s, q) / torch.dot(y, s)
        q = q - a * y
        alphas.append(a)
    q = q * (torch.dot(Y[-1], S[-1]) / torch.dot(Y[-1], Y[-1]))
    for (s, y), a in zip(zip(S, Y), reversed(alphas)):
        bta = torch.dot(y, q) / torch.dot(y, s)
        q = q + (a - bta) * s
    return -q


def _line_search(fn, x, f, g, d, step, p):
    """Lewis-Overton: double the step until the Armijo test fails, then
    bisect the bracket until both weak-Wolfe tests hold."""
    dg0 = float(torch.dot(g, d))
    if not dg0 < 0:
        return False, x, f, g
    lo, hi, bracketed = 0.0, 1e20, False
    for _ in range(p.get("max_linesearch", 64)):
        x_n = x + step * d
        f_n, g_n = value_and_grad(fn, x_n)
        fv = float(f_n)
        if not math.isfinite(fv):
            return False, x, f, g
        fast = abs(float(f) - fv) / (abs(float(f)) + 1.0) \
            < p["delta"] / max(p["past"], 1)
        armijo = fv <= float(f) + step * p.get("f_dec_coeff", 1e-4) * dg0
        wolfe = float(torch.dot(g_n, d)) >= p.get("s_curv_coeff", 0.9) * dg0
        if (armijo and wolfe) or fast:
            return True, x_n, f_n, g_n
        if not armijo:
            hi, bracketed = step, True
        else:
            lo = step
        step = 0.5 * (lo + hi) if bracketed else 2.0 * step
        if step < p["min_step"] or (bracketed and hi - lo < 1e-16 * hi):
            return False, x, f, g
    return False, x, f, g


def solve(prob: Problem):
    """The plan for one request: dict of inner (1, 2, N-1), tail_s (1,),
    times (1, N), and the attempts of the collision loop."""
    cfg, dt = prob.cfg, prob.dtype
    x0 = prob.pack(prob.inner0[0], prob.final[0, 1, 0],
                   virtual_time(prob.t0.expand(prob.N)))

    def stage1(x):
        inner, tail_s, tau = prob.unpack(x)
        w = cfg["path_weights"]
        f, _ = prob.terms(inner, tail_s, real_time(tau), w, w["time_weight"])
        return _guarded(x, f[0])

    p1 = dict(cfg["path_lbfgs"])
    if abs(float(prob.final[0, 1, 0])) < cfg["short_path"]["horizon"]:
        p1["past"] = cfg["short_path"]["past"]
    x1, _ = lbfgs(stage1, x0, p1)

    alm = cfg["alm"]
    time_w = cfg["weights"]["time_weight"]
    lim = prob.b["final_min_safe_dis"]
    for attempt in range(1, prob.b["max_collision_replans"] + 1):
        lam = torch.tensor(alm["lambda0"], dtype=dt)
        rho = torch.tensor(alm["rho0"], dtype=dt)
        x = x1
        for _ in range(alm["max_outer"]):
            def stage2(q, lam=lam, rho=rho):
                inner, tail_s, tau = prob.unpack(q)
                f, h = prob.terms(inner, tail_s, real_time(tau),
                                  cfg["weights"], time_w)
                f = f[0] + 0.5 * torch.sum(rho * (h[0] + lam / rho) ** 2)
                return _guarded(q, f)

            x, _ = lbfgs(stage2, x, cfg["lbfgs"])
            inner, tail_s, tau = prob.unpack(x)
            _, h = prob.terms(inner, tail_s, real_time(tau), cfg["weights"],
                              time_w)
            h = h[0].detach()
            lam = lam + rho * h
            rho = torch.minimum((1.0 + torch.tensor(alm["gamma"], dtype=dt))
                                * rho, torch.tensor(alm["rho_max"], dtype=dt))
            if float(torch.linalg.vector_norm(h.double())) < alm["tolerance"]:
                break
        inner, tail_s, tau = prob.unpack(x.detach())
        times = real_time(tau)
        clear = float(prob.clearance(prob.spline_of(inner, tail_s, times),
                                     times)[0]) >= lim
        if clear:
            break
        time_w = time_w * 0.75
    return {"inner": inner, "tail_s": tail_s, "times": times,
            "attempts": attempt}
