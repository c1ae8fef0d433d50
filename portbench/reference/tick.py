"""Plain closed-loop tick: NMPC real-time iteration, ICR-EKF, plant.

The reference for the tracking cells' `correct`, in any dtype (float64
for the reference, bfloat16 for the control), written from the
controller's equations and sharing no code with the program:

  * NMPC (ACADO RTI, UAV_CAR_model.cpp): exact discrete ICR step,
    Jacobians by forward-mode autodiff, sequential condensing into a
    dense 2N-variable box QP, and the projected preconditioned-CG
    Newton iteration the controller runs (4 outer steps of 15 CG trips,
    the four-point projected line search);
  * ICR-EKF (icrekf.cpp): Euler predict on the applied wheels with its
    Jacobian by autodiff, pose update with the yaw unwrapped;
  * plant (simulator.h): 5 substeps of the rate-limited noisy body
    velocities through the true ICR.

State dicts hold float tensors with a leading lane axis.
"""
from __future__ import annotations

import math

import torch

from .spline import WorldTraj, gauss_solve

NX, NU = 3, 2


def _sinc_half(h):
    """sin(h/2) / (h/2), its series near 0."""
    half = 0.5 * h
    small = torch.abs(half) < 1e-4
    safe = torch.where(small, torch.ones_like(half), half)
    return torch.where(small, 1.0 - half * half / 6.0, torch.sin(safe) / safe)


def exact_step(x, u, yr, yl, xv, dt):
    """Exact step of the ICR model under constant wheels (vr, vl)."""
    psi = x[..., 2]
    track = yl - yr
    v = (u[..., 0] * yl - u[..., 1] * yr) / track
    w = (u[..., 0] - u[..., 1]) / track
    h = w * dt
    sc = _sinc_half(h)
    ic = dt * sc * torch.cos(psi + 0.5 * h)
    is_ = dt * sc * torch.sin(psi + 0.5 * h)
    return torch.stack([x[..., 0] + v * ic + w * xv * is_,
                        x[..., 1] + v * is_ - w * xv * ic, psi + h], -1)


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _shift_within(prev, cur, half_width):
    k = torch.ceil((cur - prev - half_width) / (2 * math.pi))
    cur = cur - 2 * math.pi * torch.clamp(k, min=0.0)
    k = torch.ceil((prev - cur - half_width) / (2 * math.pi))
    return cur + 2 * math.pi * torch.clamp(k, min=0.0)


def ref_points(traj: WorldTraj, t_now, n, dt, yaw_est):
    """The controller's references at t_now + dt, ..., t_now + (n+1) dt:
    states (B, 3, n+1) with the yaw unwrapped from the estimate along the
    horizon (steps above pi/2 folded back), and wheel speeds (vr, vl)
    (B, 2, n+1) through the trajectory's ICR, zero past its end."""
    B, Bt = yaw_est.shape[0], traj.times.shape[0]
    k = torch.arange(1, n + 2, dtype=yaw_est.dtype, device=yaw_est.device)
    ts = (t_now + dt * k).expand(Bt, n + 1)
    inside = ts <= traj.duration[:, None]
    tq = torch.minimum(torch.clamp(ts, min=0.0), traj.duration[:, None])
    pose = traj.pose(tq).expand(B, n + 1, 3)
    vel = traj.flat_velocity(tq)
    yr, yl = traj.icr[:, 0:1], traj.icr[:, 1:2]
    vl = torch.where(inside, vel[..., 1] - vel[..., 0] * yl, 0.0)
    vr = torch.where(inside, vel[..., 1] - vel[..., 0] * yr, 0.0)
    vl, vr = vl.expand(B, n + 1), vr.expand(B, n + 1)
    yaw = _wrap(pose[..., 2])
    prev = _shift_within(yaw_est, yaw[:, 0], math.pi / 2)
    seq = [prev]
    for i in range(1, n + 1):
        prev = _shift_within(prev, yaw[:, i], math.pi / 2)
        seq.append(prev)
    ref_x = torch.stack([pose[..., 0], pose[..., 1], torch.stack(seq, 1)], 1)
    return ref_x, torch.stack([vr, vl], 1)


def _jacobians(x, u, yr, yl, xv, dt):
    """exact_step and its Jacobians in x (.., 3, 3) and u (.., 3, 2)."""
    # jacfwd returns this step's bfloat16 Jacobian in float64: it is
    # rounded back to the working dtype
    def f(xu, a, b, c):
        return exact_step(xu[:NX], xu[NX:], a, b, c, dt)
    jac = torch.func.vmap(torch.func.jacfwd(f))
    shp = x.shape[:-1]
    args = [t.reshape(-1, *t.shape[len(shp):]) for t in
            (torch.cat([x, u], -1), yr.expand(shp), yl.expand(shp),
             xv.expand(shp))]
    J = jac(*args).reshape(*shp, NX, NX + NU).to(x.dtype)
    return exact_step(x, u, yr, yl, xv, dt), J[..., :NX], J[..., NX:]


def _pncg(H, g, lb, ub, iters, cg_iters, reg=1e-7):
    """min 1/2 z'Hz + g'z on lb <= z <= ub: per outer step, Jacobi-
    preconditioned CG on the free variables' Newton system, then the best
    of the steps 1, the exact minimiser along it, 1/2 and 1/8, projected,
    if it lowers the objective."""
    def mv(p):
        return torch.einsum("bij,b...j->b...i", H, p)

    def dot(a, b):
        return torch.sum(a * b, -1)

    def safe(x):
        return torch.where(torch.abs(x) > 1e-30, x, torch.full_like(x, 1e-30))

    z = torch.minimum(torch.maximum(torch.zeros_like(g), lb), ub)
    dinv = torch.diagonal(H, dim1=-2, dim2=-1) + reg
    for _ in range(iters):
        grad = mv(z) + g
        held = ((z <= lb) & (grad > 0)) | ((z >= ub) & (grad < 0))
        free = (~held).to(g.dtype)

        def op(p):
            return free * mv(free * p) + (1 - free) * p + reg * p

        b = -grad * free
        minv = free / dinv + (1 - free)
        x = torch.zeros_like(b)
        hx = torch.zeros_like(b)
        r = b
        p = minv * r
        rz = dot(r, p)
        for _ in range(cg_iters):
            ap = op(p)
            a = (rz / safe(dot(p, ap)))[..., None]
            x, hx, r = x + a * p, hx + a * ap, r - a * ap
            zr = minv * r
            rz_new = dot(r, zr)
            p = zr + (rz_new / safe(rz))[..., None] * p
            rz = rz_new
        a_star = torch.clamp(-dot(grad, x) / safe(dot(x, hx)), 0.0, 1.0)
        steps = torch.stack([torch.ones_like(a_star), a_star,
                             torch.full_like(a_star, 0.5),
                             torch.full_like(a_star, 0.125)], 1)
        zt = z[:, None] + steps[..., None] * x[:, None]
        zt = torch.minimum(torch.maximum(zt, lb[:, None]), ub[:, None])
        d = zt - z[:, None]
        df = dot(grad[:, None], d) + 0.5 * dot(d, mv(d))
        best = torch.argmin(df, 1)
        lanes = torch.arange(g.shape[0], device=g.device)
        z = torch.where((df[lanes, best] < 0)[:, None], zt[lanes, best], z)
    return z


def nmpc_rti(x_traj, u_traj, x_est, ref_x, ref_u, yr, yl, xv, cfg):
    """One RTI tick.  x_traj (B, N+1, 3), u_traj (B, N, 2), x_est (B, 3),
    ICR (B,) each.  Returns (x_traj, u_traj) of the new guess and the
    command u_traj[:, delay]."""
    B, n = u_traj.shape[:2]
    dt = cfg["dt"]
    x_int, A, Bm = _jacobians(x_traj[:, :-1], u_traj, yr[:, None],
                              yl[:, None], xv[:, None], dt)
    defect = x_int - x_traj[:, 1:]
    C = x_traj.new_zeros((B, n + 1, NX, n * NU))
    a_off = x_traj.new_zeros((B, n + 1, NX))
    a_off[:, 0] = x_est - x_traj[:, 0]
    for i in range(n):
        C[:, i + 1] = A[:, i] @ C[:, i]
        C[:, i + 1, :, NU * i:NU * i + NU] = Bm[:, i]
        a_off[:, i + 1] = (A[:, i] @ a_off[:, i, :, None])[..., 0] \
            + defect[:, i]
    q = torch.tensor(cfg["q_diag"], dtype=x_traj.dtype, device=x_traj.device)
    r = torch.tensor(cfg["r_diag"], dtype=x_traj.dtype, device=x_traj.device)
    qs = torch.cat([torch.zeros_like(q)[None], q.expand(n, NX)], 0)
    rx = x_traj + a_off - ref_x.transpose(1, 2)
    ru = u_traj - ref_u.transpose(1, 2)[:, :n]
    Cf = C.reshape(B, (n + 1) * NX, n * NU)
    qf = qs.reshape(-1)
    H = Cf.transpose(1, 2) @ (qf[None, :, None] * Cf) \
        + torch.diag(r.repeat(n))
    g = (Cf.transpose(1, 2) @ (qf * rx.reshape(B, -1))[..., None])[..., 0] \
        + (r * ru).reshape(B, -1)
    u_flat = u_traj.reshape(B, -1)
    du = _pncg(H, g, cfg["u_min"] - u_flat, cfg["u_max"] - u_flat,
               cfg["qp_iters"], cfg["cg_iters"])
    u_new = u_traj + du.reshape(B, n, NU)
    x_new = x_traj + (Cf @ du[..., None])[..., 0].reshape(B, n + 1, NX) \
        + a_off
    return x_new, u_new, u_new[:, cfg["delay_num"]]


def _ekf_model(x6, u, dt):
    x, y, psi, yr, yl, xv = x6.unbind(-1)
    track = yl - yr
    v = (u[..., 1] * yl - u[..., 0] * yr) / track
    w = (u[..., 1] - u[..., 0]) / track
    c, s = torch.cos(psi), torch.sin(psi)
    return torch.stack([x + dt * (v * c + w * xv * s),
                        y + dt * (v * s - w * xv * c),
                        psi + dt * w, yr, yl, xv], -1)


def ekf_predict(x, P, u_vl_vr, dt, q_diag):
    F = torch.func.vmap(torch.func.jacfwd(
        lambda a, b: _ekf_model(a, b, dt)))(x, u_vl_vr).to(x.dtype)
    Q = torch.diag(torch.tensor(q_diag, dtype=x.dtype, device=x.device))
    return _ekf_model(x, u_vl_vr, dt), F @ P @ F.transpose(1, 2) + dt * dt * Q


def ekf_update(x, P, obs, r_diag):
    yaw = obs[:, 2] + 2 * math.pi * torch.round(
        (x[:, 2] - obs[:, 2]) / (2 * math.pi))
    innov = torch.stack([obs[:, 0], obs[:, 1], yaw], 1) - x[:, :3]
    R = torch.diag(torch.tensor(r_diag, dtype=x.dtype, device=x.device))
    S = P[:, :3, :3] + R
    # K = P H' S^-1, with S symmetric: K' = S^-1 (H P)
    K = gauss_solve(S, P[:, :3, :]).transpose(1, 2)
    Hm = torch.zeros((3, 6), dtype=x.dtype, device=x.device)
    Hm[:, :3] = torch.eye(3, dtype=x.dtype, device=x.device)
    eye = torch.eye(6, dtype=x.dtype, device=x.device)
    return x + (K @ innov[..., None])[..., 0], (eye - K @ Hm) @ P


def plant_substep(p, vl, vr, true_icr, dt, noise, cfg):
    """One substep; p: dict of xytheta (B, 3), v, omega (B,), s (B,)."""
    yr, yl, xv = true_icr
    track = yl - yr
    w_des = (vr - vl) / track
    v_des = (vl + vr) / 2 - w_des * (yl + yr) / 2
    vy = -w_des * xv
    v_des = v_des * (1 + cfg["noise_stddev"] * noise[:, 0])
    w_des = w_des * (1 + cfg["noise_stddev"] * noise[:, 1])
    lim = cfg["rate_limit_dt"]
    v = p["v"] + torch.clamp(v_des - p["v"], -cfg["max_acc"] * lim,
                             cfg["max_acc"] * lim)
    w = p["omega"] + torch.clamp(w_des - p["omega"], -cfg["max_domega"] * lim,
                                 cfg["max_domega"] * lim)
    x, y, th = p["xytheta"].unbind(-1)
    x = x + v * dt * torch.cos(th)
    y = y + v * dt * torch.sin(th)
    th = th + w * dt
    x = x - vy * dt * torch.sin(th)
    y = y + vy * dt * torch.cos(th)
    return {"xytheta": torch.stack([x, y, th], -1), "v": v, "omega": w,
            "vy": vy, "s": p["s"] + v * dt}


def tick(state, noise, t, traj: WorldTraj, true_icr, cfg):
    """One closed-loop tick from `state` (dict: plant dict, ekf_x (B, 6),
    ekf_P (B, 6, 6), x_traj, u_traj, u_prev (B, 2) as (vr, vl)) with the
    plant noise (B, substeps, 2) at time t.  Returns the next state and
    the command."""
    nm = cfg["nmpc"]
    ex = state["ekf_x"]
    ref_x, ref_u = ref_points(traj, t, nm["horizon"], nm["dt"], ex[:, 2])
    x_new, u_new, u_cmd = nmpc_rti(state["x_traj"], state["u_traj"],
                                   ex[:, :3], ref_x, ref_u, ex[:, 3],
                                   ex[:, 4], ex[:, 5], nm)
    vl, vr = state["u_prev"][:, 1], state["u_prev"][:, 0]
    x6, P = ekf_predict(ex, state["ekf_P"], torch.stack([vl, vr], 1),
                        nm["dt"], cfg["ekf"]["q_diag"])
    plant = state["plant"]
    sub = cfg["substeps"]
    for j in range(sub):
        plant = plant_substep(plant, vl, vr, true_icr, nm["dt"] / sub,
                              noise[:, j], cfg["plant"])
    x6, P = ekf_update(x6, P, plant["xytheta"], cfg["ekf"]["r_diag"])
    return {"plant": plant, "ekf_x": x6, "ekf_P": P, "x_traj": x_new,
            "u_traj": u_new, "u_prev": u_cmd}, u_cmd
