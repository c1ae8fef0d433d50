"""Plain closed-loop tick of the LTV-MPC stack: the mpc_controller node
on the ICR-EKF estimate, and the simulator's (v, omega) CarState path.

The reference for the LTV cells' `correct`, in any dtype (float64 for
the reference, bfloat16 for the control), written from the upstream
equations (planning_ddr_opt mpc_controller, src/mpc.cpp; simulator.h)
and sharing no code with the program:

  * references (getRefPoints, mpc.cpp:634-691): the route's pose and
    flat velocities (sdot, yawdot) at t + dt, ..., t + T dt, clamped at
    its end; the yaw wrapped, then unwrapped sample by sample from the
    estimate's with a pi/2 threshold (smooth_yaw, :538-567);
  * rollout (predictMotion, :259-302, stateTrans): the position advances
    with the commanded v, unclipped, at the old heading; the heading with
    omega clipped to max_omega; v rides along as the fourth state;
  * linearisation (getLinearModel, :217-232) at each rolled-out state
    x_{d+k}: x_k = A x_{k-1} + B u_k + C, with
    A = [[1, 0, -v s dt], [0, 1, v c dt], [0, 0, 1]],
    B = [[c dt, 0], [s dt, 0], [0, dt]], C = [v s dt th, -v c dt th, 0];
  * the QP of solveMPCV (:304-493) over z = (x_0 .. x_{n-1}, u_0 ..
    u_{n-1}), n = T - delay_num, assembled term by term and row by row:
    the cost Q on (x, y, yaw) against the reference, Q[2] on v against
    its reference, R on (v, omega), Rd on each rate u_{k+1} - u_k; the
    rows [box |u| <= limits; the dynamics, stage 0 absorbing the known
    state; rates within max_acc dt and max_domega dt];
  * OSQP's ADMM on it (:494-532): rho on inequality rows, rho x 1e3 on
    equality rows, sigma 1e-6, relaxation alpha 1.6, a cold start each
    pass, the KKT matrix H + sigma I + A' rho A factored once by a
    Cholesky written out, each step's solve as products with the
    inverse of the factor and of its transpose;
  * the delay buffer (:524-536, :596-616): the first delay_num inputs
    of the plan are the commands already sent; the command is the next;
  * the plant: PoseSubCallback (simulator.h:203-231) adopts the command
    at once; each of the 5 StatePropaCallback steps (:246-262) moves v
    and omega toward zero by max_acc and max_domega times the pose
    publish interval, then integrates the pose over its 2 ms;
  * the ICR-EKF of `reference/tick.py`, predicting on the plant's wheel
    feedback (vl, vr) = (v - omega yl, v - omega yr) through the true
    ICR, updating on the plant's pose plus the measurement error.

Departures from upstream: the passes and ADMM steps are fixed, 3 x 150
(upstream stops the passes once the plan moves less than du_threshold
0.01, and OSQP on its tolerances with adaptive rho and a polish); the
ADMM's solves are products with inverted factors (the same solution,
rounded otherwise), and the Cholesky keeps its pivots positive, which
only a precision too low for the problem ever needs.
"""
from __future__ import annotations

import math

import torch

from .tick import _shift_within, _wrap, ekf_predict, ekf_update

NX, NU = 3, 2


def ref_rows(traj, t, T, dt, yaw_est):
    """xref (B, 4, T) rows (x, y, 0, yaw) and dref (B, 2, T) rows
    (v, omega) at t + dt, ..., t + T dt; the route's lane axis 1."""
    B = yaw_est.shape[0]
    k = torch.arange(1, T + 1, dtype=yaw_est.dtype, device=yaw_est.device)
    tq = torch.minimum(t + dt * k, traj.duration)[None]
    pose = traj.pose(tq).expand(B, T, 3)
    vel = traj.flat_velocity(tq).expand(B, T, 2)
    xref = torch.stack([pose[..., 0], pose[..., 1],
                        torch.zeros_like(pose[..., 0]),
                        smooth_yaw(yaw_est, _wrap(pose[..., 2]))], 1)
    return xref, torch.stack([vel[..., 1], vel[..., 0]], 1)


def smooth_yaw(yaw_est, yaw):
    """smooth_yaw (:538-567): the yaw samples (B, T), each unwrapped from
    the one before, the first from the estimate (B,), with a pi/2
    threshold."""
    prev, seq = yaw_est, []
    for i in range(yaw.shape[1]):
        prev = _shift_within(prev, yaw[:, i], math.pi / 2)
        seq.append(prev)
    return torch.stack(seq, 1)


def rollout(x0, output, cfg):
    """xbar (B, T+1, 4): (x, y, th, v) from x0 (B, 3) under the plan
    output (B, 2, T)."""
    dt = cfg["dt"]
    states = [torch.cat([x0, torch.zeros_like(x0[:, :1])], 1)]
    for j in range(output.shape[2]):
        x, y, th, _ = states[-1].unbind(1)
        v = output[:, 0, j]
        w = torch.clamp(output[:, 1, j], -cfg["max_omega"], cfg["max_omega"])
        states.append(torch.stack([x + v * torch.cos(th) * dt,
                                   y + v * torch.sin(th) * dt,
                                   th + w * dt, v], 1))
    return torch.stack(states, 1)


def linear_model(th, v, dt):
    """getLinearModel at (th, v) (B,): A (B, 3, 3), B (B, 3, 2), C (B, 3)."""
    c, s = torch.cos(th), torch.sin(th)
    one, zero = torch.ones_like(th), torch.zeros_like(th)
    A = torch.stack([torch.stack([one, zero, -v * s * dt], 1),
                     torch.stack([zero, one, v * c * dt], 1),
                     torch.stack([zero, zero, one], 1)], 1)
    Bm = torch.stack([torch.stack([c * dt, zero], 1),
                      torch.stack([s * dt, zero], 1),
                      torch.stack([zero, one * dt], 1)], 1)
    C = torch.stack([v * s * dt * th, -v * c * dt * th, zero], 1)
    return A, Bm, C


def assemble_qp(xbar, xref, dref, cfg):
    """H (B, N, N), g (B, N), A (B, M, N), lb, ub (B, M) of one pass."""
    B, dev, dt_ = xbar.shape[0], xbar.device, xbar.dtype
    T, d, dt = cfg["horizon"], cfg["delay_num"], cfg["dt"]
    n = T - d
    N = (NX + NU) * n
    Q, R, Rd = cfg["q_diag"], cfg["r_diag"], cfg["rd_diag"]

    def xi(k):                          # the columns of state k
        return NX * k

    def ui(k):                          # the columns of input k
        return NX * n + NU * k

    H = torch.zeros((N, N), dtype=dt_, device=dev)
    g = torch.zeros((B, N), dtype=dt_, device=dev)
    for k in range(n):
        # (x - xr)^2 Q0 + (y - yr)^2 Q1 + (yaw - yawr)^2 Q3
        for r, q, row in ((0, Q[0], 0), (1, Q[1], 1), (2, Q[3], 3)):
            H[xi(k) + r, xi(k) + r] += 2 * q
            g[:, xi(k) + r] = -2 * q * xref[:, row, d + k]
        # (v - vr)^2 Q2 + v^2 R0 + omega^2 R1
        H[ui(k), ui(k)] += 2 * (R[0] + Q[2])
        H[ui(k) + 1, ui(k) + 1] += 2 * R[1]
        g[:, ui(k)] = -2 * Q[2] * dref[:, 0, d + k]
    for k in range(n - 1):              # (u_{k+1} - u_k)^2 Rd
        for r in range(NU):
            a, b = ui(k) + r, ui(k + 1) + r
            H[a, a] += 2 * Rd[r]
            H[b, b] += 2 * Rd[r]
            H[a, b] -= 2 * Rd[r]
            H[b, a] -= 2 * Rd[r]

    rows, lo, hi = [], [], []

    def row(entries, low, high):
        """One constraint row: entries {column: (B,) or float}."""
        r = torch.zeros((B, N), dtype=dt_, device=dev)
        for col, val in entries.items():
            r[:, col] = val
        rows.append(r)
        lo.append(torch.as_tensor(low, dtype=dt_, device=dev).expand(B))
        hi.append(torch.as_tensor(high, dtype=dt_, device=dev).expand(B))

    for k in range(n):                  # input boxes
        row({ui(k): 1.0}, -cfg["max_speed"], cfg["max_speed"])
        row({ui(k) + 1: 1.0}, -cfg["max_omega"], cfg["max_omega"])
    for k in range(n):                  # x_k - A x_{k-1} - B u_k = C
        A, Bm, C = linear_model(xbar[:, d + k, 2], xbar[:, d + k, 3], dt)
        if k == 0:
            b = (A @ xbar[:, d, :NX, None])[..., 0] + C
        else:
            b = C
        for r in range(NX):
            e = {xi(k) + r: 1.0, ui(k): -Bm[:, r, 0],
                 ui(k) + 1: -Bm[:, r, 1]}
            if k > 0:
                for c in range(NX):
                    e[xi(k - 1) + c] = e.get(xi(k - 1) + c, 0.0) - A[:, r, c]
            row(e, b[:, r], b[:, r])
    for k in range(n - 1):              # rates
        for r, lim in ((0, cfg["max_acc"]), (1, cfg["max_domega"])):
            row({ui(k) + r: -1.0, ui(k + 1) + r: 1.0}, -lim * dt, lim * dt)
    return (H.expand(B, N, N), g, torch.stack(rows, 1), torch.stack(lo, 1),
            torch.stack(hi, 1))


def cholesky(K):
    """Lower L with L L' = K, (B, n, n), column by column."""
    n = K.shape[-1]
    L = torch.zeros_like(K)
    for j in range(n):
        s = K[:, j:, j] - (L[:, j:, :j] @ L[:, j, :j, None])[..., 0]
        piv = torch.sqrt(torch.clamp(s[:, 0], min=torch.finfo(K.dtype).tiny))
        L[:, j, j] = piv
        L[:, j + 1:, j] = s[:, 1:] / piv[:, None]
    return L


def lower_inverse(L):
    """L^-1 of a lower-triangular (B, n, n), row by row."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    M = torch.zeros_like(L)
    for i in range(n):
        r = eye[i] - (L[:, i:i + 1, :i] @ M[:, :i])[:, 0]
        M[:, i] = r / L[:, i, i, None]
    return M


def admm(H, g, A, lb, ub, iters, rho, sigma=1e-6, alpha=1.6):
    """OSQP's iteration on min z'Hz/2 + g'z, lb <= Az <= ub, from zero."""
    rho_v = torch.where(torch.abs(ub - lb) < 1e-12, rho * 1e3,
                        rho * torch.ones_like(lb))
    At = A.transpose(1, 2)
    n = g.shape[1]
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    Li = lower_inverse(cholesky(H + sigma * eye + At @ (rho_v[..., None] * A)))

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    x = torch.zeros_like(g)
    z = torch.minimum(torch.maximum(torch.zeros_like(lb), lb), ub)
    y = torch.zeros_like(lb)
    for _ in range(iters):
        xt = mv(Li.transpose(1, 2), mv(Li, sigma * x - g
                                       + mv(At, rho_v * z - y)))
        zt = mv(A, xt)
        x = alpha * xt + (1 - alpha) * x
        zr = alpha * zt + (1 - alpha) * z
        z_new = torch.minimum(torch.maximum(zr + y / rho_v, lb), ub)
        y = y + rho_v * (zr - z_new)
        z = z_new
    return x


def ltv_mpc(output, buff, x_est, xref, dref, cfg):
    """One tick of the node: (plan (B, 2, T), delay buffer (B, d, 2),
    command (B, 2) as (v, omega))."""
    T, d = cfg["horizon"], cfg["delay_num"]
    n = T - d
    sent = buff[:, :d].transpose(1, 2)                      # (B, 2, d)
    for _ in range(cfg["sqp_iters"]):
        xbar = rollout(x_est, output, cfg)
        H, g, A, lb, ub = assemble_qp(xbar, xref, dref, cfg)
        z = admm(H, g, A, lb, ub, cfg["admm_iters"], cfg["admm_rho"])
        u = z[:, NX * n:].reshape(-1, n, NU).transpose(1, 2)
        output = torch.cat([sent, u], 2)
    cmd = output[:, :, d]
    if d > 0:
        buff = torch.cat([buff[:, 1:], cmd[:, None]], 1)
    return output, buff, cmd


def plant_tick(p, cmd, cfg, substeps, dt):
    """The plant over one control period under the (v, omega) command."""
    h = dt / substeps
    dv = cfg["max_acc"] * cfg["rate_limit_dt"]
    dw = cfg["max_domega"] * cfg["rate_limit_dt"]
    v, w = cmd[:, 0], cmd[:, 1]
    x, y, th = p["xytheta"].unbind(-1)
    s = p["s"]
    for _ in range(substeps):
        v = torch.where(torch.abs(v) >= dv, v - dv * torch.sign(v),
                        torch.zeros_like(v))
        w = torch.where(torch.abs(w) >= dw, w - dw * torch.sign(w),
                        torch.zeros_like(w))
        x = x + v * h * torch.cos(th)
        y = y + v * h * torch.sin(th)
        th = th + w * h
        s = s + v * h
    return {"xytheta": torch.stack([x, y, th], -1), "v": v, "omega": w,
            "vy": p["vy"], "s": s}


def tick(state, noise, t, traj, true_icr, cfg):
    """One closed-loop tick from `state` (dict: plant dict of xytheta
    (B, 3), v, omega, vy, s (B,); ekf_x (B, 6), ekf_P (B, 6, 6); output
    (B, 2, T), delay_buff (B, d, 2)) with the pose measurement error
    noise (B, 3) at time t.  Returns the next state and the command."""
    ltv = cfg["ltv"]
    dt = ltv["dt"]
    ex = state["ekf_x"]
    xref, dref = ref_rows(traj, t, ltv["horizon"], dt, ex[:, 2])
    output, buff, cmd = ltv_mpc(state["output"], state["delay_buff"],
                                ex[:, :NX], xref, dref, ltv)
    yr, yl, _ = true_icr
    p = state["plant"]
    wheels = torch.stack([p["v"] - p["omega"] * yl,
                          p["v"] - p["omega"] * yr], 1)
    x6, P = ekf_predict(ex, state["ekf_P"], wheels, dt,
                        cfg["ekf"]["q_diag"])
    plant = plant_tick(p, cmd, cfg["plant"], cfg["substeps"], dt)
    x6, P = ekf_update(x6, P, plant["xytheta"] + noise,
                       cfg["ekf"]["r_diag"])
    return {"plant": plant, "ekf_x": x6, "ekf_P": P, "output": output,
            "delay_buff": buff}, cmd
