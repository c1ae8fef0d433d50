"""MINCO back-end trajectory optimizer (port of planner/backend.py,
flat-BFGS ring path).

  stage 1  path pre-process (costFunctionCallbackPath :1272-1591)
  stage 2  energy + kinodynamic + collision penalties under an
           augmented-Lagrangian loop on the final-XY equality
           (costFunctionCallback :631-692, attachPenaltyFunctional
           :694-1067, ALM update :376-418)
  outer    collision re-check with annealed time weight
           (minco_plan :169-220, check_final_collision :474-571)

Decision vector per lane (optimizer.cpp:263-287): the 2(N-1) inner
points (yaw, s), the relaxed tail arc length S and N virtual times tau.
Every cost is a function of a (B, n) leaf; `torch.autograd.grad(cost.sum(),
x)` gives the per-lane gradients, since the lanes never mix.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..core.flow import simpson_flow_positions
from ..core.smoothing import positive_smoothed_l1
from ..ops.esdf import (ESDF, dist_at_cell, pack_corner_grid,
                        sample_dist_bilinear, sample_dist_bilinear_packed)
from ..solvers.bfgs import alm_minimize, flat_lbfgs_minimize
from ..solvers.lbfgs import LbfgsParams, lbfgs_minimize
from ..solvers.minco import minco_coeffs, minco_energy
from .flat_traj import FlatTraj

INF = 1e30


class BackendWeights(NamedTuple):
    time_weight: float = 50.0
    acc_weight: float = 300.0
    domega_weight: float = 300.0
    collision_weight: float = 500000.0
    moment_weight: float = 300.0
    mean_time_weight: float = 300.0
    cen_acc_weight: float = 300.0


class PathWeights(NamedTuple):
    time_weight: float = 20.0
    bigpath_weight: float = 200000.0
    mean_time_weight: float = 100.0
    moment_weight: float = 1000.0
    acc_weight: float = 100.0
    domega_weight: float = 100.0


class AlmConfig(NamedTuple):
    """ALM schedule; (normal, cut) variants from global_planning3ms.yaml."""

    lambda0: tuple = (0.0, 0.0)
    rho0: tuple = (10000.0, 10000.0)
    rho_max: tuple = (1e10, 1e10)
    gamma: tuple = (9.0, 9.0)
    tolerance: float = 0.01
    max_outer: int = 10


CUT_ALM = AlmConfig(rho0=(1000.0, 1000.0), gamma=(5.0, 5.0), tolerance=0.5)


class BackendConfig(NamedTuple):
    max_vel: float = 3.0
    min_vel: float = 0.0
    max_acc: float = 2.0
    max_omega: float = 3.0
    max_domega: float = 4.0
    max_cen_acc: float = 50.0
    directly_constrain_v_omega: bool = False
    smooth_eps: float = 0.01
    sparse_resolution: int = 8
    safe_dis: float = 0.6
    final_min_safe_dis: float = 0.10
    final_check_resolution: int = 16
    max_collision_replans: int = 3
    checkpoints: tuple = ((0.3, 0.0), (-0.3, 0.0))
    icr_xv: float = 0.2
    standard_diff: bool = False
    energy_weights: tuple = (0.33, 1.0)
    weights: BackendWeights = BackendWeights()
    path_weights: PathWeights = PathWeights()
    alm: AlmConfig = AlmConfig()
    cut_alm: AlmConfig = CUT_ALM
    lbfgs: LbfgsParams = LbfgsParams(mem_size=64, past=3, g_epsilon=0.0,
                                     min_step=1e-32, delta=5e-4,
                                     max_iterations=0, hard_iter_cap=600)
    path_lbfgs: LbfgsParams = LbfgsParams(mem_size=64, past=2, g_epsilon=0.0,
                                          min_step=0.0, delta=5e-2,
                                          max_iterations=0, hard_iter_cap=300)
    shot_path_past: int = 8
    shot_path_horizon: float = 0.5
    flat_bfgs: bool = True
    solver_direction: str = "ring"


# ---------------------------------------------------------------------------
# virtual <-> real time maps (optimizer.cpp:573-591)
# ---------------------------------------------------------------------------

def virtual_to_real_time(tau):
    return torch.where(tau > 0.0,
                       (0.5 * tau + 1.0) * tau + 1.0,
                       1.0 / ((0.5 * tau - 1.0) * tau + 1.0))


def real_to_virtual_time(T):
    return torch.where(T > 1.0,
                       torch.sqrt(2.0 * T - 1.0) - 1.0,
                       1.0 - torch.sqrt(2.0 / torch.clamp(T, min=1e-12) - 1.0))


# ---------------------------------------------------------------------------
# decision-vector packing: inner (B, 2, N-1) in column-major order
# ---------------------------------------------------------------------------

def pack_vars(inner, tail_s, tau):
    B = inner.shape[0]
    return torch.cat([inner.transpose(1, 2).reshape(B, -1),
                      tail_s[:, None], tau], dim=1)


def unpack_vars(x, n_pieces):
    B = x.shape[0]
    n_inner = 2 * (n_pieces - 1)
    inner = x[:, :n_inner].reshape(B, n_pieces - 1, 2).transpose(1, 2)
    return inner, x[:, n_inner], x[:, n_inner + 1:]


# ---------------------------------------------------------------------------
# penalty functional (attachPenaltyFunctional, optimizer.cpp:694-1067)
# ---------------------------------------------------------------------------

def _even_node_weights(times, n_sub):
    """omega * step at the even Simpson nodes, (B, N, n_sub + 1)."""
    w = torch.ones(n_sub + 1, dtype=times.dtype, device=times.device)
    w[0] = 0.5
    w[-1] = 0.5
    return w * (times / n_sub)[..., None]


def kinodynamic_penalties(samples, times, cfg: BackendConfig,
                          acc_w, domega_w, moment_w, cen_acc_w):
    """Inequality penalties at the even Simpson nodes, (B,).
    optimizer.cpp:829-910."""
    _, dsig, ddsig, _ = samples
    n_sub = cfg.sparse_resolution
    dth = dsig[..., 0::2, 0]
    ds = dsig[..., 0::2, 1]
    ddth = ddsig[..., 0::2, 0]
    dds = ddsig[..., 0::2, 1]
    wq = _even_node_weights(times, n_sub)
    sl1 = partial(positive_smoothed_l1, eps=cfg.smooth_eps)

    def wsum(v):
        return torch.sum(wq * sl1(v), dim=(-2, -1))

    cost = acc_w * wsum(dds * dds - cfg.max_acc ** 2)
    cost = cost + domega_w * wsum(ddth * ddth - cfg.max_domega ** 2)
    if cfg.directly_constrain_v_omega:
        cost = cost + moment_w * wsum(ds * ds - cfg.max_vel ** 2)
        cost = cost + moment_w * wsum(dth * dth - cfg.max_omega ** 2)
    else:
        for sym in (-1.0, 1.0):
            cost = cost + moment_w * wsum(
                sym * cfg.max_vel * dth + cfg.max_omega * ds
                - cfg.max_vel * cfg.max_omega)
        for sym in (-1.0, 1.0):
            cost = cost + moment_w * wsum(
                sym * (-cfg.min_vel) * dth - cfg.max_omega * ds
                + cfg.min_vel * cfg.max_omega)
    cost = cost + cen_acc_w * wsum(dth * dth * ds * ds - cfg.max_cen_acc ** 2)
    return cost


def collision_penalty(node_xy, samples, times, esdf: ESDF, safe_dis,
                      cfg: BackendConfig, corners=None):
    """ESDF clearance penalty at even nodes x body checkpoints, (B,).
    node_xy (B, N, n_sub+1, 2); safe_dis (B,).  optimizer.cpp:912-947."""
    sig = samples[0]
    n_sub = cfg.sparse_resolution
    yaw = sig[..., 0::2, 0]                         # (B, N, n_sub+1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    cps = torch.tensor(cfg.checkpoints, dtype=node_xy.dtype,
                       device=node_xy.device)        # (K, 2)
    bx = node_xy[..., 0:1] + c[..., None] * cps[:, 0] - s[..., None] * cps[:, 1]
    by = node_xy[..., 1:2] + s[..., None] * cps[:, 0] + c[..., None] * cps[:, 1]
    pts = torch.stack([bx, by], dim=-1)              # (B, N, n_sub+1, K, 2)
    if corners is None:
        corners = pack_corner_grid(esdf, pts.shape[0])
    d = sample_dist_bilinear_packed(esdf, corners, pts)
    viola = safe_dis.reshape(-1, 1, 1, 1) - d
    pena = positive_smoothed_l1(viola, cfg.smooth_eps)
    wq = _even_node_weights(times, n_sub)[..., None]
    return cfg.weights.collision_weight * torch.sum(wq * pena, dim=(1, 2, 3))


# ---------------------------------------------------------------------------
# stage costs
# ---------------------------------------------------------------------------

def _tail_with(final_state, tail_s):
    tail = final_state.clone()
    tail[:, 1, 0] = tail_s
    return tail


def _spline(flat: FlatTraj, inner, tail_s, tau):
    times = virtual_to_real_time(tau)
    coeffs = minco_coeffs(flat.start_state, _tail_with(flat.final_state, tail_s),
                          inner, times)
    return coeffs, times


def _xv(cfg: BackendConfig):
    return 0.0 if cfg.standard_diff else cfg.icr_xv


def _guard(x, cost):
    return torch.where(torch.linalg.vector_norm(x, dim=-1) > 1e4,
                       torch.full_like(cost, INF), cost)


def stage1_cost(x, flat: FlatTraj, cfg: BackendConfig):
    """Path pre-process cost (costFunctionCallbackPath :1272-1591), (B,)."""
    n = flat.num_pieces
    inner, tail_s, tau = unpack_vars(x, n)
    coeffs, times = _spline(flat, inner, tail_s, tau)
    pw = cfg.path_weights
    ew = torch.tensor(cfg.energy_weights, dtype=x.dtype, device=x.device)
    cost = minco_energy(coeffs, times, ew)
    node_xy, _, samples = simpson_flow_positions(
        coeffs, times, flat.start_xytheta[:, :2], _xv(cfg),
        cfg.sparse_resolution)
    cost = cost + kinodynamic_penalties(samples, times, cfg, pw.acc_weight,
                                        pw.domega_weight, pw.moment_weight, 0.0)
    err = node_xy[:, :, -1, :] - flat.inner_positions[..., :2]
    cost = cost + pw.bigpath_weight * torch.sum(err * err, dim=(1, 2))
    cost = cost + pw.time_weight * torch.sum(times, dim=-1)
    return _guard(x, cost)


def stage2_cost_aux(x, flat: FlatTraj, esdf: ESDF, safe_dis, lam, rho,
                    cfg: BackendConfig, corners=None):
    """Formal optimization cost (B,) and the final-XY residual h (B, 2).
    lam, rho: (B, 2); safe_dis: (B,)."""
    n = flat.num_pieces
    inner, tail_s, tau = unpack_vars(x, n)
    coeffs, times = _spline(flat, inner, tail_s, tau)
    w = cfg.weights
    ew = torch.tensor(cfg.energy_weights, dtype=x.dtype, device=x.device)
    cost = minco_energy(coeffs, times, ew)
    node_xy, final_xy, samples = simpson_flow_positions(
        coeffs, times, flat.start_xytheta[:, :2], _xv(cfg),
        cfg.sparse_resolution)
    cost = cost + kinodynamic_penalties(samples, times, cfg, w.acc_weight,
                                        w.domega_weight, w.moment_weight,
                                        w.cen_acc_weight)
    cost = cost + collision_penalty(node_xy, samples, times, esdf, safe_dis,
                                    cfg, corners)
    cost = cost + w.time_weight * torch.sum(times, dim=-1)
    h = final_xy - flat.final_xytheta[:, :2]
    cost = cost + 0.5 * (rho[:, 0] * (h[:, 0] + lam[:, 0] / rho[:, 0]) ** 2
                         + rho[:, 1] * (h[:, 1] + lam[:, 1] / rho[:, 1]) ** 2)
    return _guard(x, cost), h


def stage2_cost(x, flat: FlatTraj, esdf: ESDF, safe_dis, lam, rho,
                cfg: BackendConfig):
    return stage2_cost_aux(x, flat, esdf, safe_dis, lam, rho, cfg)[0]


def stage2_cost_breakdown(x, flat: FlatTraj, esdf: ESDF, safe_dis, lam, rho,
                          cfg: BackendConfig):
    """Per-term cost decomposition, each term (B,) (the `ifprint` debug
    output of optimizer.cpp:1040-1051: energy / collision / end-point /
    acc / domega / moment / centripetal / time).  Diagnostic only -- the
    hot path uses stage2_cost.  lam, rho: (B, 2); safe_dis: (B,)."""
    n = flat.num_pieces
    inner, tail_s, tau = unpack_vars(x, n)
    coeffs, times = _spline(flat, inner, tail_s, tau)
    w = cfg.weights
    ew = torch.tensor(cfg.energy_weights, dtype=x.dtype, device=x.device)

    terms = {}
    terms["energy"] = minco_energy(coeffs, times, ew)
    node_xy, final_xy, samples = simpson_flow_positions(
        coeffs, times, flat.start_xytheta[:, :2], _xv(cfg),
        cfg.sparse_resolution)
    terms["acc"] = kinodynamic_penalties(samples, times, cfg, w.acc_weight,
                                         0.0, 0.0, 0.0)
    terms["domega"] = kinodynamic_penalties(samples, times, cfg, 0.0,
                                            w.domega_weight, 0.0, 0.0)
    terms["moment"] = kinodynamic_penalties(samples, times, cfg, 0.0, 0.0,
                                            w.moment_weight, 0.0)
    terms["cen_acc"] = kinodynamic_penalties(samples, times, cfg, 0.0, 0.0,
                                             0.0, w.cen_acc_weight)
    terms["collision"] = collision_penalty(node_xy, samples, times, esdf,
                                           safe_dis, cfg)
    terms["time"] = w.time_weight * torch.sum(times, dim=-1)
    h = final_xy - flat.final_xytheta[:, :2]
    terms["endpoint_alm"] = 0.5 * (
        rho[:, 0] * (h[:, 0] + lam[:, 0] / rho[:, 0]) ** 2
        + rho[:, 1] * (h[:, 1] + lam[:, 1] / rho[:, 1]) ** 2)
    terms["total"] = sum(terms.values())
    terms["final_xy_error"] = torch.linalg.norm(h, dim=-1)
    return terms


def final_xy_error(x, flat: FlatTraj, cfg: BackendConfig):
    inner, tail_s, tau = unpack_vars(x, flat.num_pieces)
    coeffs, times = _spline(flat, inner, tail_s, tau)
    _, final_xy, _ = simpson_flow_positions(
        coeffs, times, flat.start_xytheta[:, :2], _xv(cfg),
        cfg.sparse_resolution)
    return final_xy - flat.final_xytheta[:, :2]


def check_final_collision(coeffs, times, start_xytheta, esdf: ESDF,
                          cfg: BackendConfig):
    """(B,) True where a fine-resolution flow sample dips below
    final_min_safe_dis."""
    node_xy, _, _ = simpson_flow_positions(
        coeffs, times, start_xytheta[:, :2], _xv(cfg),
        cfg.final_check_resolution)
    pts = node_xy.reshape(node_xy.shape[0], -1, 2)
    d = sample_dist_bilinear(esdf, pts)
    return torch.amin(d, dim=-1) < cfg.final_min_safe_dis


# ---------------------------------------------------------------------------
# the full planner (minco_plan + optimizer, optimizer.cpp:169-472)
# ---------------------------------------------------------------------------

class BackendResult(NamedTuple):
    coeffs: torch.Tensor       # (B, N, 6, 2)
    times: torch.Tensor        # (B, N)
    inner: torch.Tensor        # (B, 2, N-1)
    tail_state: torch.Tensor   # (B, 2, 3)
    final_xy_err: torch.Tensor  # (B, 2)
    collision: torch.Tensor    # (B,) bool
    replans: torch.Tensor      # (B,) int
    stage2_iters: torch.Tensor  # (B,) int


def _value_and_grad(cost_fn, z):
    """Per-lane (value, gradient[, aux]) of a (B,)-valued cost."""
    with torch.enable_grad():
        q = z.detach().requires_grad_(True)
        out = cost_fn(q)
        c, aux = out if isinstance(out, tuple) else (out, None)
        (g,) = torch.autograd.grad(c.sum(), q)
    return c.detach(), g, aux


def _take(obj, idx):
    """Lanes `idx` of a FlatTraj / ESDF / tensor (shared ESDF fields and
    a single-map field pass through)."""
    if isinstance(obj, ESDF):
        d = obj.dist[idx] if obj.dist.dim() == 3 else obj.dist
        return obj._replace(dist=d)
    if isinstance(obj, tuple):
        return type(obj)(*(_take(v, idx) for v in obj))
    return obj[idx]


def _alm_stage(x0, flat, esdf, safe_dis, cfg: BackendConfig, alm: AlmConfig,
               time_weight):
    """Stage-2 solve under the ALM outer loop (optimizer.cpp:376-418).
    time_weight: (B,).

    flat_bfgs: the whole ALM program (inner L-BFGS, multiplier updates,
    restarts) is ONE flat loop (solvers/bfgs.py alm_minimize), and the
    equality residual h rides along as an aux output of the cost.
    Otherwise the reference-shaped nested loops: one `lbfgs_minimize`
    per multiplier update, over the lanes whose outer loop still runs."""
    cfg_tw = cfg._replace(weights=cfg.weights._replace(time_weight=0.0))
    B = x0.shape[0]
    dt, dev = x0.dtype, x0.device

    def vec(t):
        return torch.tensor(t, dtype=dt, device=dev).expand(B, 2).clone()

    lam0, rho0 = vec(alm.lambda0), vec(alm.rho0)
    rho_max, gamma = vec(alm.rho_max), vec(alm.gamma)
    corners = pack_corner_grid(esdf, B)     # loop-invariant

    if not cfg.flat_bfgs:
        x = x0.clone()
        lam, rho = lam0, rho0
        iters = torch.zeros(B, dtype=torch.int64, device=dev)
        live = torch.ones(B, dtype=torch.bool, device=dev)
        for _ in range(alm.max_outer):
            idx = torch.nonzero(live).flatten()
            if idx.numel() == 0:
                break
            flat_i, esdf_i = _take(flat, idx), _take(esdf, idx)
            safe_i, tw_i, corners_i = safe_dis[idx], time_weight[idx], \
                corners[idx]
            lam_i, rho_i = lam[idx], rho[idx]

            def fun(z):
                def cost_with_tw(q):
                    c, _ = stage2_cost_aux(q, flat_i, esdf_i, safe_i, lam_i,
                                           rho_i, cfg_tw, corners_i)
                    _, _, tau = unpack_vars(q, flat.num_pieces)
                    return c + tw_i * torch.sum(virtual_to_real_time(tau),
                                                dim=-1)
                f, g, _ = _value_and_grad(cost_with_tw, z)
                return f, g

            xs, _, _, k = lbfgs_minimize(fun, x[idx], cfg.lbfgs)
            h = final_xy_error(xs, flat_i, cfg)
            x[idx] = xs
            iters[idx] = iters[idx] + k
            lam[idx] = lam_i + rho_i * h
            rho[idx] = torch.minimum((1.0 + gamma[idx]) * rho_i, rho_max[idx])
            live[idx] = torch.linalg.vector_norm(h, dim=-1) >= alm.tolerance
        return x, iters

    def fun(z, ostate):
        lam, rho = ostate

        def cost_with_tw(q):
            c, h = stage2_cost_aux(q, flat, esdf, safe_dis, lam, rho, cfg_tw,
                                   corners)
            _, _, tau = unpack_vars(q, flat.num_pieces)
            c = c + time_weight * torch.sum(virtual_to_real_time(tau), dim=-1)
            return c, h

        f, g, h = _value_and_grad(cost_with_tw, z)
        return f, g, (h.detach(),)

    def outer_update(ostate, x, aux):
        lam, rho = ostate
        (h,) = aux
        done = torch.linalg.vector_norm(h, dim=-1) < alm.tolerance
        lam = lam + rho * h
        rho = torch.minimum((1.0 + gamma) * rho, rho_max)
        return (lam, rho), done

    x, f, aux, status, k_total, n_outer = alm_minimize(
        fun, x0, (lam0, rho0), outer_update, cfg.lbfgs,
        max_outer=alm.max_outer, direction=cfg.solver_direction)
    return x, k_total


def _by_lane_mask(mask, run, *args):
    """Run `run(flag, *lanes_of(args))` on the lanes where mask holds
    (flag True) and on the rest (flag False) -- the per-lane twin of a
    lax.cond under vmap -- and scatter the outputs (a tensor or a tuple
    of tensors) back."""
    B = mask.shape[0]
    outs = None
    for flag, sel in ((True, mask), (False, ~mask)):
        idx = torch.nonzero(sel).flatten()
        if idx.numel() == 0:
            continue
        part = run(flag, *(_take(a, idx) for a in args))
        part = part if isinstance(part, tuple) else (part,)
        if outs is None:
            outs = [p.new_zeros((B, *p.shape[1:])) for p in part]
        for o, p in zip(outs, part):
            o[idx] = p
    return tuple(outs)


def plan_backend(flat: FlatTraj, esdf: ESDF,
                 cfg: BackendConfig = BackendConfig()) -> BackendResult:
    """Full back-end plan for a batch of lanes: stage-1 pre-process,
    stage-2 + ALM, collision anneal loop."""
    n = flat.num_pieces
    dtype, dev = flat.start_state.dtype, flat.start_state.device
    B = flat.start_state.shape[0]

    # safe distance shrink near start (optimizer.cpp:176-177)
    start_d = dist_at_cell(esdf, flat.start_xytheta[:, :2]) * 0.85
    safe_dis = torch.clamp(start_d, max=cfg.safe_dis)

    tail_s0 = flat.final_state[:, 1, 0]
    tau0 = real_to_virtual_time(
        flat.init_piece_time[:, None].expand(B, n).to(dtype))
    x0 = pack_vars(flat.inner_yaw_s, tail_s0, tau0)

    # ----- stage 1: path pre-process; short paths use a larger `past`
    short = torch.abs(flat.final_state[:, 1, 0]) < cfg.shot_path_horizon

    def s1(params):
        def run(x0_, flat_):
            def fun(z):
                f, g, _ = _value_and_grad(lambda q: stage1_cost(q, flat_, cfg),
                                          z)
                return f, g
            if cfg.flat_bfgs:
                xs, _, _, _ = flat_lbfgs_minimize(
                    fun, x0_, params, direction=cfg.solver_direction)
            else:
                xs, _, _, _ = lbfgs_minimize(fun, x0_, params)
            return xs
        return run

    p_short = cfg.path_lbfgs._replace(past=cfg.shot_path_past)
    run_short, run_norm = s1(p_short), s1(cfg.path_lbfgs)
    (x1,) = _by_lane_mask(
        short, lambda is_short, x0_, flat_: (run_short if is_short
                                             else run_norm)(x0_, flat_),
        x0, flat)

    # ----- stage 2 + ALM, wrapped in the collision anneal loop -----
    def one_attempt(cut, x_init, flat_, esdf_, safe_, tw):
        return _alm_stage(x_init, flat_, esdf_, safe_, cfg,
                          cfg.cut_alm if cut else cfg.alm, tw)

    x2 = x1.clone()
    tw = torch.full((B,), cfg.weights.time_weight, dtype=dtype, device=dev)
    replans = torch.zeros(B, dtype=torch.int64, device=dev)
    colliding = torch.ones(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    while True:
        active = colliding & (replans < cfg.max_collision_replans)
        idx = torch.nonzero(active).flatten()
        if idx.numel() == 0:
            break
        flat_a = _take(flat, idx)
        xa, ka = _by_lane_mask(
            flat_a.if_cut, one_attempt, x1[idx], flat_a, _take(esdf, idx),
            safe_dis[idx], tw[idx])
        inner, tail_s, tau = unpack_vars(xa, n)
        coeffs, times = _spline(flat_a, inner, tail_s, tau)
        coll = check_final_collision(coeffs, times, flat_a.start_xytheta,
                                     _take(esdf, idx), cfg)
        x2[idx] = xa
        iters[idx] = ka
        colliding[idx] = coll
        tw[idx] = tw[idx] * 0.75
        replans[idx] = replans[idx] + 1

    inner, tail_s, tau = unpack_vars(x2, n)
    coeffs, times = _spline(flat, inner, tail_s, tau)
    h = final_xy_error(x2, flat, cfg)
    return BackendResult(coeffs=coeffs, times=times, inner=inner,
                         tail_state=_tail_with(flat.final_state, tail_s),
                         final_xy_err=h, collision=colliding, replans=replans,
                         stage2_iters=iters)
