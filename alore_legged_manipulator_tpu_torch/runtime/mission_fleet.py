"""Batched full-mission runtime (port of runtime/mission_fleet.py).

Every phase of a K-object arrangement mission for a fleet of B missions
at once: kinematic approach under the task FSM's control laws
(b2z1_object_fsm.py:575-642), painting of the other objects into the map
(plan_manager.hpp:470-496), the on-device octile wavefront front end,
MINCO back-end push planning (optimizer.cpp:169-472) and the NMPC +
ICR-EKF closed-loop push.  The JAX program vmaps one mission; here every
tensor carries the leading fleet axis.

The port covers the wavefront front end, the kinematic plant and no
correction legs; the other options raise NotImplementedError.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..control.tracked_traj import build_tracked_traj
from ..core.dynamics import ICRParams
from ..ops.esdf import ESDF, esdf_from_occupancy
from ..ops.wavefront import (_trapezoid_duration, _trapezoid_length,
                             wavefront_path)
from ..planner.backend import BackendConfig, plan_backend
from ..planner.flat_traj import FlatTraj, Polynome
from ..utils.precision import resolve_device, set_precision_policy
from .closed_loop import LoopConfig, simulate_tracking


class FleetFsmConfig(NamedTuple):
    """Kinematic-phase constants (mission/object_fsm.py FsmConfig twin)."""

    max_vx: float = 0.5
    max_wz: float = 0.6
    kp_yaw: float = 2.0
    reach_threshold: float = 0.3
    yaw_gate_deg: float = 15.0
    fsm_dt: float = 0.02


class MissionFleetConfig(NamedTuple):
    backend: BackendConfig = BackendConfig()
    loop: LoopConfig = LoopConfig()
    fsm: FleetFsmConfig = FleetFsmConfig()
    n_pieces: int = 6
    approach_ticks: int = 400
    grasp_ticks: int = 25
    release_ticks: int = 25
    push_ticks: int = 400
    deliver_tol: float = 0.3
    frontend_mode: str = "wavefront"
    plant: str = "kinematic"
    correction_ticks: int = 0
    phys_loop: object = None
    paint_objects: bool = True
    paint_half_extents: tuple = (0.4, 0.4)
    path_max_len: int = 160
    wf_safe_dis: float = 0.2
    distance_weight: float = 1.4
    yaw_weight: float = 0.3


class MissionFleetResult(NamedTuple):
    object_err: torch.Tensor     # (B, K) final object-to-target distance
    delivered: torch.Tensor      # (B, K) bool
    plan_err: torch.Tensor       # (B, K) backend final-XY residual norm
    collision: torch.Tensor      # (B, K) backend post-anneal collision flag
    track_err_max: torch.Tensor  # (B, K) max tracking error during push
    robot_final: torch.Tensor    # (B, 3) robot pose after the mission
    push_traj: torch.Tensor      # (B, K, push_ticks, 3) object pose trace


def _approach(robot, goal_xy, cfg: FleetFsmConfig, n_ticks: int):
    """Waypoint pure-pursuit (b2z1_object_fsm.py:575-642 laws); robot
    (B, 3), goal_xy (B, 2).  Freezes once within reach_threshold."""
    gate = math.radians(cfg.yaw_gate_deg)
    gate = float(torch.tensor(gate, dtype=robot.dtype))
    for _ in range(n_ticks):
        d = goal_xy - robot[:, :2]
        dist = torch.linalg.vector_norm(d, dim=-1)
        yaw_err = torch.atan2(d[:, 1], d[:, 0]) - robot[:, 2]
        yaw_err = torch.remainder(yaw_err + math.pi, 2.0 * math.pi) - math.pi
        w = torch.clamp(cfg.kp_yaw * yaw_err, -cfg.max_wz, cfg.max_wz)
        active = dist > cfg.reach_threshold
        go = (torch.abs(yaw_err) < gate) & active
        vx = torch.where(go, torch.full_like(w, cfg.max_vx),
                         torch.zeros_like(w))
        w = torch.where(active, w, torch.zeros_like(w))
        robot = robot + cfg.fsm_dt * torch.stack(
            [vx * torch.cos(robot[:, 2]), vx * torch.sin(robot[:, 2]), w], -1)
    return robot


def _wavefront_flat(esdf: ESDF, start_xy, start_yaw, goal_xy,
                    cfg: MissionFleetConfig) -> FlatTraj:
    """On-device front end: octile wavefront field -> greedy path ->
    static-shape trapezoid sampling into a FlatTraj (the batched twin of
    planner/frontend.py's host pipeline)."""
    dtype, dev = start_xy.dtype, start_xy.device
    B = start_xy.shape[0]
    n_pieces = cfg.n_pieces
    blocked = (esdf.dist < cfg.wf_safe_dis).expand(B, *esdf.shape).contiguous()
    H, W = esdf.shape
    hi = torch.tensor([H - 1, W - 1], device=dev)

    def cell_of(p):
        c = ((p - esdf.lower) / esdf.res).to(torch.int32)
        return torch.minimum(torch.clamp(c, min=0), hi).to(torch.int32)

    _, cells, valid = wavefront_path(blocked, cell_of(goal_xy),
                                     cell_of(start_xy), cfg.path_max_len)
    pts = esdf.lower + (cells.to(dtype) + 0.5) * esdf.res    # (B, L+1, 2)
    pts = torch.where(valid[..., None], pts, goal_xy[:, None, :])
    pts = torch.cat([start_xy[:, None, :], pts[:, 1:]], dim=1)

    d = pts[:, 1:] - pts[:, :-1]                              # (B, L, 2)
    ds = torch.sqrt(torch.sum(d * d, dim=-1))
    raw = torch.atan2(d[..., 1], d[..., 0])
    eps = 1e-9
    prev = start_yaw
    seg = []
    for i in range(d.shape[1]):
        # unwrap to the previous heading; keep heading on zero segments
        r = raw[:, i] + 2.0 * math.pi * torch.round((prev - raw[:, i])
                                                    / (2.0 * math.pi))
        prev = torch.where(ds[:, i] > eps, r, prev)
        seg.append(prev)
    seg_yaw = torch.stack(seg, dim=1)
    prev_yaw = torch.cat([start_yaw[:, None], seg_yaw[:, :-1]], dim=1)
    dyaw = seg_yaw - prev_yaw

    wstep = cfg.distance_weight * ds + cfg.yaw_weight * torch.abs(dyaw)
    wlen = torch.cumsum(wstep, dim=1)
    slen = torch.cumsum(ds, dim=1)
    W_tot = torch.clamp(wlen[:, -1], min=1e-3)
    S_tot = slen[:, -1]
    zero = torch.zeros_like(W_tot)
    bk = cfg.backend
    total_t = torch.clamp(
        _trapezoid_duration(W_tot, zero, bk.max_vel, bk.max_acc), min=1.0)
    st = total_t / n_pieces
    ks = torch.arange(1, n_pieces, dtype=dtype, device=dev)
    arcs = _trapezoid_length(ks * st[:, None], W_tot[:, None], zero[:, None],
                             bk.max_vel, bk.max_acc)           # (B, n-1)

    L = wlen.shape[1]
    idx = torch.clamp(torch.searchsorted(wlen.contiguous(), arcs.contiguous()),
                      0, L - 1)
    im1 = torch.clamp(idx - 1, min=0)

    def at(a, i):
        return torch.gather(a, 1, i)

    w_hi = at(wlen, idx)
    w_lo = torch.where(idx > 0, at(wlen, im1), torch.zeros_like(w_hi))
    frac = torch.where(w_hi > w_lo, (arcs - w_lo) / (w_hi - w_lo),
                       torch.ones_like(w_hi))
    s_lo = torch.where(idx > 0, at(slen, im1), torch.zeros_like(w_hi))
    s_k = s_lo + frac * at(ds, idx)
    yaw_k = at(prev_yaw, idx) + frac * at(dyaw, idx)
    gidx = idx[..., None].expand(B, idx.shape[1], 2)
    xy_k = torch.gather(pts, 1, gidx) + frac[..., None] * torch.gather(d, 1,
                                                                       gidx)

    final_yaw = seg_yaw[:, -1]
    inner = torch.stack([yaw_k, s_k], dim=1)
    positions = torch.cat(
        [torch.cat([xy_k, yaw_k[..., None]], -1),
         torch.cat([goal_xy, final_yaw[:, None]], -1)[:, None]], dim=1)
    z = torch.zeros_like(final_yaw)
    return FlatTraj(
        inner_yaw_s=inner,
        init_piece_time=st,
        inner_positions=positions,
        start_state=torch.stack([torch.stack([start_yaw, z, z], -1),
                                 torch.stack([z, z, z], -1)], 1),
        final_state=torch.stack([torch.stack([final_yaw, z, z], -1),
                                 torch.stack([S_tot, z, z], -1)], 1),
        start_xytheta=torch.cat([start_xy, start_yaw[:, None]], -1),
        final_xytheta=torch.cat([goal_xy, final_yaw[:, None]], -1),
        if_cut=torch.zeros(B, dtype=torch.bool, device=dev))


def _painted_esdf(esdf: ESDF, centers, half_extents) -> ESDF:
    """Rebuild the ESDF per lane with axis-aligned boxes painted at
    `centers` (B, M, 2) world XY; returns a (B, H, W) field."""
    H, W = esdf.shape
    dtype, dev = esdf.dist.dtype, esdf.dist.device
    base_occ = esdf.dist <= 0.5 * esdf.res
    cx = esdf.lower[0] + (torch.arange(H, dtype=dtype, device=dev) + 0.5) \
        * esdf.res
    cy = esdf.lower[1] + (torch.arange(W, dtype=dtype, device=dev) + 0.5) \
        * esdf.res
    hx = float(torch.tensor(half_extents[0], dtype=dtype))
    hy = float(torch.tensor(half_extents[1], dtype=dtype))
    inx = torch.abs(cx - centers[..., 0:1]) <= hx          # (B, M, H)
    iny = torch.abs(cy - centers[..., 1:2]) <= hy          # (B, M, W)
    painted = torch.any(inx[..., :, None] & iny[..., None, :], dim=1)
    return esdf_from_occupancy(base_occ | painted, esdf.lower, esdf.res)


def _push_leg(start_xy, start_yaw, target, esdf: ESDF, true_icr: ICRParams,
              cfg: MissionFleetConfig, n_ticks: int, seed):
    """One planned push leg for every lane: front end -> MINCO back end ->
    Polynome handoff -> NMPC + EKF closed-loop tracking.  Returns
    (obj_final (B, 3), track_err_max, plan_err, collision, traj)."""
    dtype = start_xy.dtype
    flat = _wavefront_flat(esdf, start_xy, start_yaw, target, cfg)
    res = plan_backend(flat, esdf, cfg.backend)
    B = start_xy.shape[0]
    icr_vec = torch.tensor([float(true_icr.yr), float(true_icr.yl),
                            float(true_icr.xv)], dtype=dtype,
                           device=start_xy.device).expand(B, 3)
    msg = Polynome(
        traj_start_time=torch.zeros_like(start_yaw),
        inner_points=res.inner, piece_times=res.times,
        init_state=flat.start_state, tail_state=res.tail_state,
        start_position=flat.start_xytheta, icr=icr_vec)
    tt = build_tracked_traj(msg, n_grid=256)
    tr = simulate_tracking(tt, true_icr, n_ticks, cfg.loop, seed=seed,
                           x0=tt.seq[:, 0])
    traj = tr.xytheta
    return (traj[:, -1], torch.amax(tr.pos_err, dim=1),
            torch.linalg.vector_norm(res.final_xy_err, dim=-1),
            res.collision, traj)


def _check_supported(cfg: MissionFleetConfig):
    if cfg.frontend_mode != "wavefront":
        raise NotImplementedError(
            f"frontend_mode={cfg.frontend_mode!r} is not ported yet")
    if cfg.plant != "kinematic":
        raise NotImplementedError(f"plant={cfg.plant!r} is not ported yet")
    if cfg.correction_ticks > 0:
        raise NotImplementedError("correction_ticks > 0 is not ported yet")


def run_mission(items, targets, robot_start, esdf: ESDF,
                true_icr: ICRParams,
                cfg: MissionFleetConfig = MissionFleetConfig(),
                seed=0, device=None) -> MissionFleetResult:
    """A fleet of K-object arrangement missions.

    items/targets (B, K, 2) world XY; robot_start (B, 3); the dtype of
    robot_start (a tensor, or a numpy array) sets the fleet's dtype.
    Runs on the card unless `device` says otherwise (device=None means
    CUDA and raises when it is missing).
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    set_precision_policy()
    dtype = torch.as_tensor(robot_start).dtype
    items = torch.as_tensor(items).to(device=dev, dtype=dtype)
    targets = torch.as_tensor(targets).to(device=dev, dtype=dtype)
    robot = torch.as_tensor(robot_start).to(device=dev, dtype=dtype)
    esdf = ESDF(dist=esdf.dist.to(dev), lower=esdf.lower.to(dev),
                res=esdf.res.to(dev))
    K = items.shape[1]
    errs, dels, perrs, colls, tmaxs, trajs = [], [], [], [], [], []
    obj_pos = [items[:, j] for j in range(K)]

    with torch.no_grad():
        for k in range(K):
            item = obj_pos[k]
            target = targets[:, k]
            if cfg.paint_objects and K > 1:
                others = torch.stack([obj_pos[j] for j in range(K) if j != k],
                                     dim=1)
                leg_esdf = _painted_esdf(esdf, others, cfg.paint_half_extents)
            else:
                leg_esdf = esdf
            robot = _approach(robot, item, cfg.fsm, cfg.approach_ticks)
            obj_final, tmax, perr, coll, traj = _push_leg(
                item, robot[:, 2], target, leg_esdf, true_icr, cfg,
                cfg.push_ticks, seed + k)
            err = torch.linalg.vector_norm(obj_final[:, :2] - target, dim=-1)
            errs.append(err)
            dels.append(err < cfg.deliver_tol)
            perrs.append(perr)
            colls.append(coll)
            tmaxs.append(tmax)
            trajs.append(traj)
            obj_pos[k] = obj_final[:, :2]
            robot = obj_final

    return MissionFleetResult(
        object_err=torch.stack(errs, 1), delivered=torch.stack(dels, 1),
        plan_err=torch.stack(perrs, 1), collision=torch.stack(colls, 1),
        track_err_max=torch.stack(tmaxs, 1), robot_final=robot,
        push_traj=torch.stack(trajs, 1))


def spaced_scenarios(B, K, rng, item_x=(1.0, 2.5), target_x=(5.5, 7.0),
                     y_range=(1.2, 6.8), min_sep=1.6):
    """Random mission scenarios with same-side spacing >= min_sep
    (rejection-sampled).  Returns (items (B, K, 2), targets (B, K, 2))
    numpy arrays."""

    def sample_side(x_lo, x_hi):
        out = np.zeros((B, K, 2))
        for b in range(B):
            while True:
                pts = np.stack([rng.uniform(x_lo, x_hi, K),
                                rng.uniform(*y_range, K)], -1)
                d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
                if (d + np.eye(K) * 1e9).min() >= min_sep:
                    out[b] = pts
                    break
        return out

    return sample_side(*item_x), sample_side(*target_x)


def correct_missed_legs(*args, **kwargs):
    """Host re-dispatch of correction legs: not ported yet."""
    raise NotImplementedError("correct_missed_legs is not ported yet")


def correct_until_delivered(*args, **kwargs):
    """Iterated correction rounds: not ported yet."""
    raise NotImplementedError("correct_until_delivered is not ported yet")
