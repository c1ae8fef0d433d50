"""Batched full-mission runtime (port of runtime/mission_fleet.py).

Every phase of a K-object arrangement mission for a fleet of B missions
at once: kinematic approach under the task FSM's control laws
(b2z1_object_fsm.py:575-642), painting of the other objects into the map
(plan_manager.hpp:470-496), the on-device octile wavefront front end,
MINCO back-end push planning (optimizer.cpp:169-472) and the NMPC +
ICR-EKF closed-loop push.  The JAX program vmaps one mission; here every
tensor carries the leading fleet axis.

The push runs on the kinematic ICR plant (`plant="kinematic"`) or on
the rigid-body contact plant with the ICR identified online
(`plant="physics"`, runtime/closed_loop_physics.py).  Missed legs are
recovered by correction legs, either inside the fleet program for every
lane (`correction_ticks > 0`) or afterwards for the missed lanes only
(`correct_missed_legs`, `correct_until_delivered`), and
`mission_seconds_exact` bills the simulated time of what really ran.
Eager PyTorch compiles nothing, so a correction round gathers exactly
the missed lanes, with no padding and no program cache.
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
from .closed_loop_physics import PhysicsLoopConfig, simulate_tracking_physics


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


def _straight_flat(start_xy, start_yaw, goal_xy, n_pieces: int,
                   max_vel: float) -> FlatTraj:
    """Straight-line FlatTraj initialization (the front-end sampling
    stand-in; jps_planner.cpp:217-257 provides this in the host
    pipeline).  start_xy, goal_xy (B, 2); start_yaw is unused, the lane
    starts along the line."""
    dtype, dev = start_xy.dtype, start_xy.device
    B = start_xy.shape[0]
    d = goal_xy - start_xy
    L = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-3)
    yaw = torch.atan2(d[:, 1], d[:, 0])
    fr = torch.arange(1, n_pieces, dtype=dtype, device=dev) / n_pieces
    inner = torch.stack([yaw[:, None].expand(B, n_pieces - 1),
                         L[:, None] * fr], dim=1)
    pos = torch.cat([start_xy[:, None] + fr[None, :, None] * d[:, None],
                     goal_xy[:, None]], dim=1)
    pos = torch.cat([pos, yaw[:, None, None].expand(B, n_pieces, 1)], dim=2)
    total_t = torch.clamp(L / max_vel * 2.0, min=1.0)
    z = torch.zeros_like(yaw)
    return FlatTraj(
        inner_yaw_s=inner,
        init_piece_time=total_t / n_pieces,
        inner_positions=pos,
        start_state=torch.stack([torch.stack([yaw, z, z], -1),
                                 torch.stack([z, z, z], -1)], 1),
        final_state=torch.stack([torch.stack([yaw, z, z], -1),
                                 torch.stack([L, z, z], -1)], 1),
        start_xytheta=torch.cat([start_xy, yaw[:, None]], -1),
        final_xytheta=torch.cat([goal_xy, yaw[:, None]], -1),
        if_cut=torch.zeros(B, dtype=torch.bool, device=dev))


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
    Polynome handoff -> NMPC + EKF closed-loop tracking on the configured
    plant (the contact plant identifies its ICR online and ignores
    `true_icr` and `cfg.loop`, as in the JAX package).  Returns
    (obj_final (B, 3), track_err_max, plan_err, collision, traj)."""
    dtype = start_xy.dtype
    if cfg.frontend_mode == "wavefront":
        flat = _wavefront_flat(esdf, start_xy, start_yaw, target, cfg)
    else:
        flat = _straight_flat(start_xy, start_yaw, target, cfg.n_pieces,
                              cfg.backend.max_vel)
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
    if cfg.plant == "physics":
        tr = simulate_tracking_physics(
            tt, n_ticks, cfg.phys_loop or PhysicsLoopConfig(), seed=seed)
        traj = tr.obj_xytheta
    else:
        tr = simulate_tracking(tt, true_icr, n_ticks, cfg.loop, seed=seed,
                               x0=tt.seq[:, 0])
        traj = tr.xytheta
    return (traj[:, -1], torch.amax(tr.pos_err, dim=1),
            torch.linalg.vector_norm(res.final_xy_err, dim=-1),
            res.collision, traj)


def _esdf_on(esdf: ESDF, dev) -> ESDF:
    return ESDF(dist=esdf.dist.to(dev), lower=esdf.lower.to(dev),
                res=esdf.res.to(dev))


def run_mission(items, targets, robot_start, esdf: ESDF,
                true_icr: ICRParams,
                cfg: MissionFleetConfig = MissionFleetConfig(),
                seed=0, device=None) -> MissionFleetResult:
    """A fleet of K-object arrangement missions.

    items/targets (B, K, 2) world XY; robot_start (B, 3); the dtype of
    robot_start (a tensor, or a numpy array) sets the fleet's dtype.
    Runs on the card unless `device` says otherwise (device=None means
    CUDA and raises when it is missing).

    With cfg.correction_ticks > 0 every lane replans from its realized
    object pose and tracks a second, short leg (the fleet-program twin
    of the reference FSM's replan-until-within-tolerance); its outcome
    applies only to the lanes whose main leg missed deliver_tol.
    """
    dev = resolve_device(device)
    set_precision_policy()
    dtype = torch.as_tensor(robot_start).dtype
    items = torch.as_tensor(items).to(device=dev, dtype=dtype)
    targets = torch.as_tensor(targets).to(device=dev, dtype=dtype)
    robot = torch.as_tensor(robot_start).to(device=dev, dtype=dtype)
    esdf = _esdf_on(esdf, dev)
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
            if cfg.correction_ticks > 0:
                # a delivered object is RELEASED (the FSM never replans
                # it): the correction result applies to missed lanes only
                ok1 = torch.linalg.vector_norm(
                    obj_final[:, :2] - target, dim=-1) < cfg.deliver_tol
                obj2, tmax2, perr2, coll2, _ = _push_leg(
                    obj_final[:, :2], obj_final[:, 2], target, leg_esdf,
                    true_icr, cfg, cfg.correction_ticks, seed + K + k)
                obj_final = torch.where(ok1[:, None], obj_final, obj2)
                tmax = torch.where(ok1, tmax, torch.maximum(tmax, tmax2))
                perr = torch.where(ok1, perr, torch.maximum(perr, perr2))
                coll = torch.where(ok1, coll, coll | coll2)
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


def _other_finals(finals, b_idx, k_idx):
    """XY of the K-1 other objects of each gathered lane, in object
    order with object k_idx[m] left out: finals (B, K, 3), b_idx / k_idx
    (M,) -> (M, K-1, 2)."""
    K = finals.shape[1]
    j = torch.arange(K - 1, device=finals.device)[None, :]
    oth_idx = j + (j >= k_idx[:, None]).to(j.dtype)              # (M, K-1)
    return finals[b_idx[:, None], oth_idx, :2]


def correct_missed_legs(result: MissionFleetResult, targets, esdf: ESDF,
                        true_icr: ICRParams, cfg: MissionFleetConfig,
                        correction_ticks: int, seed: int = 0):
    """Re-dispatch correction legs for ONLY the missed lanes (the cheap
    alternative to `correction_ticks > 0`, which plans and tracks the
    second leg for every lane).

    After the fleet program returns, the legs whose objects missed
    `deliver_tol` are gathered into one batch of exactly M lanes, one
    plan + track correction runs on those, and the outcomes scatter
    back: the cost follows the miss rate.  Gather and scatter stay on
    the device of `result`; the one host read is the list of missed
    lanes.

    The correction runs post-mission, so every other object paints at
    its FINAL realized pose, the corrected one excluded.  A delivered
    lane keeps every field bit for bit.  A corrected lane reports the
    corrected error, the larger tracking error, the OR of the collision
    flags, and the last sample of its `push_traj` moves to the corrected
    pose, which is where an iterated round starts from; `plan_err`,
    `robot_final` and the rest of `push_traj` stay as the fleet program
    reported them.

    All corrected lanes share one noise generator seeded with
    `seed + 10_000` (the JAX package seeds lane i with
    `seed + 10_000 + i`; its `jax.random` streams are not reproduced
    here in any case, and parity runs switch the plant noise off).

    result / targets may carry a leading fleet axis or be one mission.
    Returns (new_result, n_corrected).
    """
    set_precision_policy()
    batched = result.object_err.dim() == 2
    r = result if batched else MissionFleetResult(*(a[None] for a in result))
    dev, dtype = r.object_err.device, r.object_err.dtype
    targets_b = torch.as_tensor(targets).to(device=dev, dtype=dtype)
    if not batched:
        targets_b = targets_b[None]
    K = r.object_err.shape[1]

    lanes = torch.nonzero(~r.delivered)                 # (M, 2), host read
    M = lanes.shape[0]
    if M == 0:
        return result, 0
    b_idx, k_idx = lanes[:, 0], lanes[:, 1]
    finals = r.push_traj[:, :, -1, :]                   # (B, K, 3)
    starts = finals[b_idx, k_idx]                       # (M, 3)
    tgts = targets_b[b_idx, k_idx]                      # (M, 2)
    esdf = _esdf_on(esdf, dev)
    if K > 1:
        # other objects at their FINAL poses, the corrected one excluded
        # (painted whatever cfg.paint_objects says, as the JAX package)
        others = _other_finals(finals, b_idx, k_idx)
        leg_esdf = _painted_esdf(esdf, others, cfg.paint_half_extents)
    else:
        leg_esdf = esdf

    with torch.no_grad():
        obj2, tmax2, _, coll2, _ = _push_leg(
            starts[:, :2], starts[:, 2], tgts, leg_esdf, true_icr, cfg,
            correction_ticks, seed + 10_000)
    err2 = torch.linalg.vector_norm(obj2[:, :2] - tgts, dim=-1)

    oe, de = r.object_err.clone(), r.delivered.clone()
    te, co = r.track_err_max.clone(), r.collision.clone()
    pt = r.push_traj.clone()
    oe[b_idx, k_idx] = err2
    de[b_idx, k_idx] = err2 < cfg.deliver_tol
    te[b_idx, k_idx] = torch.maximum(te[b_idx, k_idx], tmax2)
    co[b_idx, k_idx] = co[b_idx, k_idx] | coll2
    pt[b_idx, k_idx, -1, :] = obj2
    out = r._replace(object_err=oe, delivered=de, track_err_max=te,
                     collision=co, push_traj=pt)
    if not batched:
        out = MissionFleetResult(*(a[0] for a in out))
    return out, M


def correct_until_delivered(result: MissionFleetResult, targets, esdf: ESDF,
                            true_icr: ICRParams, cfg: MissionFleetConfig,
                            correction_ticks: int, max_rounds: int = 3,
                            seed: int = 0):
    """Iterate correction rounds until every leg delivers or `max_rounds`
    is exhausted: the reference FSM's replan-until-within-tolerance loop
    (b2z1_object_fsm.py:752-822 OBJECT_TRACKING re-entry;
    plan_manager.hpp:556-712 REPLAN).

    Each round gathers ONLY the still-missed lanes, replans from the
    object's CURRENT pose (the previous round's corrected final) and
    uses a fresh tracking seed, `seed + 50_000 * (round + 1)`, so a
    marginal failure is not replayed verbatim.  Returns (result,
    miss_counts): miss_counts[i] is the number of legs that ran a
    correction in round i; feed it to mission_seconds_exact.
    """
    miss_counts = []
    for rnd in range(max_rounds):
        result, m = correct_missed_legs(
            result, targets, esdf, true_icr, cfg, correction_ticks,
            seed=seed + 50_000 * (rnd + 1))
        if m == 0:
            break
        miss_counts.append(m)
    return result, miss_counts


def mission_seconds_exact(result: MissionFleetResult,
                          cfg: MissionFleetConfig, correction_ticks: int,
                          miss_counts=None) -> float:
    """Simulated seconds for a fleet that used correct_missed_legs: base
    phases for every leg + correction ticks only where a leg actually
    ran a correction.

    miss_counts: per-round correction counts from
    correct_until_delivered (each round bills its own misses).  When
    None, `result` must be the PRE-correction fleet result and one round
    is billed per pre-correction miss."""
    de = result.delivered
    n_legs = int(de.numel())
    if miss_counts is None:
        n_corrections = int((~de).sum())
    else:
        n_corrections = int(sum(miss_counts))
    base = ((cfg.approach_ticks + cfg.grasp_ticks + cfg.release_ticks)
            * cfg.fsm.fsm_dt + cfg.push_ticks * cfg.loop.nmpc.dt)
    return (base * n_legs
            + correction_ticks * cfg.loop.nmpc.dt * n_corrections)


def mission_seconds(cfg: MissionFleetConfig, n_objects: int) -> float:
    """Simulated real-time seconds one mission models (executive phases
    at fsm_dt, push tracking at the NMPC dt).  An UPPER BOUND when
    correction_ticks > 0: the correction leg is counted for every
    object, though only missed lanes spend that time."""
    per = ((cfg.approach_ticks + cfg.grasp_ticks + cfg.release_ticks)
           * cfg.fsm.fsm_dt
           + (cfg.push_ticks + cfg.correction_ticks) * cfg.loop.nmpc.dt)
    return per * n_objects
