"""Replanning orchestrator (port of mission/plan_manager.py).

Host-level mission layer driving the planners, mirroring
plan_manager/include/plan_manager/plan_manager.hpp:

  * FSM {IDLE, PLANNING, REPLAN, GOINGTOGOAL, EMERGENCY_STOP}
    (MainThread :556-712)
  * replanning from the *predicted* state at t + max_replan_time, computed
    by integrating the current trajectory's ICR flow
    (get_the_predicted_state, optimizer.cpp:1108-1189)
  * front-end search + back-end optimize + Polynome handoff
    (findJPSRoad :714-782, MPCPathPub :784-831)
  * object painting into the map with ESDF refresh (paintSquare :470-496)

The manager sequences the native JPS front end on the host and the back
end, tracked trajectory and ESDF on its device (`device=None` means the
card).  The occupancy grid stays a host numpy array; the ESDF, the
Polynome and the tracked trajectory carry a lane axis of 1.  The host
reads (the ESDF for the front end, the back end's collision flag, the
predicted state) are explicit copies.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..control.tracked_traj import build_tracked_traj, pstate
from ..core import poly
from ..ops.esdf import ESDF, dist_at_cell, esdf_from_occupancy
from ..planner.backend import BackendConfig, BackendResult, plan_backend
from ..planner.flat_traj import Polynome
from ..planner.frontend import FrontendConfig, plan_frontend
from ..utils.precision import resolve_device, set_precision_policy
from ..world.grid_map import paint_rect
from ..world.lidar import (LidarConfig, OccupancyConfig, lidar_scan,
                           occupancy_classes, occupancy_init,
                           occupancy_update, occupancy_update_perspective,
                           perspective_points)


class PlanState(enum.Enum):
    IDLE = 0
    PLANNING = 1
    REPLAN = 2
    GOING_TO_GOAL = 3
    EMERGENCY_STOP = 4


@dataclass
class PlanManagerConfig:
    replan_period: float = 1.0       # launch `replan_time` (5000 = one-shot)
    max_replan_time: float = 0.05    # expected plan compute budget
    goal_reach_dist_sq: float = 1.0  # MainThread :579 distance gate
    backend: BackendConfig = field(default_factory=BackendConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    icr: tuple = (-0.3, 0.3, 0.2)    # (yr, yl, xv) published in Polynome
    dtype: object = torch.float32


def predict(tt, t_rel: float, horizon: float):
    """Predicted pose/derivatives at trajectory time t_rel (clamped to the
    trajectory) plus the pose `horizon` further along (the replan
    search-start, findJPSRoad), for a lane axis of 1.  Returns host
    numpy (pose (3,), v (2,), a (2,), j (2,), pose_end (3,))."""
    dur = tt.duration[:, None]
    t_rel = torch.full_like(dur, t_rel)
    t = torch.minimum(torch.clamp(t_rel, min=0.0), dur)
    pose = pstate(tt, t)[0, 0]
    v, a, j = (poly.eval_traj(tt.traj, t, k)[0, 0] for k in (1, 2, 3))
    t_end = torch.minimum(t_rel + horizon, dur)
    pose_end = pstate(tt, t_end)[0, 0]
    return tuple(x.cpu().numpy().astype(float)
                 for x in (pose, v, a, j, pose_end))


@dataclass
class PlanManager:
    occ: np.ndarray                  # (H, W) bool occupancy (mutable)
    lower: tuple
    res: float
    cfg: PlanManagerConfig = field(default_factory=PlanManagerConfig)
    device: object = None            # planning device; None = the card

    state: PlanState = PlanState.IDLE
    goal: Optional[np.ndarray] = None
    start_state: Optional[np.ndarray] = None   # /planner_start_pose
    esdf: Optional[ESDF] = None
    polynome: Optional[Polynome] = None
    tracked = None
    plan_start_time: float = -1.0
    traj_total_time: float = 0.0
    last_loop_time: float = -1e30
    # plan_start_state_XYTheta of the last attempted plan -- the goal
    # gate's yaw term uses THIS pose's yaw, not the robot's
    # (MainThread :578: fmod(fabs((plan_start_state_XYTheta - goal)[2])))
    plan_start_xyt: Optional[np.ndarray] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        set_precision_policy()
        self.update_esdf()

    # ---- map maintenance -------------------------------------------------
    def update_esdf(self):
        self.esdf = esdf_from_occupancy(
            torch.as_tensor(np.asarray(self.occ, bool), device=self.device),
            torch.tensor(self.lower, dtype=self.cfg.dtype), self.res)

    def paint_square(self, center, half_size=0.4, make_obs=True):
        """Paint on the host grid: the lower corner rounded to float32,
        the center in float64, as the JAX package paints."""
        self.occ = paint_rect(
            torch.as_tensor(np.asarray(self.occ, bool)),
            torch.tensor(self.lower, dtype=torch.float32), self.res,
            torch.as_tensor(np.asarray(center, float)),
            (2 * half_size, 2 * half_size), 0.0, make_obs).numpy()
        self.update_esdf()

    # ---- mission ---------------------------------------------------------
    def set_goal(self, goal_xyt, start_xyt=None):
        """New mission: goal pose (+ optional explicit start pose, the
        /planner_start_pose topic -- the reference's first plan starts
        from the *subscribed* start, not the odom pose)."""
        self.goal = np.asarray(goal_xyt, float)
        self.start_state = None if start_xyt is None \
            else np.asarray(start_xyt, float)
        # a new mission has no trajectory yet: a failed initial plan
        # aborts instead of replanning off a stale trajectory
        self.tracked = None
        self.polynome = None
        self.plan_start_time = -1.0
        self.traj_total_time = 0.0
        self.state = PlanState.IDLE if self.state != PlanState.EMERGENCY_STOP \
            else self.state

    def _predict(self, t_rel, horizon):
        return predict(self.tracked, float(torch.tensor(t_rel,
                                                        dtype=self.cfg.dtype)),
                       float(torch.tensor(horizon, dtype=self.cfg.dtype)))

    def predicted_state(self, t_rel):
        """Pose + flat (V, A, J) / (O, A, J) on the current trajectory at
        trajectory-relative time t_rel (get_the_predicted_state)."""
        pose, v, a, j, _ = self._predict(t_rel, 0.0)
        return (pose, np.array([v[1], a[1], j[1]]),
                np.array([v[0], a[0], j[0]]))

    def _predicted_start_path(self, pose_tpred, pose_end):
        """Replan search-start offset (findJPSRoad :714-744): if the
        predicted state at t_rel is collision-free, the JPS search starts
        from the state `jps_truncation_time` further along the trajectory
        (the END state is not collision-checked, as in the reference);
        otherwise from the t_rel state itself.  Returns the start_path for
        plan_frontend or None."""
        pos = torch.tensor(pose_tpred[:2], dtype=self.cfg.dtype,
                           device=self.device)[None]
        d = float(dist_at_cell(self.esdf, pos)[0])
        if d <= self.cfg.frontend.safe_dis:
            return None
        return [np.asarray(pose_tpred[:2], float),
                np.asarray(pose_end[:2], float)]

    def _plan(self, start_xyt, start_vaj, start_oaj, t_now,
              start_path=None):
        self.plan_start_xyt = np.asarray(start_xyt, float)
        flat = plan_frontend(self.esdf.dist.cpu().numpy(),
                             self.lower, self.res, start_xyt, self.goal,
                             self.cfg.frontend, start_vaj, start_oaj,
                             self.cfg.dtype, start_path=start_path,
                             device=self.device)
        if flat is None:
            # front end failed: EMERGENCY_STOP (MainThread :662-666)
            self.state = PlanState.EMERGENCY_STOP
            return None

        with torch.no_grad():
            res: BackendResult = plan_backend(flat, self.esdf,
                                              self.cfg.backend)
        if bool(res.collision[0].cpu()):
            # back end failed (minco_plan false): the old trajectory keeps
            # tracking and the next due gate retries (MainThread :676-679)
            return None

        if self.plan_start_time < 0:
            traj_start = t_now
        else:
            traj_start = t_now + self.cfg.max_replan_time
        self.plan_start_time = traj_start

        dt = dict(dtype=self.cfg.dtype, device=self.device)
        msg = Polynome(
            traj_start_time=torch.tensor([traj_start], **dt),
            inner_points=res.inner, piece_times=res.times,
            init_state=flat.start_state, tail_state=res.tail_state,
            start_position=flat.start_xytheta,
            icr=torch.tensor([self.cfg.icr], **dt))
        self.polynome = msg
        # the manager's own flow integration (predicted-state replans)
        # follows if_standard_diff: the xv lateral term is dropped
        # (get_the_predicted_state, optimizer.cpp:1214-1218)
        flow_msg = msg
        if self.cfg.backend.standard_diff:
            icr = msg.icr.clone()
            icr[:, 2] = 0.0
            flow_msg = msg._replace(icr=icr)
        self.tracked = build_tracked_traj(flow_msg, n_grid=1024)
        self.traj_total_time = float(self.tracked.duration[0])
        return msg

    def tick(self, t_now: float, robot_pose) -> Optional[Polynome]:
        """Advance the FSM; returns a new Polynome when a plan was made."""
        if self.goal is None or self.state == PlanState.EMERGENCY_STOP:
            return None

        robot_pose = np.asarray(robot_pose, float)
        new_msg = None

        due = (t_now - self.last_loop_time) > self.cfg.replan_period
        if self.state == PlanState.IDLE or \
                (self.state in (PlanState.PLANNING, PlanState.REPLAN) and due):
            self.last_loop_time = t_now
            if self.state == PlanState.IDLE:
                self.state = PlanState.PLANNING
                self.plan_start_time = -1.0
                start = robot_pose if self.start_state is None \
                    else self.start_state
                new_msg = self._plan(start, np.zeros(3), np.zeros(3),
                                     t_now)
            else:
                # goal gate (MainThread :578-582): xy from the odom pose,
                # yaw term from the LAST PLAN's start pose
                yaw_src = robot_pose if self.plan_start_xyt is None \
                    else self.plan_start_xyt
                near_goal = (np.sum((robot_pose[:2] - self.goal[:2]) ** 2)
                             + np.fmod(abs(yaw_src[2] - self.goal[2]),
                                       2 * np.pi) * 0.02
                             < self.cfg.goal_reach_dist_sq)
                short_left = self.traj_total_time < self.cfg.max_replan_time
                if near_goal or short_left:
                    self.state = PlanState.GOING_TO_GOAL
                    return None
                self.state = PlanState.REPLAN
                t_pred = (t_now + self.cfg.max_replan_time
                          - self.plan_start_time)
                # horizon = jps_truncation_time (jps3ms.yaml: 0.5)
                pose, v, a, j, pose_end = self._predict(t_pred, 0.5)
                vaj = np.array([v[1], a[1], j[1]])
                oaj = np.array([v[0], a[0], j[0]])
                sp = self._predicted_start_path(pose, pose_end)
                new_msg = self._plan(pose, vaj, oaj, t_now, start_path=sp)

        # back-end failure on the INITIAL plan: no trajectory to keep
        # tracking; the reference aborts on its next tick (MainThread
        # :707-711 with the constructor defaults)
        if self.state == PlanState.PLANNING and self.tracked is None:
            self.state = PlanState.IDLE
            self.goal = None
            return None

        # trajectory finished?
        if (self.plan_start_time >= 0
                and t_now - self.plan_start_time >= self.traj_total_time
                and self.state != PlanState.EMERGENCY_STOP):
            self.state = PlanState.IDLE
            self.goal = None

        return new_msg


@dataclass
class MappedPlanManager(PlanManager):
    """Unknown-environment variant: the planning ESDF comes from online
    lidar mapping instead of ground truth (the reference's *_unknown
    profile: planner_sim.launch wires laser_sim -> SDFmap raycast ->
    updateESDF2d inside the detection range).

    `occ` is reinterpreted as the GROUND-TRUTH world used only to render
    scans; planning sees the fused occupancy (unknown treated as free,
    matching the known-map "3ms" planner behaviour outside sensor range).
    The truth grid and the map state live on the manager's device; the
    fused occupancy comes back to the host as the planning `occ`.

    map_mode selects the reference's two mapping pipelines
    (planner_sim.launch:22 defaults to if_perspective=true):
      * "raycast": occlusion-aware scan -> Bresenham log-odds fusion
        (+ optional circular-support carve, cir_sup=True firing on
        every SECOND scan exactly like the reference's static counter);
      * "perspective": perspectivePoints cloud -> window-fill +
        endpoint-stamp branch (no log odds).
    """

    lidar_cfg: object = None
    occupancy_cfg: object = None
    map_mode: str = "raycast"
    cir_sup: bool = False            # if_cirSupRaycast (launch:76)
    _scan_count: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        set_precision_policy()
        self.lidar_cfg = self.lidar_cfg or LidarConfig()
        self.occupancy_cfg = self.occupancy_cfg or OccupancyConfig()
        self._true_occ = torch.as_tensor(np.asarray(self.occ, bool),
                                         device=self.device)
        self._map_state = occupancy_init(self.occ.shape, self.occupancy_cfg,
                                         device=self.device)
        # start with an empty (all-unknown -> free) planning map
        self.occ = np.zeros_like(self.occ)
        self.update_esdf()

    def sense(self, pose, n_scans: int = 1):
        """Render scan(s) of the true world from `pose` and fuse them."""
        p = torch.tensor(np.asarray(pose, float), dtype=self.cfg.dtype,
                         device=self.device)
        for _ in range(n_scans):
            self._scan_count += 1
            if self.map_mode == "perspective":
                pts_s, mask = perspective_points(
                    self._true_occ, self.lower, self.res, p, self.lidar_cfg)
                # sensor frame -> world (the bridge republishes world
                # clouds to the SDFmap node)
                c, s = torch.cos(p[2]), torch.sin(p[2])
                px = p[0] + c * pts_s[..., 0] - s * pts_s[..., 1]
                py = p[1] + s * pts_s[..., 0] + c * pts_s[..., 1]
                pts_w = torch.stack([px.reshape(-1), py.reshape(-1)], -1)
                self._map_state = occupancy_update_perspective(
                    self._map_state, self.lower, self.res, p, pts_w,
                    mask.reshape(-1), self.lidar_cfg.max_range,
                    self.occupancy_cfg)
            else:
                ranges, hits = lidar_scan(self._true_occ, self.lower,
                                          self.res, p, self.lidar_cfg)
                fire = self.cir_sup and (self._scan_count % 2 == 0)
                self._map_state = occupancy_update(
                    self._map_state, self.lower, self.res, p, ranges,
                    hits, self.lidar_cfg, self.occupancy_cfg,
                    cir_sup=fire)
        occ_est, _, _ = occupancy_classes(self._map_state,
                                          self.occupancy_cfg)
        self.occ = occ_est.cpu().numpy()
        self.update_esdf()
