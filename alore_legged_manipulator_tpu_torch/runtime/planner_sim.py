"""The composed planner_sim closed loop (port of runtime/planner_sim.py):
the reference's full multi-node integration graph, stepped at 1 kHz.

It matches, event for event, the composition planner_sim.launch runs
(and that the composed golden oracle tests/golden/e2e_oracle/harness.cpp
compiles from the reference sources):

  * diff-drive plant at 500 Hz under the LTV-MPC's (v, omega) CarState
    command path -- instant adoption at 100 Hz command receipt, decay
    toward zero between receipts (simulator.h:203-270)
  * ICR-EKF: predict per 100 Hz wheel-feedback message (ControlPub,
    simulator.h:345-346), update per 10 Hz odometry, publish at 100 Hz
    (icrekf.cpp:5-97, 225-332) -- including the reference's cold-start
    quirks (x starts at the origin until the first odometry; the first
    stored wheel command predicts over the full gap once odometry
    arrives)
  * LTV-MPC at 100 Hz: trajectory swap once t passes traj_start_time,
    reference sampling clamped at the trajectory end, smooth_yaw,
    max_iter SQP passes, delay_num command offset
    (mpc_controller/src/mpc.cpp:131-216, 634-691); or the real robot's
    ACADO-RTI NMPC over the CarControl wheel path
  * plan_manager MainThread at 1 kHz: replan gate every replan_time,
    predicted-state replans with trajectory swap at t + max_replan_time
    (plan_manager.hpp:556-712) -- mission/plan_manager.PlanManager
  * online mapping: 10 Hz perspective cloud (every occupied true-map
    cell within detection_range) or occlusion-aware beam scan -> 20 Hz
    occupancy fusion (sdf_map.cpp:96-129, 239+) -> 100 Hz ESDF refresh
    (updateESDFCallback, re-enabled at its commented 100 Hz period)

Event order inside one 1 ms step mirrors the launch file's node
construction order (the oracle's deterministic timer order):
occupancy fusion -> MainThread -> plant propagation -> wheel feedback
(EKF predict) -> odometry (EKF update) -> MPC tick (command applied) ->
EKF publish -> ESDF refresh.

The plant, the clocks, the raycast scan and the perspective cloud stay
on the host in float64, as in the JAX package; the planner, the EKF
(a lane axis of 1), the tracker and the fusion state (float32, as the
JAX package fuses) live on `device` (None means the card).  Inside the
1 ms step the host reads back the tracker's command once per MPC tick,
the EKF estimate once per publish and the fused occupancy once per
fusion, as the JAX package does.  The JAX package pads the perspective
cloud to powers of two so that its fusion compiles once; padded points
are masked off and change nothing, so the port fuses the cloud as it
is.  Trajectories keep their padding to 32 pieces, which decides how the
end of a trajectory is sampled.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..control.ltv_mpc import LtvMpcConfig, ltv_mpc_init, ltv_mpc_tick
from ..control.nmpc import (NmpcConfig, nmpc_cold_start_step,
                            nmpc_rti_step)
from ..control.tracked_traj import (build_tracked_traj, ltv_ref_points,
                                    pad_tracked_traj, ref_points)
from ..core.dynamics import ICRParams
from ..estimator.icr_ekf import EkfConfig, ekf_init, ekf_predict, ekf_update
from ..mission.plan_manager import PlanManager, PlanManagerConfig
from ..utils.angles import normalize_angle
from ..utils.precision import resolve_device
from ..world.lidar import (LidarConfig, OccupancyConfig, occupancy_classes,
                           occupancy_init, occupancy_update,
                           occupancy_update_perspective)

# launch-wired EKF noise/init (planner_sim.launch:185-206; the node
# squares the Q/R parameters, icrekf.h:142-157)
E2E_EKF_CONFIG = EkfConfig(
    q_diag=(0.5 ** 2, 0.5 ** 2, 1.14 ** 2, 0.1 ** 2, 0.1 ** 2, 0.1 ** 2),
    r_diag=(0.1 ** 2, 0.1 ** 2, 0.1 ** 2),
    p0_diag=(0.0, 0.0, 0.0, 0.0, 0.0, 0.0))
E2E_EKF_ICR_INIT = (-0.25, 0.25, 0.1)
E2E_TRUE_ICR = (-0.3, 0.3, 0.2)


@dataclasses.dataclass
class E2EScenario:
    """Geometry + timing of one composed run (tests/golden/e2e_oracle/
    scenario.py emits the identical description to the C++ oracle)."""
    grid: np.ndarray              # (nx, ny) bool truth occupancy
    lower: tuple                  # (x_lower, y_lower)
    res: float
    start: tuple                  # (x, y, yaw)
    goal: tuple
    sim_T: float
    detection_range: float = 5.0
    laser_period_ms: int = 100    # 10 Hz
    replan_time: float = 0.08
    max_replan_time: float = 0.05
    obs_t: float = -1.0           # popup obstacle time (< 0: none)
    obs_cells: tuple = (0, 0, 0, 0)
    laser_mode: str = "perspective"   # or "raycast" (occlusion-aware
                                      # beam scan -> Bresenham log-odds
                                      # fusion, if_perspective=false)
    n_beams: int = 360

    @classmethod
    def from_golden(cls, scn: dict) -> "E2EScenario":
        grid = np.array([[c == "1" for c in row]
                         for row in scn["grid_rows"]], dtype=bool)
        return cls(grid=grid, lower=(scn["x_lower"], scn["y_lower"]),
                   res=scn["res"], start=tuple(scn["start"]),
                   goal=tuple(scn["goal"]), sim_T=scn["sim_T"],
                   detection_range=scn["detection_range"],
                   laser_period_ms=int(round(1000.0 / scn["laser_rate"])),
                   replan_time=scn["replan_time"],
                   max_replan_time=scn["max_replan_time"],
                   obs_t=scn["obs_t"], obs_cells=tuple(scn["obs_cells"]),
                   laser_mode=scn.get("laser_mode", "perspective"),
                   n_beams=scn.get("n_beams", 360))


@dataclasses.dataclass
class E2ETrace:
    poses: np.ndarray    # (K, 6) t, x, y, theta, v, omega  (100 Hz truth)
    cmds: np.ndarray     # (M, 3) t, v, omega (LTV) or t, v_r, v_l (NMPC)
    ekf: np.ndarray      # (M, 7) t, x, y, psi, yr, yl, xv (100 Hz publish)
    plans: list          # dicts: t, traj_start, n_pieces, duration, ...
    states: list         # (t, PlanState) FSM edges
    # every 1 kHz gate firing that ATTEMPTED a plan (successful or not):
    # the gate compares accumulated f64 clocks, so attempt times pin the
    # MainThread cadence bit for bit even when a back-end solve fails
    # (the reference keeps the old trajectory and retries at the next
    # due tick, MainThread :676-679)
    attempts: list = dataclasses.field(default_factory=list)


class _TrackerNode:
    """What both tracker twins share: the trajectory inbox, the swap
    once t passes its start time, and the goal flag."""

    PIECE_CAPACITY = 32

    def __init__(self, cfg, dtype, device):
        self.cfg = cfg
        self.dtype = dtype
        self.device = device
        self.tracked = None
        self.duration = 0.0
        self.start_time = -1.0
        self.new_tracked = None
        self.new_start = -1.0
        self.receive_traj = False
        self.at_goal = False

    def _receive(self, flow_msg, msg):
        self.new_tracked = pad_tracked_traj(
            build_tracked_traj(flow_msg, n_grid=1024), self.PIECE_CAPACITY)
        self.new_start = float(msg.traj_start_time[0])
        self.receive_traj = True
        self.at_goal = False

    def _swap(self, t: float) -> bool:
        """Adopt a pending trajectory once t passes its start; False when
        there is nothing to track."""
        if not self.receive_traj and self.tracked is None:
            return False
        if self.new_tracked is not None and t > self.new_start:
            self.tracked = self.new_tracked
            self.duration = float(self.tracked.duration[0])
            self.start_time = self.new_start
            self.new_tracked = None
        return self.tracked is not None

    def _drop(self):
        self.receive_traj = False
        self.tracked = None
        self.start_time = -1.0

    def _tensor(self, v):
        return torch.tensor(np.asarray(v, float).reshape(1, -1),
                            dtype=self.dtype, device=self.device)


class _LtvNode(_TrackerNode):
    """mpc_controller node twin (CmdCallback, mpc.cpp:131-216)."""

    def __init__(self, cfg: LtvMpcConfig, dtype, device):
        super().__init__(cfg, dtype, device)
        self.carry = ltv_mpc_init(cfg, dtype, device=device)

    def receive(self, msg):
        # the LTV node integrates the flat flow WITHOUT the ICR lateral
        # term (TrajAnal getSeq, mpc_controller/include/.../traj_anal.hpp:
        # 50-81 -- no ICR anywhere in this node)
        icr = msg.icr.clone()
        icr[:, 2] = 0.0
        self._receive(msg._replace(icr=icr), msg)

    def tick(self, t: float, est_pose) -> Optional[tuple]:
        if not self._swap(t):
            return None
        if self.at_goal:
            # zero command, drop the trajectory (CmdCallback :142-157)
            self._drop()
            self.carry = ltv_mpc_init(self.cfg, self.dtype,
                                      device=self.device)
            return (0.0, 0.0)
        t_cur = t - self.start_time
        self.at_goal = t_cur > self.duration + 1.0   # getRefPoints :655
        cfg = self.cfg
        est = self._tensor(est_pose)
        xref, dref = ltv_ref_points(self.tracked, self._tensor(t_cur)[:, 0],
                                    cfg.horizon, cfg.dt, est[:, 2])
        self.carry, cmd = ltv_mpc_tick(self.carry, est, xref, dref, cfg)
        cmd = cmd[0].cpu().numpy().astype(float)
        return (float(cmd[0]), float(cmd[1]))


class _NmpcNode(_TrackerNode):
    """nmpc_controller node twin (the real-robot ACADO RTI tracker,
    nmpc_controller/src/mpc.cpp CmdCallback :173-240 + run :296-350).

    Publishes WHEEL speeds (v_r, v_l) = predicted u[:, delay_num];
    consumes the live EKF ICR estimate both for the wheel-speed
    references (getRefPoints :442-443) and as the solver's OnlineData
    (run :305-310).  The trajectory flow integrates with the Polynome's
    ICR xv -- zero under if_standard_diff, because MPCPathPub only
    fills the ICR field in the non-standard branch
    (plan_manager.hpp:824-828)."""

    def __init__(self, cfg, dtype, device):
        super().__init__(cfg if cfg is not None else NmpcConfig(), dtype,
                         device)
        self.carry = None            # solve_from_scratch_ pending
        self.prep_icr = None         # ICR the NEXT feedback's QP was
        #                              prepared with (od is read only at
        #                              preparation time, run :310)
        self.last_u = np.zeros(2)    # (vr, vl) of the latest solve

    def receive(self, msg):
        # under if_standard_diff the reference Polynome's ICR field is
        # never filled (MPCPathPub plan_manager.hpp:824-828), so the
        # TrajAnal flow integrates with xv = 0; the manager always
        # stamps its configured ICR -- zero it here to match the wire
        # contract (this twin composes the standard-diff launch)
        self._receive(msg._replace(icr=torch.zeros_like(msg.icr)), msg)

    def _icr(self, v):
        t = self._tensor(v)
        return ICRParams(yr=t[:, 0], yl=t[:, 1], xv=t[:, 2])

    def tick(self, t: float, est_pose, est_icr):
        """One CmdCallback.  Returns None (no odom/traj yet), or
        ("wheels", (vr, vl)), or ("at_goal", (vr, vl) stale) -- the
        at_goal branch also zeroes (v, omega) through the CarState
        path (:186-206)."""
        if not self._swap(t):
            return None
        if self.at_goal:
            self._drop()
            return ("at_goal", (float(self.last_u[0]),
                                float(self.last_u[1])))
        t_cur = t - self.start_time
        # getRefPoints sets the flag THIS tick; the zero-command branch
        # runs on the NEXT tick (:186, :427-433)
        self.at_goal = t_cur > self.duration + 1.0
        cfg = self.cfg
        est = self._tensor(est_pose)
        icr = self._icr(est_icr)
        ref_x, ref_u = ref_points(self.tracked, self._tensor(t_cur)[:, 0],
                                  cfg.horizon, cfg.dt, est[:, 2],
                                  wheel_icr=icr)
        if self.carry is None:
            # solve_from_scratch_ (run :317-320): one feedbackStep
            # against the constructor-prepared zero-trajectory QP with
            # the hard-coded ICR; see nmpc_cold_start_step
            self.carry, u_cmd, _, _ = nmpc_cold_start_step(
                est, ref_x, ref_u, cfg, self.dtype)
        else:
            # the QP this tick solves was prepared LAST tick with LAST
            # tick's EKF ICR (preparationThread, run :336); the wheel
            # references use the live one (getRefPoints :442-443)
            self.carry, u_cmd, _, _ = nmpc_rti_step(
                self.carry, est, ref_x, ref_u, icr, cfg,
                prep_icr=self._icr(self.prep_icr))
        # the preparation for the NEXT tick runs now, with THIS tick's
        # EKF ICR as its OnlineData
        self.prep_icr = np.asarray(est_icr, float)
        self.last_u = u_cmd[0].cpu().numpy().astype(float)
        return ("wheels", (float(self.last_u[0]), float(self.last_u[1])))


def _host_scan(occ, pose, lower, res, n_beams, n_steps, rng):
    """world/lidar.lidar_scan's exact arithmetic at f64 on the host (the
    oracle's generator runs in f64 and casts ranges to f32; a device-f32
    lattice could flip boundary cells)."""
    nx, ny = occ.shape
    angles = pose[2] + (np.arange(n_beams) / n_beams - 0.5) * 2.0 * np.pi
    ts = (np.arange(1, n_steps + 1) / n_steps) * rng
    pxs = pose[0] + np.cos(angles)[:, None] * ts[None, :]
    pys = pose[1] + np.sin(angles)[:, None] * ts[None, :]
    ix = np.clip(((pxs - lower[0]) / res).astype(int), 0, nx - 1)
    iy = np.clip(((pys - lower[1]) / res).astype(int), 0, ny - 1)
    inside = ((pxs >= lower[0]) & (pxs < lower[0] + nx * res)
              & (pys >= lower[1]) & (pys < lower[1] + ny * res))
    hit = np.where(inside, occ[ix, iy], False)
    any_hit = hit.any(1)
    ranges = np.where(any_hit, ts[hit.argmax(1)], rng).astype(np.float32)
    any_hit &= ranges < rng        # boundary-tie drop
    return ranges, any_hit


def run_planner_sim(scn: E2EScenario, pm_cfg: PlanManagerConfig,
                    ltv_cfg: LtvMpcConfig,
                    occ_cfg: OccupancyConfig = OccupancyConfig(),
                    dtype=torch.float32, tracker: str = "ltv",
                    nmpc_cfg=None, device=None) -> E2ETrace:
    """Run the composed closed loop for scn.sim_T seconds on `device`
    (None means the card).

    tracker: "ltv" composes the planner_sim.launch graph (LTV
    mpc_controller over the CarState instant-adoption path); "nmpc"
    composes the real-robot tracker (ACADO-RTI nmpc_controller over the
    CarControl wheel path: desired-velocity rate-limited plant with the
    live ICR lateral term, simulator.h:234-274)."""
    if tracker not in ("ltv", "nmpc"):
        raise ValueError(f"tracker must be 'ltv' or 'nmpc': {tracker!r}")
    dev = resolve_device(device)
    nx, ny = scn.grid.shape
    true_grid = scn.grid.copy()
    lower = np.asarray(scn.lower, float)
    res = scn.res

    # --- planner (starts in an all-unknown map: unknown plans as free)
    pm = PlanManager(occ=np.zeros((nx, ny), bool), lower=tuple(lower),
                     res=res, cfg=pm_cfg, device=dev)
    pm.set_goal(scn.goal, start_xyt=scn.start)

    # --- online map state (float32 on the device, as the JAX package
    # fuses whatever the planning dtype)
    raycast = scn.laser_mode == "raycast"
    map_state = occupancy_init((nx, ny), occ_cfg, torch.float32, dev)
    lower32 = torch.tensor(lower, dtype=torch.float32, device=dev)
    lcfg = LidarConfig(n_beams=scn.n_beams, fov_rad=2.0 * np.pi,
                       max_range=scn.detection_range)
    pending_cloud = None

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    # --- plant (host f64; the true world)
    px, py, pth = scn.start
    pv = pw = 0.0
    max_a_lim, max_w_lim = 2.0 * 0.01, 4.0 * 0.01   # quirk: publish interval
    # ControlSub path state (the NMPC composition): desired (v, omega)
    # and the lateral vy term, set per wheel command through the TRUE
    # ICR geometry (ControlSubCallback, simulator.h:234-242)
    des_v = des_w = vy_cur = 0.0
    yr_t, yl_t, xv_t = E2E_TRUE_ICR

    def wheels_to_desired(vr, vl):
        dw = (vr - vl) / (yl_t - yr_t)
        dv = (vl + vr) / 2.0 - dw * (yl_t + yr_t) / 2.0
        vy = -dw * xv_t
        return dv, dw, vy

    # --- EKF node state (cold start at the origin, icrekf.h:171-176)
    def lane(a):
        return torch.tensor(np.asarray(a, float)[None], dtype=dtype,
                            device=dev)

    ekf = ekf_init(lane(np.zeros(3)), E2E_EKF_ICR_INIT, E2E_EKF_CONFIG,
                   dtype)
    ekf_got_state = False
    ekf_got_u = False
    ekf_u = np.zeros(2)
    ekf_u_time = 0.0
    est_pub = None        # last published (wrapped-yaw) estimate

    # --- MPC node
    if tracker == "nmpc":
        mpc = _NmpcNode(nmpc_cfg, dtype, dev)
    else:
        mpc = _LtvNode(ltv_cfg, dtype, dev)
    est_icr = None

    map_dirty = False
    poses, cmds, ekf_rows, plans, states = [], [], [], [], []
    attempts = []
    last_state = None
    obs_added = scn.obs_t < 0
    n_steps = int(round(scn.sim_T * 1000))

    # the oracle's timers accumulate `next += period` (stub ros.h), so
    # sim time inside callbacks is the RUNNING FLOAT SUM of 0.001 -- not
    # k*0.001.  The replan gate compares these sums against replan_time
    # at 1 ms granularity, so the twin must accumulate identically to
    # reproduce the golden cadence bit for bit.
    t = 0.0
    for k in range(1, n_steps + 1):
        t += 1e-3

        # popup obstacle enters the TRUE world (harness stdin contract;
        # the harness schedules it on k*dt, not the accumulated clock)
        if not obs_added and k * 1e-3 >= scn.obs_t:
            x0, y0, x1, y1 = scn.obs_cells
            true_grid[max(0, x0):min(nx, x1), max(0, y0):min(ny, y1)] = True
            obs_added = True

        # laser capture BEFORE timers, at the plant pose entering this
        # step (harness inject_scan)
        if k % scn.laser_period_ms == 0:
            scan_pose = np.array([px, py, pth])
            if raycast:
                pending_cloud = _host_scan(true_grid, scan_pose, lower, res,
                                           scn.n_beams, lcfg.n_steps,
                                           scn.detection_range) \
                    + (scan_pose,)
            else:
                ix, iy = np.nonzero(true_grid)
                cx = lower[0] + (ix + 0.5) * res
                cy = lower[1] + (iy + 0.5) * res
                sel = (cx - px) ** 2 + (cy - py) ** 2 \
                    <= scn.detection_range ** 2
                pending_cloud = (np.stack([cx[sel], cy[sel]], -1), scan_pose)

        # --- 20 Hz occupancy fusion (SDFmap occ_timer, registered first)
        if k % 50 == 0 and pending_cloud is not None:
            if raycast:
                ranges, hits, scan_pose = pending_cloud
                map_state = occupancy_update(
                    map_state, lower32, res, f32(scan_pose), f32(ranges),
                    torch.as_tensor(hits, device=dev), lcfg, occ_cfg)
            else:
                pts, scan_pose = pending_cloud
                map_state = occupancy_update_perspective(
                    map_state, lower32, res, f32(scan_pose),
                    f32(pts).reshape(-1, 2),
                    torch.ones(len(pts), dtype=torch.bool, device=dev),
                    scn.detection_range, occ_cfg)
            pending_cloud = None
            occ_est, _, _ = occupancy_classes(map_state, occ_cfg)
            pm.occ = occ_est.cpu().numpy()
            map_dirty = True

        # --- 1 kHz MainThread.  have_geometry_ is set by the planner's
        # odom callback (GeometryCallback, plan_manager.hpp:175-176), so
        # the gate is "first EKF publish received"
        if est_pub is not None:
            msg = pm.tick(t, est_pub)
            if pm.last_loop_time == t:        # gate fired (plan attempted)
                attempts.append(t)
            if msg is not None:
                plans.append(dict(
                    t=t, traj_start=float(msg.traj_start_time[0]),
                    n_pieces=int(msg.piece_times.shape[1]),
                    duration=float(np.sum(msg.piece_times[0].cpu().numpy())),
                    start_xyt=msg.start_position[0].cpu().numpy().astype(
                        float),
                    inner=msg.inner_points[0].cpu().numpy().astype(float)))
                mpc.receive(msg)
        if pm.state is not last_state:
            last_state = pm.state
            states.append((t, pm.state))

        # --- 500 Hz plant propagation.  LTV composition: decay toward
        # desired = 0 (ControlSub never fed).  NMPC composition:
        # rate-limited tracking of the wheel-command desired + the
        # lateral vy term at the NEW theta (StatePropaCallback,
        # simulator.h:246-270; per-step limit uses the POSE PUBLISH
        # interval 0.01, not the 2 ms propagation dt)
        if k % 2 == 0:
            if abs(pv - des_v) < max_a_lim:
                pv = des_v
            else:
                pv += max_a_lim * np.sign(des_v - pv)
            if abs(pw - des_w) < max_w_lim:
                pw = des_w
            else:
                pw += max_w_lim * np.sign(des_w - pw)
            px += pv * 2e-3 * np.cos(pth)
            py += pv * 2e-3 * np.sin(pth)
            pth += pw * 2e-3
            if tracker == "nmpc":
                px -= vy_cur * 2e-3 * np.sin(pth)
                py += vy_cur * 2e-3 * np.cos(pth)

        # --- 100 Hz wheel feedback -> EKF predict (ControlSubCallback)
        if k % 10 == 0:
            u_now = np.array([pv - pw * E2E_TRUE_ICR[1],     # left
                              pv - pw * E2E_TRUE_ICR[0]])    # right
            if not ekf_got_u:
                ekf_u, ekf_u_time, ekf_got_u = u_now, t, True
            elif ekf_got_state:
                dt_u = t - ekf_u_time
                ekf = ekf_predict(ekf, lane(ekf_u),
                                  torch.tensor(dt_u, dtype=dtype, device=dev),
                                  E2E_EKF_CONFIG)
                ekf_u, ekf_u_time = u_now, t
            # (!get_state_: the stored command and stamp stay frozen,
            #  icrekf.cpp:81-91 -- the first post-odometry predict spans
            #  the whole cold-start gap)

        # --- 10 Hz odometry -> EKF update
        if k % 100 == 0:
            pose_obs = lane([px, py, pth])
            if not ekf_got_state:
                x = ekf.x.clone()
                x[:, :3] = pose_obs
                ekf = ekf._replace(x=x)
                ekf_got_state = True
            else:
                ekf = ekf_update(ekf, pose_obs, E2E_EKF_CONFIG)

        # --- 100 Hz MPC tick
        if k % 10 == 0 and est_pub is not None:
            if tracker == "nmpc":
                # CarControl wheel path: desired-velocity adoption
                # (ControlSubCallback); the at_goal branch additionally
                # zeroes (v, omega) instantly through the CarState
                # PoseSub path before the stale wheel publish
                out = mpc.tick(t, est_pub, est_icr)
                if out is not None:
                    kind, (vr, vl) = out
                    if kind == "at_goal":
                        pv = pw = 0.0           # PoseSub instant zero
                    des_v, des_w, vy_cur = wheels_to_desired(vr, vl)
                    cmds.append([t, vr, vl])
            else:
                # CarState path: command applied instantly (PoseSub)
                cmd = mpc.tick(t, est_pub)
                if cmd is not None:
                    pv, pw = cmd
                    cmds.append([t, cmd[0], cmd[1]])

        # --- 100 Hz EKF publish (timer registered last); the ICR
        # estimate rides along on EKF_ICR (state_pub_timer_callback)
        if k % 10 == 0:
            x = ekf.x[0].cpu().numpy().astype(float)
            yaw = float(normalize_angle(torch.tensor(x[2],
                                                     dtype=torch.float64)))
            est_pub = np.array([x[0], x[1], yaw])
            est_icr = np.array([x[3], x[4], x[5]])
            ekf_rows.append([t, x[0], x[1], x[2], x[3], x[4], x[5]])

        # --- 100 Hz ESDF refresh (after all timers; the re-enabled
        #     updateESDFCallback wiring).  Skipped while the occupancy
        #     is unchanged -- the ESDF is a pure function of it, so the
        #     refreshed field is identical.
        if k % 10 == 0:
            if map_dirty:
                pm.update_esdf()
                map_dirty = False
            poses.append([t, px, py, pth, pv, pw])

    return E2ETrace(poses=np.asarray(poses), cmds=np.asarray(cmds),
                    ekf=np.asarray(ekf_rows), plans=plans, states=states,
                    attempts=attempts)
