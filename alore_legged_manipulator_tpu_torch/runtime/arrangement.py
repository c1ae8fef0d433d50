"""Full object-rearrangement mission runtime (port of runtime/arrangement.py).

Composes the framework the way the reference runs its headline demo
(README.md:28): mission ordering -> task FSM -> robot approach -> grasp
-> object push (JPS + MINCO + NMPC closed loop with the EKF in the loop)
-> release -> map maintenance (items painted as obstacles, unlocked on
approach, targets locked after delivery -- plan_manager.hpp:470-496,
MapUpdateThread :500-554).

The approach runs the FSM's kinematic P-controllers on the host; the
push runs the planning/control stack on the mission's device
(`device=None` means the card): the kinematic ICR plant
(`simulate_tracking`) or the rigid-body contact plant
(`simulate_tracking_physics`), each on a lane axis of 1.  The
unknown-environment mode (`mapped=True`) needs world/lidar.py, which is
not ported yet, and raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.dynamics import ICRParams
from ..mission.object_fsm import FsmConfig, FsmState, ObjectFsm
from ..mission.ordering import greedy_order, pairwise_path_costs
from ..mission.plan_manager import PlanManager, PlanManagerConfig, PlanState
from ..planner.frontend import jps_search, world_to_grid
from .closed_loop import LoopConfig, simulate_tracking
from .closed_loop_physics import PhysicsLoopConfig, simulate_tracking_physics


@dataclass
class MissionReport:
    delivered: List[bool]
    order: List[int]
    sim_time_s: float
    push_tracking_err_p95: float
    final_object_err: List[float]
    # recorded when run(record_tracks=True): robot XY-theta samples and
    # one pushed-object track per task
    robot_track: Optional[np.ndarray] = None
    object_tracks: Optional[List[np.ndarray]] = None


@dataclass
class ArrangementMission:
    occ: np.ndarray
    lower: tuple
    res: float
    items: List[np.ndarray]
    targets: List[np.ndarray]
    true_icr: ICRParams = field(
        default_factory=lambda: ICRParams(-0.3, 0.3, 0.2))
    pm_cfg: PlanManagerConfig = field(default_factory=PlanManagerConfig)
    fsm_cfg: FsmConfig = field(default_factory=FsmConfig)
    loop_cfg: LoopConfig = field(default_factory=LoopConfig)
    robot_dt: float = 0.05
    # push-phase plant: False = the kinematic ICR simulator twin; True =
    # the rigid-body contact engine with the EKF identifying the ICR
    use_physics_plant: bool = False
    phys_cfg: object = None      # PhysicsLoopConfig override
    # unknown-environment mode (lidar-built map): not ported yet
    mapped: bool = False
    device: object = None        # planning/tracking device; None = the card

    def _path_len(self, blocked, a, b):
        cells = jps_search(blocked.astype(np.uint8),
                           world_to_grid(np.asarray(a)[:2], self.lower,
                                         self.res),
                           world_to_grid(np.asarray(b)[:2], self.lower,
                                         self.res))
        if cells is None:
            return np.inf
        d = np.diff(cells.astype(float), axis=0)
        return float((np.abs(d).max(1)
                      + (np.sqrt(2) - 1) * np.abs(d).min(1)).sum()) * self.res

    def _push(self, tracked, dur: float, seed: int):
        """Closed-loop push of the planned object trajectory (a lane axis
        of 1).  Returns (ticks, object track (T, 3), pos_err within the
        trajectory's duration, robot pose after the push or None)."""
        ticks = int(dur / 0.01) + 60
        if self.use_physics_plant:
            # ticks in multiples of 200, as the JAX package buckets them
            # for its compile cache, so the settle time matches
            ticks = ((ticks + 199) // 200) * 200
            res = simulate_tracking_physics(
                tracked, ticks, self.phys_cfg or PhysicsLoopConfig(),
                seed=seed)
            # the padded settle ticks compare against a reference held
            # past the end: error statistics stay inside the duration
            return (ticks, res.obj_xytheta[0].cpu().numpy(),
                    res.pos_err[0, :int(dur / 0.01)].cpu().numpy(),
                    res.robot_xytheta[0, -1].cpu().numpy())
        res = simulate_tracking(tracked, self.true_icr, ticks, self.loop_cfg,
                                seed=seed)
        return (ticks, res.xytheta[0].cpu().numpy(),
                res.pos_err[0].cpu().numpy(), None)

    def run(self, robot_start, verbose: bool = False,
            record_tracks: bool = False) -> MissionReport:
        if self.mapped:
            raise NotImplementedError(
                "mapped=True needs world/lidar.py (lidar scans and "
                "occupancy fusion) and MappedPlanManager, which are not "
                "ported yet")
        pm = PlanManager(occ=self.occ.copy(), lower=self.lower, res=self.res,
                         cfg=self.pm_cfg, device=self.device)
        n = len(self.items)

        # visit order from JPS path costs BEFORE painting (the reference
        # orders in task_plan_callback, then MapUpdateThread paints)
        pts = [np.asarray(robot_start, float)] \
            + [np.asarray(i, float) for i in self.items] \
            + [np.asarray(t, float) for t in self.targets]
        blocked = pm.esdf.dist.cpu().numpy() < 0.3
        D = pairwise_path_costs(pts, lambda a, b: self._path_len(blocked, a, b))
        order_idx, _ = greedy_order(D, n)
        item_order = [i - 1 for i in order_idx[::2]]
        if len(item_order) != n:
            raise RuntimeError("mission ordering failed (unreachable?)")

        # paint all items as obstacles (MapUpdateThread :509-521)
        for it in self.items:
            pm.paint_square(np.asarray(it)[:2], half_size=0.25)

        fsm = ObjectFsm(items=[np.asarray(i, float) for i in self.items],
                        targets=[np.asarray(t, float) for t in self.targets],
                        order=item_order, cfg=self.fsm_cfg)

        robot = np.asarray(robot_start, float).copy()
        obj_poses = [np.asarray(i, float).copy() for i in self.items]
        t_sim = 0.0
        push_errs: List[float] = []
        delivered = [False] * n
        robot_track: List[np.ndarray] = []
        object_tracks: List[np.ndarray] = []

        guard = 0
        while fsm.state != FsmState.DONE and guard < 20000:
            guard += 1
            cur_i = fsm.order[fsm.task_idx] if fsm.task_idx < n else 0
            cur_obj = obj_poses[cur_i]

            if fsm.state in (FsmState.WAIT_TASK_PLANNING,
                             FsmState.ROBOT_TRACKING, FsmState.GRASPING):
                if fsm.state == FsmState.WAIT_TASK_PLANNING:
                    fsm.tick(robot, cur_obj)
                    continue
                fsm.tick(robot, cur_obj)
                rv = fsm.robot_vel_cmd
                robot[0] += rv[0] * np.cos(robot[2]) * self.robot_dt
                robot[1] += rv[0] * np.sin(robot[2]) * self.robot_dt
                robot[2] += rv[2] * self.robot_dt
                t_sim += self.robot_dt
                if record_tracks and guard % 5 == 0:
                    robot_track.append(robot.copy())

            elif fsm.state == FsmState.WAIT_ROBOT_PATH:
                # unlock the item area for approach (MapUpdateThread :526-533)
                pm.paint_square(cur_obj[:2], half_size=0.3, make_obs=False)
                blocked = pm.esdf.dist.cpu().numpy() < 0.25
                cells = jps_search(blocked.astype(np.uint8),
                                   world_to_grid(robot[:2], self.lower,
                                                 self.res),
                                   world_to_grid(cur_obj[:2], self.lower,
                                                 self.res))
                if cells is None:
                    raise RuntimeError("no robot path to item")
                path = [np.asarray(self.lower)
                        + (c.astype(float) + 0.5) * self.res
                        for c in cells[::max(1, len(cells) // 8)]]
                fsm.set_robot_path(path + [cur_obj[:2]])

            elif fsm.state == FsmState.WAIT_OBJECT_PATH:
                # plan the object push with the planner stack
                target = fsm.current_target()
                pm.state = PlanState.IDLE
                pm.plan_start_time = -1.0
                pm.set_goal(target)
                msg = pm.tick(t_sim, np.array([cur_obj[0], cur_obj[1],
                                               robot[2]]))
                if msg is None:
                    raise RuntimeError(f"object planning failed: {pm.state}")
                dur = float(pm.tracked.duration[0])
                ticks, track, perr, robot_end = self._push(pm.tracked, dur,
                                                           guard)
                push_errs.append(float(np.percentile(perr, 95)))
                if record_tracks:
                    object_tracks.append(track)
                final = track[-1]
                obj_poses[cur_i] = final.copy()
                if robot_end is not None:
                    # the contact rollout simulated the real robot too
                    robot[:] = robot_end
                else:
                    robot[:2] = final[:2] - 0.6 * np.array(
                        [np.cos(final[2]), np.sin(final[2])])
                    robot[2] = final[2]
                t_sim += ticks * 0.01
                fsm.object_path_ready()
                fsm.state = FsmState.RELEASING
                fsm.release_count = 0

            elif fsm.state == FsmState.RELEASING:
                fsm.tick(robot, cur_obj)
                t_sim += self.robot_dt
                if fsm.state in (FsmState.WAIT_ROBOT_PATH, FsmState.DONE):
                    # lock the delivered target (MapUpdateThread :536-549)
                    tgt = self.targets[cur_i]
                    delivered[cur_i] = bool(np.linalg.norm(
                        obj_poses[cur_i][:2] - np.asarray(tgt)[:2]) < 0.3)
                    pm.paint_square(np.asarray(tgt)[:2], half_size=0.25)

            if verbose and guard % 200 == 0:
                print(f"  t={t_sim:7.2f}s state={fsm.state.name} "
                      f"task {fsm.task_idx}/{n}")

        errs = [float(np.linalg.norm(obj_poses[i][:2]
                                     - np.asarray(self.targets[i])[:2]))
                for i in range(n)]
        return MissionReport(
            delivered=delivered, order=item_order, sim_time_s=t_sim,
            push_tracking_err_p95=float(np.max(push_errs)) if push_errs
            else 0.0,
            final_object_err=errs,
            robot_track=(np.asarray(robot_track) if record_tracks
                         and robot_track else None),
            object_tracks=object_tracks if record_tracks else None)
