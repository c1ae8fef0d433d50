"""The MINCO back end: `planner/backend.py::plan_backend` over a map whose
ESDF is built in set-up, one call after another.

Every goal is drawn from the run's seed.  The goal box is cut into a
grid of strata; each pass over the grid visits every stratum once, in
an order drawn from the seed, with a goal uniform inside it, so that
every seed asks for different goals spread alike over the box.  A call
plans `lanes` goals; `pool` calls, a whole number of passes, are drawn
in set-up, more than a window can plan; the window plans them in turn
until `seconds` have passed.  Each call ends when its result is on the
host, as the plan manager hands it on.  The window's rate counts the
plans of the whole passes it finished, over the time to the end of the
last of them, so that every seed's rate is over goals spread alike; a
window that finishes no whole pass is an error.  After the window every
plan is judged (`reference/plan.py`), those of an unfinished pass too,
and a sample of them, drawn from the seed across every call, is solved
again by the plain solver (`reference/solve.py`) and compared by its
objective.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import frozen
from ..reference import plan as ref_plan
from ..reference import solve as ref_solve
from ..reference import spline as ref_spline

_FIELDS = ("coeffs", "times", "inner", "tail_state", "final_xy_err",
           "collision", "replans", "stage2_iters")


def stratified_goals(n, seed, box, strata):
    """n goals (n, 2): passes over a strata[0] x strata[1] grid of the
    box ((x0, x1), (y0, y1)), each stratum once a pass, in an order drawn
    from the seed, each goal uniform inside its stratum."""
    rng = np.random.default_rng([int(seed), 11])
    (x0, x1), (y0, y1) = box
    nx, ny = strata
    cells = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                 indexing="ij"), -1).reshape(-1, 2)
    order = np.concatenate([rng.permutation(len(cells))
                            for _ in range(-(-n // len(cells)))])[:n]
    u = rng.uniform(size=(n, 2))
    c = cells[order]
    return np.stack([x0 + (c[:, 0] + u[:, 0]) * (x1 - x0) / nx,
                     y0 + (c[:, 1] + u[:, 1]) * (y1 - y0) / ny], 1)


def backend_config(cfg):
    """The program's BackendConfig, every setting from the configuration."""
    from alore_legged_manipulator_tpu_torch.planner.backend import (
        AlmConfig, BackendConfig, BackendWeights, PathWeights)

    base = BackendConfig()
    a = cfg["alm"]
    alm = AlmConfig(lambda0=tuple(a["lambda0"]), rho0=tuple(a["rho0"]),
                    rho_max=tuple(a["rho_max"]), gamma=tuple(a["gamma"]),
                    tolerance=a["tolerance"], max_outer=a["max_outer"])
    return BackendConfig(
        **cfg["backend"], energy_weights=tuple(cfg["energy_weights"]),
        checkpoints=tuple(tuple(p) for p in cfg["checkpoints"]),
        weights=BackendWeights(**cfg["weights"]),
        path_weights=PathWeights(**cfg["path_weights"]), alm=alm,
        lbfgs=base.lbfgs._replace(**cfg["lbfgs"]),
        path_lbfgs=base.path_lbfgs._replace(**cfg["path_lbfgs"]),
        shot_path_past=cfg["short_path"]["past"],
        shot_path_horizon=cfg["short_path"]["horizon"])


def calls_per_pass(strata, lanes):
    """Calls that make up a whole number of passes over the grid, the
    fewest: a call of 512 lanes holds 32 passes of a 4 x 4 grid, a pass
    of a 2 x 4 grid is 8 calls of one lane."""
    cells = strata[0] * strata[1]
    return math.lcm(cells, lanes) // lanes


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.dev = torch.device(device)
        self.lanes = int(traffic["lanes"])
        self.per_pass = calls_per_pass(traffic["strata"], self.lanes)
        if traffic["pool"] % self.per_pass:
            raise ValueError(f"pool {traffic['pool']} is no whole number of "
                             f"passes of {self.per_pass} calls")
        self.done = []          # (request fields, result fields), host
        self.counted = 0        # calls of the window's whole passes
        self._solved = {}       # (call, lane) -> the f64 reference's plan

    def setup(self):
        from alore_legged_manipulator_tpu_torch.ops.esdf import (
            esdf_from_occupancy)
        from alore_legged_manipulator_tpu_torch.planner.backend import (
            plan_backend)
        from alore_legged_manipulator_tpu_torch.planner.flat_traj import (
            FlatTraj)
        from alore_legged_manipulator_tpu_torch.utils.precision import (
            set_precision_policy)

        set_precision_policy()
        cfg, tr, dev = self.cfg, self.traffic, self.dev
        m = cfg["map"]
        self.occ = np.zeros(m["shape"], bool)
        for r0, r1, c0, c1 in m["blocks"]:
            self.occ[r0:r1, c0:c1] = True
        self.esdf = esdf_from_occupancy(torch.as_tensor(self.occ, device=dev),
                                        torch.tensor(m["lower"]), m["res"])
        self.bcfg = backend_config(cfg)
        self.flat_cls, self.plan = FlatTraj, plan_backend
        box = (cfg["goal_box"]["x"], cfg["goal_box"]["y"])
        goals = stratified_goals(tr["pool"] * self.lanes + self.lanes,
                                 self.seed, box, tr["strata"])
        # the requests as the host hands them over: float32 front-end
        # guesses, made once on the host; the pool's calls begin at a
        # pass's first goal, and the call drawn after them warms up
        calls = [self._request(g) for g in goals.reshape(-1, self.lanes, 2)]
        self.calls = calls[:-1]
        self._call(calls[-1], keep=False)

    def _request(self, goals):
        return frozen.straight_flats(
            torch.as_tensor(goals, dtype=torch.float32), self.cfg["start"],
            self.cfg["front_end_pieces"])

    def _call(self, req, keep):
        flat = self.flat_cls(**{k: v.to(self.dev) for k, v in req.items()})
        res = self.plan(flat, self.esdf, self.bcfg)
        host = {f: getattr(res, f).cpu() for f in _FIELDS}
        if keep:
            self.done.append((req, host))
        return host

    def window(self, seconds):
        """The pool's calls in turn until `seconds` have passed; the rate's
        requests, time and failures are those of the whole passes."""
        lat, ends = [], []
        t0 = time.perf_counter()
        for i in range(10 ** 9):
            ts = time.perf_counter()
            self._call(self.calls[i % len(self.calls)], keep=True)
            ends.append(time.perf_counter())
            lat.append(ends[-1] - ts)
            if ends[-1] - t0 >= seconds:
                break
        n = len(lat) // self.per_pass * self.per_pass
        if n == 0:
            raise RuntimeError(
                f"the window of {seconds} s planned {len(lat)} calls and "
                f"finished no whole pass of {self.per_pass}: no rate")
        self.counted = n
        # a plan that states no finite answer, or states that it could
        # not clear the map, has failed
        failed = sum(int((~torch.isfinite(h["coeffs"]).flatten(1).all(1)
                          | ~torch.isfinite(h["final_xy_err"]).all(1)
                          | h["collision"].bool()).sum())
                     for _, h in self.done[:n])
        return {"latencies_s": lat[:n], "elapsed_s": ends[n - 1] - t0,
                "requests": n, "lanes": self.lanes, "failed": failed}

    def stretch(self, brief=False):
        """The traced stretch: the pool's first `trace_calls` calls (a
        quarter of them when brief)."""
        n = self.traffic["trace_calls"]
        n = max(1, n // 4) if brief else n
        for req in self.calls[:n]:
            self._call(req, keep=False)
        return n

    def counters(self):
        """Over the plans that the rate counts: the means of the stage-2
        iterations and of the attempts of the collision loop, and the
        lanes' imbalance, each call's most stage-2 iterations over its
        mean, averaged over the calls."""
        done = self.done[:self.counted]
        its = [h["stage2_iters"].double() for _, h in done]
        rp = torch.cat([h["replans"] for _, h in done]).double()
        return {"stage2_iters": float(torch.cat(its).mean()),
                "replans": float(rp.mean()),
                "lane_imbalance": sum(float(i.max() / i.mean())
                                      for i in its) / len(its)}

    def release(self):
        self.esdf = self.plan = None

    # -- the check ---------------------------------------------------------

    @staticmethod
    def _ref_request(req, dtype):
        """The request handed to the program, as the reference reads it."""
        return {"head": req["start_state"].to(dtype),
                "final_state": req["final_state"].to(dtype),
                "start_xy": req["start_xytheta"][:, :2].to(dtype),
                "goal_xy": req["final_xytheta"][:, :2].to(dtype)}

    def _sample(self):
        """(call, lane) of the plans that the plain solver solves again,
        drawn from the seed among every plan of the window."""
        total = len(self.done) * self.lanes
        n = min(self.traffic["solve_sample"], total)
        rng = np.random.default_rng([self.seed, 13])
        return [divmod(k, self.lanes) for k in
                sorted(rng.choice(total, n, replace=False).tolist())]

    @staticmethod
    def _one_lane(fields, lane):
        return {k: v[lane:lane + 1] for k, v in fields.items()}

    def _reference_plan(self, key, dist, dtype):
        """The plain solver's plan for the sampled (call, lane)."""
        i, lane = key
        req = self._one_lane(self.done[i][0], lane)
        prob = ref_solve.Problem(req, dist, self.cfg, dtype)
        return prob, ref_solve.solve(prob)

    def _control_plans(self, sample, rcfg):
        """The reference in bfloat16 in the program's place: the plain
        solver's plans for the sample, with the answers a plan states
        worked out in bfloat16."""
        low = torch.bfloat16
        dist = ref_spline.esdf(self.occ, rcfg["map_res"], low)
        lim = self.cfg["backend"]["final_min_safe_dis"]
        plans = []
        for key in sample:
            req = self._one_lane(self.done[key[0]][0], key[1])
            _, sol = self._reference_plan(key, dist, low)
            dec = {"inner": sol["inner"], "times": sol["times"],
                   "tail_s": sol["tail_s"]}
            got = ref_plan.derive(self._ref_request(req, low), dec, dist,
                                  rcfg)
            tail = req["final_state"].to(low).clone()
            tail[:, 1, 0] = sol["tail_s"]
            plans.append((req, {
                "coeffs": got["coeffs"], "times": sol["times"],
                "inner": sol["inner"], "tail_state": tail,
                "final_xy_err": got["final_xy_err"],
                "collision": got["clearance"] < lim}))
        return plans

    def readings(self, control=False):
        """The numbers compared, over every plan of the window (for the
        control, over the sample that it plans): the largest gaps between
        what a plan states and what its decision variables imply by the
        reference; the flags that disagree; the plans left at their
        guess; the plans that could not clear the map; the largest final
        XY error of a clear plan by the reference; and, over the sample,
        the largest share by which a plan's objective exceeds that of
        the plain solver's plan."""
        f64 = torch.float64
        b = self.cfg["backend"]
        rcfg = {"standard_diff": b["standard_diff"], "icr_xv": b["icr_xv"],
                "sparse_resolution": b["sparse_resolution"],
                "final_check_resolution": b["final_check_resolution"],
                "map_lower": self.cfg["map"]["lower"],
                "map_res": self.cfg["map"]["res"]}
        dist = ref_spline.esdf(self.occ, rcfg["map_res"], f64)
        sample = self._sample()
        if control:
            plans = self._control_plans(sample, rcfg)
            judged = [(key, h) for key, (_, h) in zip(sample, plans)]
        else:
            plans = self.done
            judged = [(key, self._one_lane(self.done[key[0]][1], key[1]))
                      for key in sample]
        lim = b["final_min_safe_dis"]
        band = self.traffic["clearance_band_m"]
        gap = {"spline_gap": 0.0, "final_xy_gap": 0.0,
               "collision_flag_mismatches": 0, "unmoved_plans": 0,
               "colliding_plans": 0, "final_xy_err": 0.0,
               "objective_excess": -math.inf}

        def worst(name, d):
            v = float(d.max()) if bool(torch.isfinite(d).all()) else math.inf
            gap[name] = max(gap[name], v)

        n_plans = 0
        for given, h in plans:
            req = self._ref_request(given, f64)
            dec = {"inner": h["inner"].to(f64), "times": h["times"].to(f64),
                   "tail_s": h["tail_state"][:, 1, 0].to(f64)}
            ref = ref_plan.derive(req, dec, dist, rcfg)
            s_got = ref_plan.flat_samples(h["coeffs"].to(f64), dec["times"])
            s_ref = ref_plan.flat_samples(ref["coeffs"], dec["times"])
            worst("spline_gap", (s_got - s_ref).abs())
            worst("final_xy_gap",
                  (h["final_xy_err"].to(f64) - ref["final_xy_err"]).abs())
            said = h["collision"].bool()
            flag = ref["clearance"] < lim
            clear = (ref["clearance"] - lim).abs() > band
            gap["collision_flag_mismatches"] += int(
                ((said != flag) & clear).sum())
            gap["colliding_plans"] += int(said.sum())
            err = torch.linalg.vector_norm(ref["final_xy_err"], dim=-1)
            worst("final_xy_err", torch.where(said, torch.zeros_like(err),
                                              err))
            moved = torch.cat([
                (h["inner"].float() - given["inner_yaw_s"]).abs().flatten(1),
                (h["tail_state"][:, 1, 0].float()
                 - given["final_state"][:, 1, 0]).abs()[:, None],
                (h["times"].float()
                 - given["init_piece_time"][:, None]).abs()], 1)
            gap["unmoved_plans"] += int((moved.amax(1) < 1e-5).sum())
            n_plans += h["times"].shape[0]

        for key, h in judged:
            if key not in self._solved:
                self._solved[key] = self._reference_plan(key, dist, f64)
            prob, sol = self._solved[key]
            best = prob.objective(sol["inner"], sol["tail_s"], sol["times"])
            got = prob.objective(h["inner"][:1].to(f64),
                                 h["tail_state"][:1, 1, 0].to(f64),
                                 h["times"][:1].to(f64))
            worst("objective_excess", (got - best) / best.abs())
        return gap, {"checked_plans": n_plans, "solved_plans": len(judged)}
