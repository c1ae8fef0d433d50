"""The LTV-MPC closed-loop tick: the mpc_controller node (3 rollout-QP
passes of 150 ADMM steps) on the ICR-EKF estimate and the simulator's
(v, omega) plant, over a lane batch, through
`parallel/mesh.py::batched_ltv_tracking_step`.

Built on the NMPC tracking driver (`drivers/tracking.py`): the same
seeded route, start offsets, kept ticks and record, so that its readers
read this cell too.  The EKF updates on the plant's pose plus a pose
measurement error drawn from the seed on the device and handed to the
tick.  The window runs with the port's tracer off, as the NMPC cells'
does.  After the window the float64 reference (`reference/ltv_tick.py`)
recomputes each kept tick from its input state.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# a program without the LTV tick fails here, when the cell is made
from alore_legged_manipulator_tpu_torch.parallel.mesh import (
    batched_ltv_tracking_step)

from ..reference import ltv_tick as ref_ltv
from . import tracking

# lanes of the reference computed at once (float64, about 5 GB at 4096)
_REF_BLOCK = 4096


class Cell(tracking.Cell):

    def setup(self):
        from alore_legged_manipulator_tpu_torch.control.ltv_mpc import (
            LtvMpcConfig, ltv_mpc_init)
        from alore_legged_manipulator_tpu_torch.control.tracked_traj import (
            build_tracked_traj)
        from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
        from alore_legged_manipulator_tpu_torch.estimator.icr_ekf import (
            EkfConfig, ekf_init)
        from alore_legged_manipulator_tpu_torch.planner.flat_traj import (
            Polynome)
        from alore_legged_manipulator_tpu_torch.utils.precision import (
            set_precision_policy)
        from alore_legged_manipulator_tpu_torch.world.plant import (
            PlantConfig, plant_init)

        set_precision_policy()
        cfg, tr, dev = self.cfg, self.traffic, self.dev
        f32 = torch.float32
        self.route = tracking.trajectory(cfg["trajectory"], self.seed)
        r = self.route
        msg = Polynome(
            traj_start_time=torch.zeros(1, dtype=f32, device=dev),
            inner_points=torch.tensor(r["inner"], dtype=f32, device=dev),
            piece_times=torch.tensor(r["times"], dtype=f32, device=dev),
            init_state=torch.tensor(r["init"], dtype=f32, device=dev),
            tail_state=torch.tensor(r["tail"], dtype=f32, device=dev),
            start_position=torch.tensor(r["start"], dtype=f32, device=dev),
            icr=torch.tensor([cfg["planner_icr"]], dtype=f32, device=dev))
        tt = build_tracked_traj(msg, n_grid=cfg["trajectory"]["n_grid"])
        self.ltv_cfg = LtvMpcConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["ltv"].items()})
        ekf_cfg = EkfConfig(**{k: tuple(v) for k, v in cfg["ekf"].items()})
        self.step = batched_ltv_tracking_step(
            tt, ICRParams(*cfg["true_icr"]), self.ltv_cfg, ekf_cfg,
            PlantConfig(**cfg["plant"]), cfg["substeps"])
        B = self.lanes
        g = torch.Generator(device=dev).manual_seed(self.seed)
        off = torch.rand((B, 3), generator=g, device=dev) * 2 - 1
        scale = torch.tensor([tr["start_offset_m"], tr["start_offset_m"],
                              tr["start_offset_rad"]], device=dev)
        x0 = torch.tensor(r["start"], dtype=f32, device=dev) + off * scale
        self.state = (plant_init(x0), ekf_init(x0, tuple(cfg["icr_guess"]),
                                               ekf_cfg),
                      ltv_mpc_init(self.ltv_cfg, f32, B, dev),
                      torch.zeros((B, 2), dtype=f32, device=dev))
        std = torch.tensor(cfg["meas_noise_stddev"], dtype=f32, device=dev)
        self.noise = torch.randn((tr["noise_ticks"], B, 3), generator=g,
                                 device=dev) * std
        self.offset = int(np.random.default_rng(
            [self.seed, 2]).integers(tr["check_every"]))
        for _ in range(tr["warmup_ticks"]):
            self._tick(keep=False)
        self._sync()

    def _tick(self, keep):
        k = self.k
        before = self.state
        out = self.step(*before, self.noise[k % self.noise.shape[0]],
                        k * self.ltv_cfg.dt)
        self.state = out[:4]
        self.k += 1
        if keep:
            self.kept.append((k, before, self.state))
        return out[3]

    def counters(self):
        """The configuration, for the readers that reckon its work."""
        return {"config": self.cfg}

    # -- the check ---------------------------------------------------------

    @staticmethod
    def _as_ref(state, lanes, dtype, dev):
        plant, ekf, carry, _ = state

        def c(x):
            return x[lanes].to(device=dev, dtype=dtype)
        return {"plant": {"xytheta": c(plant.xytheta), "v": c(plant.v),
                          "omega": c(plant.omega), "vy": c(plant.vy),
                          "s": c(plant.s)},
                "ekf_x": c(ekf.x), "ekf_P": c(ekf.P),
                "output": c(carry.output), "delay_buff": c(carry.delay_buff)}

    def readings(self, control=False):
        """The largest gap of each compared number over the kept ticks:
        the program's outputs (or, for the control, the reference's own
        in bfloat16) against the float64 reference."""
        dev = self.dev
        f64, low = torch.float64, torch.bfloat16
        route = self._route()
        traj = route.to(f64, dev)
        traj_low = route.to(low, dev) if control else None
        ltv = self.ltv_cfg._asdict()
        cfg = {"ltv": ltv, "ekf": self.cfg["ekf"], "plant": self.cfg["plant"],
               "substeps": self.cfg["substeps"]}
        true_icr = tuple(self.cfg["true_icr"])
        gap = {k: 0.0 for k in ("u_cmd_gap", "plan_gap", "ekf_state_gap",
                                "ekf_cov_rel_gap", "plant_gap")}

        def worst(name, a, b, scale=None):
            d = (a.to(f64) - b).abs()
            if scale is not None:
                d = d / scale
            v = float(d.max()) if bool(torch.isfinite(d).all()) else math.inf
            gap[name] = max(gap[name], v)

        for k, before, after in self.kept:
            t32 = float(torch.tensor(k * self.ltv_cfg.dt,
                                     dtype=torch.float32))
            for lo in range(0, self.lanes, _REF_BLOCK):
                lanes = slice(lo, min(lo + _REF_BLOCK, self.lanes))
                noise = self.noise[k % self.noise.shape[0]][lanes]
                ref, u_ref = ref_ltv.tick(
                    self._as_ref(before, lanes, f64, dev), noise.to(f64),
                    t32, traj, true_icr, cfg)
                if control:
                    got, u_got = ref_ltv.tick(
                        self._as_ref(before, lanes, low, dev), noise.to(low),
                        t32, traj_low, true_icr, cfg)
                else:
                    got = self._as_ref(after, lanes, f64, dev)
                    u_got = after[3][lanes]
                worst("u_cmd_gap", u_got, u_ref)
                worst("plan_gap", got["output"], ref["output"])
                worst("ekf_state_gap", got["ekf_x"], ref["ekf_x"])
                scale = ref["ekf_P"].abs().amax(dim=(1, 2))[:, None, None]
                worst("ekf_cov_rel_gap", got["ekf_P"], ref["ekf_P"], scale)
                for key in ("xytheta", "v", "omega", "vy", "s"):
                    worst("plant_gap", got["plant"][key], ref["plant"][key])
        return gap, {"checked_ticks": len(self.kept),
                     "checked_lane_ticks": len(self.kept) * self.lanes}
