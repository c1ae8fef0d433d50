"""The closed-loop tracking tick: NMPC RTI + ICR-EKF + 500 Hz plant over
a lane batch, through `parallel/mesh.py::batched_tracking_step`.

Each lane tracks one MINCO Polynome made from the seed; the plant noise
is drawn from the seed on the device and handed to the tick, so that the
reference can take the same draws.  Every tick of the window, or of the
traced stretch, continues the same closed loop.  Ticks whose index is
`offset + j * check_every` (offset from the seed) keep their input and
output states; after the window the reference (`reference/tick.py`)
recomputes each kept tick from its input state and the gaps are judged
against the traffic file's limits.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..reference import spline as ref_spline
from ..reference import tick as ref_tick

# ticks of the reference computed at once on the fleet
_REF_BLOCK = 2048


def trajectory(gen_cfg, seed):
    """The seed's reference route as Polynome fields (numpy, one lane):
    `pieces` pieces of `piece_time` s from rest to rest, each turning by
    a uniform draw in +-turn rad and advancing a uniform draw in `step`
    m, from the origin at a uniform heading."""
    rng = np.random.default_rng([seed, 1])
    n, T = gen_cfg["pieces"], gen_cfg["piece_time"]
    yaw0 = rng.uniform(-math.pi, math.pi)
    yaw = yaw0 + np.cumsum(rng.uniform(-gen_cfg["turn"], gen_cfg["turn"], n))
    s = np.cumsum(rng.uniform(*gen_cfg["step"], n))
    return {
        "inner": np.stack([yaw[:-1], s[:-1]])[None],
        "times": np.full((1, n), T),
        "init": np.array([[[yaw0, 0, 0], [0, 0, 0]]]),
        "tail": np.array([[[yaw[-1], 0, 0], [s[-1], 0, 0]]]),
        "start": np.array([[0.0, 0.0, yaw0]]),
    }


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.dev = torch.device(device)
        self.lanes = int(traffic["lanes"])
        self.k = 0
        self.kept = []

    # -- program side ------------------------------------------------------

    def setup(self):
        from alore_legged_manipulator_tpu_torch.control.nmpc import (
            NmpcConfig, nmpc_init)
        from alore_legged_manipulator_tpu_torch.control.tracked_traj import (
            build_tracked_traj)
        from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
        from alore_legged_manipulator_tpu_torch.estimator.icr_ekf import (
            EkfConfig, ekf_init)
        from alore_legged_manipulator_tpu_torch.parallel.mesh import (
            batched_tracking_step)
        from alore_legged_manipulator_tpu_torch.planner.flat_traj import (
            Polynome)
        from alore_legged_manipulator_tpu_torch.utils.precision import (
            set_precision_policy)
        from alore_legged_manipulator_tpu_torch.world.plant import (
            PlantConfig, plant_init)

        set_precision_policy()
        cfg, tr, dev = self.cfg, self.traffic, self.dev
        f32 = torch.float32
        self.route = trajectory(cfg["trajectory"], self.seed)
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
        self.nmpc_cfg = NmpcConfig(**cfg["nmpc"])
        ekf_cfg = EkfConfig(**{k: tuple(v) for k, v in cfg["ekf"].items()})
        plant_cfg = PlantConfig(**cfg["plant"])
        icr = ICRParams(*cfg["true_icr"])
        self.step = batched_tracking_step(tt, icr, self.nmpc_cfg, ekf_cfg,
                                          plant_cfg, cfg["substeps"])
        B = self.lanes
        g = torch.Generator(device=dev).manual_seed(self.seed)
        off = torch.rand((B, 3), generator=g, device=dev) * 2 - 1
        scale = torch.tensor([tr["start_offset_m"], tr["start_offset_m"],
                              tr["start_offset_rad"]], device=dev)
        x0 = torch.tensor(r["start"], dtype=f32, device=dev) + off * scale
        self.state = (plant_init(x0), ekf_init(x0, tuple(cfg["icr_guess"]),
                                               ekf_cfg),
                      nmpc_init(self.nmpc_cfg, x0),
                      torch.zeros((B, 2), dtype=f32, device=dev))
        self.noise = torch.randn((tr["noise_ticks"], B, cfg["substeps"], 2),
                                 generator=g, device=dev)
        self.offset = int(np.random.default_rng([self.seed, 2]).integers(
            tr["check_every"]))
        for _ in range(tr["warmup_ticks"]):
            self._tick(keep=False)
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _tick(self, keep):
        k = self.k
        before = self.state
        noise = self.noise[k % self.noise.shape[0]]
        out = self.step(*before, noise, k * self.nmpc_cfg.dt)
        self.state = out[:4]
        self.k += 1
        if keep:
            self.kept.append((k, before, self.state))
        return out[3]

    def window(self, seconds):
        """Ticks until `seconds` have passed.  Returns the host-clock
        seconds of each tick (read to the host when `read_command`) and
        of the whole window, the card's work included."""
        every, read = self.traffic["check_every"], self.traffic["read_command"]
        lat = []
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            u = self._tick(keep=self.k % every == self.offset)
            if read:
                u.cpu()
            te = time.perf_counter()
            lat.append(te - ts)
            if te - t0 >= seconds:
                break
        self._sync()
        return {"latencies_s": lat, "elapsed_s": time.perf_counter() - t0,
                "requests": len(lat), "lanes": self.lanes, "failed": 0}

    def stretch(self, brief=False):
        """The traced stretch: `trace_ticks` more ticks of the loop (a
        quarter of them when brief)."""
        n = self.traffic["trace_ticks"]
        n = max(1, n // 4) if brief else n
        for _ in range(n):
            u = self._tick(keep=False)
            if self.traffic["read_command"]:
                u.cpu()
        return n

    def counters(self):
        return {}

    def release(self):
        """Drop the program's state but what the check reads."""
        self.state = self.step = None

    # -- the check ---------------------------------------------------------

    def _route(self):
        """The route as the reference reads it: its spline and flow
        solved in float64 on the host from the Polynome's fields."""
        t = {k: torch.tensor(v, dtype=torch.float64)
             for k, v in self.route.items()}
        return ref_spline.WorldTraj(
            t["init"], t["tail"], t["inner"], t["times"], t["start"][:, :2],
            torch.tensor([self.cfg["planner_icr"]], dtype=torch.float64))

    @staticmethod
    def _as_ref(state, lanes, dtype, dev):
        plant, ekf, carry, u_prev = state

        def c(x):
            return x[lanes].to(device=dev, dtype=dtype)
        return {"plant": {"xytheta": c(plant.xytheta), "v": c(plant.v),
                          "omega": c(plant.omega), "vy": c(plant.vy),
                          "s": c(plant.s)},
                "ekf_x": c(ekf.x), "ekf_P": c(ekf.P),
                "x_traj": c(carry.x_traj), "u_traj": c(carry.u_traj),
                "u_prev": c(u_prev)}

    def readings(self, control=False):
        """The largest gap of each compared number over the kept ticks:
        the program's outputs (or, for the control, the reference's own
        in bfloat16) against the float64 reference."""
        dev = self.dev
        f64 = torch.float64
        route = self._route()
        traj = route.to(f64, dev)
        low = torch.bfloat16
        # the control reads the float64 route rounded to bfloat16
        traj_low = route.to(low, dev) if control else None
        cfg = {"nmpc": self.nmpc_cfg._asdict(), "ekf": self.cfg["ekf"],
               "plant": self.cfg["plant"], "substeps": self.cfg["substeps"]}
        true_icr = tuple(self.cfg["true_icr"])
        gap = {k: 0.0 for k in ("u_cmd_gap", "guess_gap", "ekf_state_gap",
                                "ekf_cov_rel_gap", "plant_gap")}

        def worst(name, a, b, scale=None):
            d = (a.to(f64) - b).abs()
            if scale is not None:
                d = d / scale
            v = float(d.max()) if bool(torch.isfinite(d).all()) else math.inf
            gap[name] = max(gap[name], v)

        for k, before, after in self.kept:
            # the tick's time as the program rounds it
            t32 = float(torch.tensor(k * self.nmpc_cfg.dt,
                                     dtype=torch.float32))
            for lo in range(0, self.lanes, _REF_BLOCK):
                lanes = slice(lo, min(lo + _REF_BLOCK, self.lanes))
                noise = self.noise[k % self.noise.shape[0]][lanes]
                ref, _ = ref_tick.tick(self._as_ref(before, lanes, f64, dev),
                                       noise.to(f64), t32, traj, true_icr, cfg)
                if control:
                    got, _ = ref_tick.tick(
                        self._as_ref(before, lanes, low, dev), noise.to(low),
                        t32, traj_low, true_icr, cfg)
                else:
                    got = self._as_ref(after, lanes, f64, dev)
                worst("u_cmd_gap", got["u_prev"], ref["u_prev"])
                worst("guess_gap", got["x_traj"], ref["x_traj"])
                worst("guess_gap", got["u_traj"], ref["u_traj"])
                worst("ekf_state_gap", got["ekf_x"], ref["ekf_x"])
                scale = ref["ekf_P"].abs().amax(dim=(1, 2))[:, None, None]
                worst("ekf_cov_rel_gap", got["ekf_P"], ref["ekf_P"], scale)
                for key in ("xytheta", "v", "omega", "vy", "s"):
                    worst("plant_gap", got["plant"][key], ref["plant"][key])
        return gap, {"checked_ticks": len(self.kept),
                     "checked_lane_ticks": len(self.kept) * self.lanes}
