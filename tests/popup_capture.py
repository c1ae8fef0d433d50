"""Capture the JAX plan manager's inputs at the `popup` golden's replan
attempts around the block drop (4.0-4.3 s), for
tests/test_torch_popup_attempt.py.

Runs the JAX package's `runtime/planner_sim.py::run_planner_sim` on
`tests/golden/e2e_oracle/goldens/popup.json.gz` with the configurations of
tests/test_torch_planner_sim.py::run_both (LTV-MPC, float64, CPU) to
4.31 s and records, at every plan attempt in [4.0, 4.3] s, what
`PlanManager._plan` is given: the start state, its velocity and
acceleration terms, the stitched start path, the goal and the ESDF.
Writes them to `alore_legged_manipulator_tpu_torch/data/popup_attempts.npz`.

    JAX_PLATFORMS=cpu python tests/popup_capture.py

takes about 75 s on one CPU.
"""
import gzip
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "alore_legged_manipulator_tpu_torch" / "data" / \
    "popup_attempts.npz"
T0, T1 = 4.0, 4.3


def scenario_and_config():
    import jax.numpy as jnp

    from alore_legged_manipulator_tpu.mission.plan_manager import (
        PlanManagerConfig)
    from alore_legged_manipulator_tpu.planner.backend import BackendConfig
    from alore_legged_manipulator_tpu.planner.frontend import FrontendConfig
    from alore_legged_manipulator_tpu.runtime import planner_sim as jps

    path = ROOT / "tests" / "golden" / "e2e_oracle" / "goldens" / \
        "popup.json.gz"
    with gzip.open(path, "rt") as f:
        golden = json.load(f)
    scn = jps.E2EScenario.from_golden(golden["scenario"])
    cfg = PlanManagerConfig(
        replan_period=scn.replan_time, max_replan_time=scn.max_replan_time,
        backend=BackendConfig(standard_diff=True),
        frontend=FrontendConfig(piece_buckets=(4, 8, 16, 24)),
        dtype=jnp.float64)
    return golden, scn, cfg


def main():
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from alore_legged_manipulator_tpu.control.ltv_mpc import LtvMpcConfig
    from alore_legged_manipulator_tpu.mission import plan_manager as jpm
    from alore_legged_manipulator_tpu.runtime import planner_sim as jps
    from alore_legged_manipulator_tpu.world.lidar import OccupancyConfig

    caps = []
    orig = jpm.PlanManager._plan

    def recording(self, start_xyt, start_vaj, start_oaj, t_now,
                  start_path=None):
        if T0 <= t_now <= T1:
            sp = (np.zeros((0, 2)) if start_path is None
                  else np.stack([np.asarray(p, float)[:2]
                                 for p in start_path]))
            caps.append(dict(
                t=np.float64(t_now), start_xyt=np.asarray(start_xyt, float),
                start_vaj=np.asarray(start_vaj, float),
                start_oaj=np.asarray(start_oaj, float), start_path=sp,
                goal=np.asarray(self.goal, float),
                lower=np.asarray(self.lower, float),
                res=np.float64(self.res),
                esdf_dist=np.asarray(self.esdf.dist),
                esdf_lower=np.asarray(self.esdf.lower),
                esdf_res=np.asarray(self.esdf.res)))
        return orig(self, start_xyt, start_vaj, start_oaj, t_now,
                    start_path=start_path)

    jpm.PlanManager._plan = recording
    _, scn, cfg = scenario_and_config()
    scn.sim_T = T1 + 0.01
    jps.run_planner_sim(scn, cfg, LtvMpcConfig(), OccupancyConfig(),
                        dtype=jnp.float64, tracker="ltv")
    out = {}
    for i, c in enumerate(caps):
        for k, v in c.items():
            out[f"{i}/{k}"] = v
    np.savez_compressed(OUT, **out)
    print(f"{len(caps)} attempts at", [float(c["t"]) for c in caps],
          "->", OUT)


if __name__ == "__main__":
    main()
