"""End-to-end closed-loop demo (twin of examples/planner_sim.py).

The full stack as the reference wires its ROS nodes
(plan_manager/launch/planner_sim.launch): ground-truth map -> ESDF ->
JPS front end -> MINCO back end -> Polynome -> NMPC tracking at 100 Hz
-> ICR-EKF state estimation -> rate-limited noisy plant at 500 Hz, one
lane on `--device`.  The plant noise is drawn from a `torch.Generator`
seeded 1 (the JAX example's `jax.random` stream cannot be reproduced).

    python -m alore_legged_manipulator_tpu_torch.examples.planner_sim \
        [--start X Y YAW] [--goal X Y YAW] [--noise 0.01] [--plot PNG] \
        [--device cpu]

`--plot` draws through `utils/viz.py` and needs matplotlib.
"""
from __future__ import annotations

import argparse
import importlib.util
import time

import numpy as np
import torch

from ..core.dynamics import ICRParams
from ..mission.plan_manager import PlanManager, PlanManagerConfig
from ..runtime import LoopConfig, simulate_tracking
from ..utils.precision import resolve_device
from ..world.plant import PlantConfig


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--start", nargs=3, type=float, default=[1.0, 4.0, 0.0])
    ap.add_argument("--goal", nargs=3, type=float, default=[7.0, 4.5, 0.0])
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--plot", type=str, default=None,
                    help="save a tracking figure PNG to this path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.plot and importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("--plot needs matplotlib, which is not installed")

    # ground-truth world: an 8 x 8 m room with two obstacles
    occ = np.zeros((80, 80), bool)
    occ[30:44, 30:36] = True
    occ[50:56, 44:60] = True

    true_icr = ICRParams(yr=-0.3, yl=0.3, xv=0.2)  # planner_sim.launch:204
    pm = PlanManager(occ=occ, lower=(0.0, 0.0), res=0.1,
                     cfg=PlanManagerConfig(), device=device)
    pm.set_goal(tuple(args.goal))

    print("planning...")
    t0 = time.time()
    msg = pm.tick(0.0, tuple(args.start))
    assert msg is not None, f"planning failed: {pm.state}"
    dur = float(pm.tracked.duration[0])
    _sync(device)
    plan_wall = time.time() - t0
    pieces = msg.piece_times.shape[1]
    print(f"  planned {pieces} pieces, {dur:.2f} s "
          f"trajectory in {plan_wall:.1f}s wall")

    n_ticks = int(dur / 0.01) + 100
    loop_cfg = LoopConfig(plant=PlantConfig(noise_stddev=args.noise))
    print(f"tracking closed-loop for {n_ticks} ticks "
          f"(plant 500 Hz / NMPC 100 Hz / EKF in loop)...")
    t0 = time.time()
    with torch.no_grad():
        res = simulate_tracking(pm.tracked, true_icr, n_ticks, loop_cfg,
                                seed=1)
    _sync(device)
    track_wall = time.time() - t0
    perr = res.pos_err[0].cpu().numpy()
    print(f"  simulated in {track_wall:.1f}s wall")
    print(f"  tracking error: mean {perr.mean():.3f} m, "
          f"p95 {np.percentile(perr, 95):.3f} m, final {perr[-1]:.3f} m")
    final = res.xytheta[0, -1].cpu().numpy()
    goal = np.asarray(args.goal)
    goal_dist = float(np.linalg.norm(final[:2] - goal[:2]))
    print(f"  final pose ({final[0]:.2f}, {final[1]:.2f}, {final[2]:.2f}); "
          f"goal distance {goal_dist:.3f} m")
    icr_err = float(res.icr_err[0, -1])
    icr_err0 = float(np.linalg.norm(
        np.array(loop_cfg.icr_guess)
        - np.array([true_icr.yr, true_icr.yl, true_icr.xv])))
    print(f"  EKF ICR error: {icr_err:.3f} "
          f"(initial guess error {icr_err0:.3f})")

    if args.plot:
        from ..utils import viz

        one = type(res)(*(x[0] for x in res))
        fig = viz.tracking_figure(one, tt=pm.tracked._replace(
            seq=pm.tracked.seq[0]), occ=occ, lower=(0.0, 0.0), res=0.1)
        viz.save_figure(fig, args.plot)
        print(f"  figure saved to {args.plot}")

    return {"pieces": int(pieces), "duration_s": dur, "ticks": n_ticks,
            "plan_wall_s": plan_wall, "track_wall_s": track_wall,
            "err_mean": float(perr.mean()),
            "err_p95": float(np.percentile(perr, 95)),
            "err_final": float(perr[-1]), "final_pose": final.tolist(),
            "goal_dist": goal_dist, "icr_err": icr_err,
            "icr_err_initial": icr_err0}


if __name__ == "__main__":
    main()
