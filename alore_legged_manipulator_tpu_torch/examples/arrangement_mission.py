"""Headline demo: multi-object rearrangement mission, full stack (twin of
examples/arrangement_mission.py).

The mission layer orders the tasks, the FSM sequences approach / grasp /
push / release, and each push runs the planning and control stack (JPS
-> MINCO + ALM -> Polynome -> NMPC RTI closed loop with the ICR-EKF
estimating pose and ICR online against a noisy plant), on `--device`.

    python -m alore_legged_manipulator_tpu_torch.examples.arrangement_mission \
        [--objects 3] [--physics] [--plot PNG] [--device cpu]

`--plot` draws through `utils/viz.py` and needs matplotlib.
"""
from __future__ import annotations

import argparse
import importlib.util
import time

import numpy as np

from ..runtime.arrangement import ArrangementMission
from ..utils.precision import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--objects", type=int, default=3)
    ap.add_argument("--plot", type=str, default=None,
                    help="save a mission-overview figure PNG to this path")
    ap.add_argument("--physics", action="store_true",
                    help="run the push phase on the rigid-body contact "
                         "plant (grasp weld + contact, EKF identifying "
                         "the effective ICR online) instead of the "
                         "kinematic ICR simulator twin")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.plot and importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("--plot needs matplotlib, which is not installed")

    occ = np.zeros((100, 100), bool)
    occ[48:52, 20:45] = True       # interior wall
    items = [(2.5, 2.5, 0.0), (2.5, 7.5, 0.0), (7.5, 2.0, 0.0)][:args.objects]
    targets = [(8.0, 7.5, 0.0), (8.0, 6.0, 0.0), (6.5, 8.0, 0.0)][:args.objects]

    mission = ArrangementMission(occ=occ, lower=(0.0, 0.0), res=0.1,
                                 items=items, targets=targets,
                                 use_physics_plant=args.physics,
                                 device=device)
    plant = "contact-physics" if args.physics else "kinematic ICR"
    print(f"mission: {len(items)} objects; running full stack "
          f"({plant} plant)...")
    t0 = time.time()
    rep = mission.run(robot_start=(5.0, 1.0, 1.57), verbose=True,
                      record_tracks=bool(args.plot))
    wall = time.time() - t0

    print(f"\norder: {rep.order}")
    print(f"delivered: {rep.delivered}")
    print(f"final object-to-target errors: "
          f"{[f'{e:.3f}' for e in rep.final_object_err]} m")
    print(f"push tracking err p95 (worst task): "
          f"{rep.push_tracking_err_p95:.3f} m")
    print(f"simulated {rep.sim_time_s:.1f} s of mission in {wall:.1f} s wall")
    if args.plot:
        from ..utils import viz

        fig = viz.mission_figure(
            occ, (0.0, 0.0), 0.1,
            items=np.asarray(items)[:, :2], targets=np.asarray(targets)[:, :2],
            object_tracks=rep.object_tracks, robot_track=rep.robot_track)
        viz.save_figure(fig, args.plot)
        print(f"figure saved to {args.plot}")

    assert all(rep.delivered), "mission incomplete!"
    print("MISSION COMPLETE")
    return {"order": list(rep.order), "delivered": list(rep.delivered),
            "final_object_err": list(rep.final_object_err),
            "push_tracking_err_p95": rep.push_tracking_err_p95,
            "sim_time_s": rep.sim_time_s, "wall_s": wall}


if __name__ == "__main__":
    main()
