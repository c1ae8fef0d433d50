"""Record the JAX package's two-object arrangement mission, as
`examples/arrangement_mission.py --objects 2` runs it (kinematic plant,
float32, plant noise on), for tests/test_torch_example_arrangement.py.

Runs the JAX example's `main()` on the CPU and records its report
(order, delivered flags, final object errors, worst push p95, simulated
time), the task FSM's edge sequence and what each push's front end
handed the back end (`plan_frontend`'s FlatTraj).  With `--start-shift
D` the robot starts D metres further along x, for the JAX-vs-JAX gap
the test's bands are stated from; that run is printed, not saved.
Writes `alore_legged_manipulator_tpu_torch/data/arrangement_two_objects.npz`:

    JAX_PLATFORMS=cpu python tests/arrangement_capture.py [--start-shift D]

takes about 2 min on one CPU.
"""
import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "alore_legged_manipulator_tpu_torch" / "data" / \
    "arrangement_two_objects.npz"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--start-shift", type=float, default=0.0)
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from alore_legged_manipulator_tpu.mission import plan_manager as jpm
    from alore_legged_manipulator_tpu.runtime import arrangement as jarr

    flats, edges, reports = [], [], []
    orig_fe, orig_run = jpm.plan_frontend, jarr.ArrangementMission.run

    def frontend(*args, **kw):
        res = orig_fe(*args, **kw)
        flats.append(res)
        return res

    class Fsm(jarr.ObjectFsm):
        def __setattr__(self, key, value):
            if key == "state" and (not edges or edges[-1] != value.name):
                edges.append(value.name)
            super().__setattr__(key, value)

    def run(self, robot_start, *args, **kw):
        start = (robot_start[0] + a.start_shift,) + tuple(robot_start[1:])
        rep = orig_run(self, start, *args, **kw)
        reports.append(rep)
        return rep

    jpm.plan_frontend = frontend
    jarr.ObjectFsm = Fsm
    jarr.ArrangementMission.run = run
    spec = importlib.util.spec_from_file_location(
        "jax_arrangement_mission", ROOT / "examples" / "arrangement_mission.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    sys.argv = ["arrangement_mission.py", "--objects", "2"]
    example.main()

    (rep,) = reports
    summary = {"order": [int(i) for i in rep.order],
               "delivered": [bool(d) for d in rep.delivered],
               "final_object_err": [float(e) for e in rep.final_object_err],
               "push_tracking_err_p95": float(rep.push_tracking_err_p95),
               "sim_time_s": float(rep.sim_time_s), "edges": edges,
               "start_shift": a.start_shift}
    print("recorded: " + json.dumps(summary))
    if a.start_shift:
        return
    out = {"summary": np.asarray(json.dumps(summary))}
    for i, flat in enumerate(flats):
        for name in flat._fields:
            out[f"flat{i}/{name}"] = np.asarray(getattr(flat, name))
    np.savez_compressed(OUT, **out)
    print("->", OUT, OUT.stat().st_size, "bytes")


if __name__ == "__main__":
    main()
