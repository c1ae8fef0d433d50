"""Print how the port and the JAX package differ on the `popup` golden.

    JAX_PLATFORMS=cpu python tests/popup_report.py [--whole]

Per replan attempt captured by tests/popup_capture.py (4.0-4.3 s): both
packages' accept/reject, anneal rounds, and the gaps between their plans
(inner points, piece times, `stage2_cost_breakdown` totals), as
tests/test_torch_popup_attempt.py holds them (about 1.5 min).  With
`--whole`: the whole 16 s golden through both packages' planner
simulations under each tracker, at float64 with the configurations of
tests/test_torch_planner_sim.py::run_both, and the port-vs-JAX truth-pose
deviation, mean and max (about 10 min a tracker, both run one after the
other).
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


class _Req:
    def __init__(self, i):
        self.param = i


def attempts():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import tests.test_torch_popup_attempt as T
    for i in range(T.N_ATTEMPTS):
        b = T.both.__wrapped__(_Req(i))
        rj, rt = b["rj"], b["rt"]
        tj = T._jax_terms(T._x_of(T.jb, jax.tree.map(jnp.asarray, rj), jnp),
                          b["fj"], b["jesdf"])
        tt = T._port_terms(T._x_of(T.tb, rt, torch), b["ft"], b["tesdf"])
        cj, ct = float(tj["total"]), float(tt["total"][0])
        print(f"t={float(b['a']['t']):.3f} s: JAX collision "
              f"{bool(rj.collision)}, port {bool(rt.collision[0])}; anneal "
              f"rounds {int(rj.replans)} / {int(rt.replans[0])}; inner "
              f"points {np.abs(rt.inner[0].numpy() - rj.inner).max():.4f} m"
              f", piece times {np.abs(rt.times[0].numpy() - rj.times).max():.4f}"
              f" s apart; cost {cj:.3f} / {ct:.3f} "
              f"({100 * abs(ct - cj) / abs(cj):.2f}%)", flush=True)


def whole():
    import numpy as np

    import tests.test_torch_planner_sim as P
    for golden, tracker in (("popup", "ltv"), ("nmpc_popup", "nmpc")):
        _, _, ref, got = P.run_both(golden, 16.0, tracker)
        n = min(len(ref.poses), len(got.poses))
        d = np.linalg.norm(ref.poses[:n, 1:3] - got.poses[:n, 1:3], axis=1)
        print(f"{golden} ({tracker}), port vs JAX truth pose over 16 s: "
              f"mean {d.mean():.3f} m, max {d.max():.3f} m at "
              f"{ref.poses[d.argmax(), 0]:.2f} s", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import conftest  # noqa: F401  (CPU, float64)
    attempts()
    if "--whole" in sys.argv[1:]:
        whole()
