"""Mission-level validation harness (twin of examples/mission_validation.py).

Random item/target missions over a walled world; visit orders from
greedy and branch-and-bound with JPS path costs (`native/jps.cpp`
through `planner/frontend.py::jps_search`), validity and cost reported.
The work is host work; `--device` only says where the port may run, and
the default (`cuda`) raises without a card.

    python -m alore_legged_manipulator_tpu_torch.examples.mission_validation \
        [--n-tasks 4] [--trials 5] [--seed 0] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..mission import (branch_and_bound_order, greedy_order,
                       pairwise_path_costs)
from ..planner.frontend import jps_search, world_to_grid
from ..utils.precision import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-tasks", type=int, default=4)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    occ = np.zeros((100, 100), bool)
    occ[30:70, 48:52] = True   # dividing wall with gaps
    occ[30:40, 48:52] = False
    occ[60:70, 48:52] = False

    def path_len(a, b):
        cells = jps_search(occ.astype(np.uint8),
                           world_to_grid(a[:2], (0, 0), 0.1),
                           world_to_grid(b[:2], (0, 0), 0.1))
        if cells is None:
            return np.inf
        d = np.diff(cells.astype(float), axis=0)
        return float((np.abs(d).max(1)
                      + (np.sqrt(2) - 1) * np.abs(d).min(1)).sum()) * 0.1

    n = args.n_tasks
    trials = []
    for trial in range(args.trials):
        pts = [np.array([2.0, 2.0, 0.0])]
        for _ in range(2 * n):
            while True:
                p = rng.uniform(0.5, 9.5, 2)
                if not occ[int(p[0] / 0.1), int(p[1] / 0.1)]:
                    break
            pts.append(np.array([p[0], p[1], 0.0]))

        t0 = time.time()
        D = pairwise_path_costs(pts, path_len)
        t_mat = time.time() - t0
        g_order, g_cost = greedy_order(D, n)
        t0 = time.time()
        b_order, b_cost = branch_and_bound_order(D, n)
        t_bnb = time.time() - t0

        # validity: every item precedes its (fixed-assignment) target
        ok = all(b_order[2 * k + 1] == b_order[2 * k] + n for k in range(n))
        print(f"trial {trial}: dists {t_mat * 1e3:.0f} ms | "
              f"greedy cost {g_cost:.2f} order {g_order} | "
              f"B&B cost {b_cost:.2f} ({t_bnb * 1e3:.1f} ms) "
              f"order {b_order} valid={ok}")
        assert ok
        trials.append({"greedy_order": [int(i) for i in g_order],
                       "greedy_cost": float(g_cost),
                       "bnb_order": [int(i) for i in b_order],
                       "bnb_cost": float(b_cost),
                       "valid": ok, "dists_ms": t_mat * 1e3,
                       "bnb_ms": t_bnb * 1e3})
    return {"trials": trials}


if __name__ == "__main__":
    main()
