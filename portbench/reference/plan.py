"""Plain re-derivation of a back-end plan's answer, in any dtype.

A plan names its decision variables (inner waypoints, piece times, the
tail's arc length) and states what follows from them: the spline's
coefficients, the final XY error of its flow against the goal, and
whether it stays clear of the map.  The reference works each of these
out again from the decision variables and the request alone (start
state, goal, occupancy map), with its own spline, flow and distance
field (`spline.py`), so that a plan is judged by what it says.
"""
from __future__ import annotations

import torch

from . import spline


def derive(req, dec, dist, cfg):
    """What the decision variables imply.

    req: the request, dict of head (B, 2, 3), final_state (B, 2, 3),
    start_xy (B, 2), goal_xy (B, 2); dec: dict of inner (B, 2, N-1),
    times (B, N), tail_s (B,); dist: the map's distance field (H, W).
    Returns dict of coeffs (B, N, 6, 2), final_xy_err (B, 2), clearance
    (B,): the least distance of the flow sampled at the final check's
    resolution."""
    tail = req["final_state"].clone()
    tail[:, 1, 0] = dec["tail_s"]
    coeffs = spline.minco_coeffs(req["head"], tail, dec["inner"],
                                 dec["times"])
    xv = 0.0 if cfg["standard_diff"] else cfg["icr_xv"]
    _, end_xy = spline.simpson_nodes(coeffs, dec["times"], req["start_xy"],
                                     xv, cfg["sparse_resolution"])
    nodes, _ = spline.simpson_nodes(coeffs, dec["times"], req["start_xy"],
                                    xv, cfg["final_check_resolution"])
    d = spline.bilinear(dist, cfg["map_lower"], cfg["map_res"],
                        nodes.reshape(nodes.shape[0], -1, 2))
    return {"coeffs": coeffs, "final_xy_err": end_xy - req["goal_xy"],
            "clearance": torch.amin(d, -1)}


def flat_samples(coeffs, times, n=16):
    """(yaw, s) and their first two derivatives at n+1 points a piece,
    (B, N, n+1, 3, 2): what a controller reads off the coefficients."""
    frac = torch.arange(n + 1, dtype=times.dtype, device=times.device) / n
    tau = times[..., None] * frac
    c = coeffs[:, :, None].expand(*tau.shape, 6, 2)
    return torch.stack([spline.eval_local(c, tau, k) for k in range(3)], -2)
