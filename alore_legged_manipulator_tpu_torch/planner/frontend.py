"""Kinodynamic front end: JPS search -> pruning -> flat-state sampling
(port of planner/frontend.py).

  1. JPS over the safe-distance-thresholded grid (native C++,
     native/jps.cpp) with a start/goal-adaptive safe radius
     (jps_planner.cpp:39-44)
  2. zig-zag pruning by line-of-sight shortcutting (removeCornerPts
     :97-138)
  3. interleaved rotate-in-place / straight-drive sampling into 5-d states
     (x, y, theta, dtheta, ds) (getSampleTraj :217-257)
  4. weighted-arc-length time allocation with a trapezoidal velocity
     profile and uniform time resampling into (yaw, s, t) triples
     (getTrajsWithTime :258-372, evaluateDuration/Length :378-441),
     including trajectory truncation at trajCutLength

Host-side numpy, as in the JAX package: graph search is irregular,
millisecond-scale work.  Its output is a FlatTraj with a lane axis of 1
on the caller's device.  `jps_search` raises when the native library
cannot be built; `_astar_fallback` is the plain search the tests hold
its path costs against.
"""
from __future__ import annotations

import ctypes
import heapq
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.precision import resolve_device
from .flat_traj import FlatTraj


class FrontendConfig(NamedTuple):
    # jps3ms.yaml
    safe_dis: float = 0.3
    distance_weight: float = 1.4
    yaw_weight: float = 0.3
    traj_cut_length: float = 600.0
    # car3ms / global_planning3ms
    max_vel: float = 3.0
    max_acc: float = 2.0
    sample_time: float = 0.4        # timeResolution
    min_traj_num: int = 3           # mintrajNum
    # piece-count buckets: the piece count is rounded UP to one of these
    # so the jitted backend only ever compiles for a handful of static
    # shapes (a fresh XLA compile costs minutes; a replan budget is 50 ms)
    # -- () disables bucketing (the reference's exact ceil-with-rounding
    # count; used by the golden parity tests)
    piece_buckets: tuple = (3, 4, 6, 8, 12, 16, 24, 32)
    # replan stitch: False = the reference's EFFECTIVE behavior (its
    # raw_path_.insert is dead code, jps_planner.cpp:193-197); True =
    # the intended full-prefix stitch (follows the old trajectory over
    # the truncation window)
    stitch_full_path: bool = False


# ---------------------------------------------------------------------------
# grid search
# ---------------------------------------------------------------------------

def _astar_fallback(blocked, start, goal):
    """Pure-python 8-connected A* (same optimal cost as JPS)."""
    H, W = blocked.shape
    sx, sy = start
    gx, gy = goal
    if blocked[sx, sy] or blocked[gx, gy]:
        return None
    dirs = [(1, 0), (-1, 0), (0, 1), (0, -1),
            (1, 1), (1, -1), (-1, 1), (-1, -1)]
    SQ2 = 2 ** 0.5

    def h(x, y):
        dx, dy = abs(x - gx), abs(y - gy)
        return max(dx, dy) + (SQ2 - 1) * min(dx, dy)

    g = {start: 0.0}
    parent = {}
    pq = [(h(sx, sy), start)]
    seen = set()
    while pq:
        _, cur = heapq.heappop(pq)
        if cur in seen:
            continue
        seen.add(cur)
        if cur == (gx, gy):
            path = [cur]
            while cur in parent:
                cur = parent[cur]
                path.append(cur)
            return path[::-1]
        cx, cy = cur
        for dx, dy in dirs:
            nx, ny = cx + dx, cy + dy
            if nx < 0 or ny < 0 or nx >= H or ny >= W or blocked[nx, ny]:
                continue
            if dx and dy and (blocked[cx + dx, cy] and blocked[cx, cy + dy]):
                continue
            ng = g[cur] + (SQ2 if dx and dy else 1.0)
            if ng < g.get((nx, ny), 1e30):
                g[(nx, ny)] = ng
                parent[(nx, ny)] = cur
                heapq.heappush(pq, (ng + h(nx, ny), (nx, ny)))
    return None


def jps_search(blocked: np.ndarray, start, goal):
    """Grid path (int32 cells, jump points only) from start to goal cell,
    or None.  Raises RuntimeError when the native library cannot be
    built: A* returns another path of the same cost, so a silent switch
    would change plans."""
    from ..native import load_jps
    blocked = np.ascontiguousarray(blocked, np.uint8)
    lib = load_jps()
    H, W = blocked.shape
    max_pts = H * W
    out = np.empty((max_pts, 2), np.int32)
    n = lib.jps_plan(
        blocked.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
        int(start[0]), int(start[1]), int(goal[0]), int(goal[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_pts)
    if n <= 0:
        return None
    return out[:n].copy()


# ---------------------------------------------------------------------------
# coordinates (SDFmap conventions)
# ---------------------------------------------------------------------------

def world_to_grid(pos, lower, res):
    return np.clip(((np.asarray(pos) - np.asarray(lower)) / res).astype(int),
                   0, None)


def grid_to_world(idx, lower, res):
    return np.asarray(lower) + (np.asarray(idx, float) + 0.5) * res


# ---------------------------------------------------------------------------
# pruning (removeCornerPts, jps_planner.cpp:97-148)
# ---------------------------------------------------------------------------

def _bresenham(a, b):
    x0, y0 = int(a[0]), int(a[1])
    x1, y1 = int(b[0]), int(b[1])
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    pts = []
    while True:
        pts.append((x0, y0))
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy
    return pts


def _line_collides(blocked, lower, res, p, q):
    # coord2gridIndex semantics: (p - lower) * (1/res), truncate, clamp
    # both sides (the reference precomputes inv_grid_interval_; using
    # /res instead differs by 1 ulp at cell boundaries)
    H, W = blocked.shape
    inv = 1.0 / float(res)

    def to_cell(v):
        return (min(max(int((float(v[0]) - float(lower[0])) * inv), 0),
                    H - 1),
                min(max(int((float(v[1]) - float(lower[1])) * inv), 0),
                    W - 1))

    for c in _bresenham(to_cell(p), to_cell(q)):
        if blocked[c[0], c[1]]:
            return True
    return False


def _seg_norm(a, b):
    """Eigen-style norm: sqrt of the plain sum of squares.  NOT
    np.linalg.norm (BLAS nrm2 scales by the max component and rounds
    differently by 1 ulp -- enough to flip the pruner's collinear
    tie-breaks vs the reference)."""
    import math
    dx = float(a[0]) - float(b[0])
    dy = float(a[1]) - float(b[1])
    return math.sqrt(dx * dx + dy * dy)


def remove_corner_pts(path_xy, blocked, lower, res):
    """Shortcut zig-zags whenever the direct segment is collision-free."""
    if len(path_xy) < 2:
        return list(path_xy)
    out = [path_xy[0]]
    prev = path_xy[0]
    cost1 = (np.inf if _line_collides(blocked, lower, res, path_xy[0],
                                      path_xy[1])
             else _seg_norm(path_xy[0], path_xy[1]))
    for i in range(1, len(path_xy) - 1):
        p1, p2 = path_xy[i], path_xy[i + 1]
        cost2 = (np.inf if _line_collides(blocked, lower, res, p1, p2)
                 else _seg_norm(p1, p2))
        cost3 = (np.inf if _line_collides(blocked, lower, res, prev, p2)
                 else _seg_norm(prev, p2))
        if cost3 < cost1 + cost2:
            cost1 = cost3
        else:
            out.append(p1)
            # the reference resets cost1 to the PLAIN norm here, without
            # the collision check (jps_planner.cpp:131) -- a colliding
            # kept segment re-enters the comparison with finite cost
            cost1 = _seg_norm(p1, p2)
            prev = p1
    out.append(path_xy[-1])
    return out


# ---------------------------------------------------------------------------
# trapezoidal velocity profile (jps_planner.cpp:378-441)
# ---------------------------------------------------------------------------

def evaluate_duration(length, start_v, end_v, max_v, max_a):
    sv2 = min(start_v, max_v) ** 2
    ev2 = min(end_v, max_v) ** 2
    mv2 = max_v ** 2
    critical = (mv2 - sv2) / (2 * max_a) + (mv2 - ev2) / (2 * max_a)
    if length >= critical:
        return ((max_v - start_v) / max_a + (max_v - end_v) / max_a
                + (length - critical) / max_v)
    tmpv = np.sqrt(0.5 * (sv2 + ev2 + 2 * max_a * length))
    return (tmpv - start_v) / max_a + (tmpv - end_v) / max_a


def evaluate_length(curt, locallength, start_v, end_v, max_v, max_a):
    sv2 = min(start_v, max_v) ** 2
    ev2 = min(end_v, max_v) ** 2
    mv2 = max_v ** 2
    critical = (mv2 - sv2) / (2 * max_a) + (mv2 - ev2) / (2 * max_a)
    if locallength >= critical:
        t1 = (max_v - start_v) / max_a
        t2 = t1 + (locallength - critical) / max_v
        if curt <= t1:
            return start_v * curt + 0.5 * max_a * curt ** 2
        if curt <= t2:
            return start_v * t1 + 0.5 * max_a * t1 ** 2 + (curt - t1) * max_v
        return (start_v * t1 + 0.5 * max_a * t1 ** 2 + (t2 - t1) * max_v
                + max_v * (curt - t2) - 0.5 * max_a * (curt - t2) ** 2)
    tmpv = np.sqrt(0.5 * (sv2 + ev2 + 2 * max_a * locallength))
    tmpt = (tmpv - start_v) / max_a
    if curt <= tmpt:
        return start_v * curt + 0.5 * max_a * curt ** 2
    return (start_v * tmpt + 0.5 * max_a * tmpt ** 2
            + tmpv * (curt - tmpt) - 0.5 * max_a * (curt - tmpt) ** 2)


# ---------------------------------------------------------------------------
# sampling (getSampleTraj + getTrajsWithTime)
# ---------------------------------------------------------------------------

def _unwrap_to(ref, ang):
    while ref - ang > np.pi:
        ang += 2 * np.pi
    while ref - ang < -np.pi:
        ang -= 2 * np.pi
    return ang


def sample_states(path_xy, start_xyt, end_yaw):
    """Interleave rotate-in-place and straight segments into 5-d states
    (x, y, theta, dtheta, ds); getSampleTraj (jps_planner.cpp:217-257)."""
    states = []
    sx, sy, syaw = start_xyt
    states.append([sx, sy, syaw, 0.0, 0.0])
    cur = _unwrap_to(syaw, float(np.arctan2(path_xy[1][1] - path_xy[0][1],
                                            path_xy[1][0] - path_xy[0][0])))
    states.append([sx, sy, cur, cur - syaw, 0.0])
    # the reference pushes the initial heading a SECOND time, recomputed
    # as atan2(p0-p1)+pi and re-normalized to the START yaw, dtheta again
    # relative to the start yaw (jps_planner.cpp:231-233) -- the
    # duplicate state double-counts the first rotation in the weighted
    # arc-length budget, stretching the time allocation accordingly
    cur2 = _unwrap_to(syaw, float(np.arctan2(path_xy[0][1] - path_xy[1][1],
                                             path_xy[0][0] - path_xy[1][0])
                                  + np.pi))
    states.append([sx, sy, cur2, cur2 - syaw, 0.0])

    for i in range(1, len(path_xy) - 1):
        p = path_xy[i]
        last = states[-1]
        ds = float(np.hypot(p[0] - last[0], p[1] - last[1]))
        states.append([p[0], p[1], last[2], 0.0, ds])
        nxt = _unwrap_to(states[-1][2],
                         float(np.arctan2(path_xy[i + 1][1] - p[1],
                                          path_xy[i + 1][0] - p[0])))
        states.append([p[0], p[1], nxt, nxt - states[-1][2], 0.0])

    p = path_xy[-1]
    last = states[-1]
    ds = float(np.hypot(p[0] - last[0], p[1] - last[1]))
    states.append([p[0], p[1], last[2], 0.0, ds])
    fyaw = _unwrap_to(states[-1][2], float(end_yaw))
    states.append([p[0], p[1], fyaw, fyaw - states[-1][2], 0.0])
    return np.asarray(states)


def build_flat_traj(states, start_xyt, start_vaj, start_oaj,
                    cfg: FrontendConfig, dtype=torch.float32,
                    device=None) -> FlatTraj:
    """Time-allocate + uniformly resample into a FlatTraj with a lane axis
    of 1 (getTrajsWithTime, jps_planner.cpp:258-366).  device=None means
    the card."""
    dev = resolve_device(device)
    # cumulative (weighted) path lengths, with optional truncation
    pathlen = [0.0]
    wlen = [0.0]
    kept = [states[0]]
    total_len = 0.0
    if_cut = False
    cut_state = states[-1][:3]
    for node in states[1:]:
        ds = abs(node[4])
        if total_len + ds >= cfg.traj_cut_length and node[4] != 0.0:
            frac = (cfg.traj_cut_length - total_len) / ds
            prev = kept[-1]
            cut = prev[:3] + (node[:3] - prev[:3]) * frac
            node = np.array([cut[0], cut[1], cut[2], frac * node[3],
                             cfg.traj_cut_length - total_len])
            if_cut = True
        total_len += abs(node[4])
        kept.append(node)
        pathlen.append(total_len)
        wlen.append(wlen[-1] + cfg.yaw_weight * abs(node[3])
                    + cfg.distance_weight * abs(node[4]))
        if if_cut:
            cut_state = node[:3]
            break
    kept = np.asarray(kept)
    wtotal = wlen[-1]

    total_t = evaluate_duration(wtotal, float(start_vaj[0]), 0.0,
                                cfg.max_vel, cfg.max_acc)
    n_pieces = max(int(total_t / cfg.sample_time + 0.5), cfg.min_traj_num)
    if cfg.piece_buckets:
        for b in sorted(cfg.piece_buckets):
            if b >= n_pieces:
                n_pieces = b
                break
        else:
            n_pieces = max(cfg.piece_buckets)
    st = total_t / n_pieces

    traj_pts = []      # (yaw, s, t)
    positions = []     # (x, y, yaw)
    k_idx = 1
    samplet = st
    while samplet < total_t - 1e-3:
        arc = evaluate_length(samplet, wtotal, float(start_vaj[0]), 0.0,
                              cfg.max_vel, cfg.max_acc)
        for k in range(k_idx, len(kept)):
            if wlen[k] >= arc:
                k_idx = k
                l1 = wlen[k] - arc
                l = wlen[k] - wlen[k - 1]
                frac = (l - l1) / l if l > 0 else 0.0
                interp_s = pathlen[k - 1] + frac * kept[k][4]
                interp_yaw = kept[k - 1][2] + frac * kept[k][3]
                traj_pts.append([interp_yaw, interp_s, samplet])
                ix = (l1 / l) * kept[k - 1][0] + frac * kept[k][0] \
                    if l > 0 else kept[k][0]
                iy = (l1 / l) * kept[k - 1][1] + frac * kept[k][1] \
                    if l > 0 else kept[k][1]
                positions.append([ix, iy, interp_yaw])
                break
        samplet += st

    n_inner = len(traj_pts)
    inner = (np.asarray(traj_pts)[:, :2].T if n_inner
             else np.zeros((2, 0)))
    positions = np.asarray(positions) if n_inner else np.zeros((0, 3))
    positions = np.concatenate(
        [positions, np.array([[cut_state[0], cut_state[1], cut_state[2]]])],
        axis=0)

    start_state = np.array([
        [kept[0][2], start_oaj[0], start_oaj[1]],
        [0.0, start_vaj[0], start_vaj[1]]])
    final_state = np.array([
        [kept[-1][2], 0.0, 0.0],
        [pathlen[len(kept) - 1], 0.0, 0.0]])

    def lane(a, dt=dtype):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=dev, dtype=dt)[None]

    return FlatTraj(
        inner_yaw_s=lane(inner),
        init_piece_time=lane(st),
        inner_positions=lane(positions),
        start_state=lane(start_state),
        final_state=lane(final_state),
        start_xytheta=lane(start_xyt),
        final_xytheta=lane(cut_state),
        if_cut=torch.tensor([bool(if_cut)], device=dev))


def plan_frontend(esdf_dist: np.ndarray, lower, res, start_xyt, goal_xyt,
                  cfg: FrontendConfig = FrontendConfig(),
                  start_vaj=(0.0, 0.0, 0.0), start_oaj=(0.0, 0.0, 0.0),
                  dtype=torch.float32,
                  start_path=None, device=None) -> Optional[FlatTraj]:
    """Full front end: threshold ESDF -> JPS -> prune -> FlatTraj (a lane
    axis of 1, on `device`; None means the card).

    esdf_dist: (H, W) signed distances (host numpy).  Returns None when no
    path exists.  Safe radius shrinks near tight starts/goals
    (jps_planner.cpp:39-44).

    start_path: optional (x, y[, theta]) world points -- the replan
    continuity stitch of getKinoNodeWithStartPath (jps_planner.cpp:
    189-215): the search starts from the LAST stitched point while the
    sampled trajectory begins at start_xyt (= the path's first point).
    By default this reproduces the reference's EFFECTIVE behavior --
    its raw_path_.insert is dead code (each pushed point is popped
    immediately, :193-197) so intermediate points are dropped;
    cfg.stitch_full_path=True enables the intended full-prefix stitch.
    """
    start_xyt = np.asarray(start_xyt, float)
    goal_xyt = np.asarray(goal_xyt, float)
    if start_path is not None and len(start_path) == 0:
        start_path = None
    if start_path is not None:
        search_start = np.asarray(start_path[-1], float)[:2]
    else:
        search_start = start_xyt[:2]
    s_idx = world_to_grid(search_start, lower, res)
    g_idx = world_to_grid(goal_xyt[:2], lower, res)
    H, W = esdf_dist.shape
    s_idx = np.minimum(s_idx, [H - 1, W - 1])
    g_idx = np.minimum(g_idx, [H - 1, W - 1])

    start_d = esdf_dist[s_idx[0], s_idx[1]] * 0.8
    goal_d = esdf_dist[g_idx[0], g_idx[1]] * 0.8
    safe = max(min(cfg.safe_dis, start_d, goal_d), 0.0)

    blocked = esdf_dist < safe
    cells = jps_search(blocked, s_idx, g_idx)
    if cells is None:
        return None

    path_xy = [grid_to_world(c, lower, res) for c in cells]
    path_xy[0] = search_start.copy()
    path_xy[-1] = goal_xyt[:2].copy()
    if start_path is not None and cfg.stitch_full_path:
        # prepend the stitched prefix as getKinoNodeWithStartPath's
        # raw_path_.insert INTENDS to (jps_planner.cpp:193-201) -- in
        # the reference that insert is dead code (each pushed point is
        # immediately popped, so the inserted range is empty) and only
        # the sampling start state moves to start_path.front(); the
        # reference-effective behavior (default, stitch_full_path=False)
        # samples a straight leg from the predicted state to the
        # truncated point instead of following the old trajectory
        prefix = [np.asarray(p, float)[:2] for p in start_path[:-1]]
        path_xy = prefix + path_xy
        path_xy[0] = start_xyt[:2].copy()
    path_xy = remove_corner_pts(np.asarray(path_xy), blocked, lower, res)
    if len(path_xy) < 2:
        path_xy = [start_xyt[:2], goal_xyt[:2]]

    states = sample_states(path_xy, start_xyt, goal_xyt[2])
    return build_flat_traj(states, start_xyt, start_vaj, start_oaj, cfg,
                           dtype, device)
