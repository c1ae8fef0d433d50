"""2-D lidar simulation and log-odds occupancy mapping (port of
world/lidar.py).

Rebuilds two reference components:

  * laser simulator (utils/laser_simulator/src/laser_sim_node.cpp
    renderSensedPoints :423+): occlusion-aware scan of the ground-truth
    map around the robot, FOV-limited, fixed angular resolution.
  * SDFmap's probabilistic occupancy pipeline (utils/plan_env/src/
    sdf_map.cpp raycastProcess :239+, updateOccupancyMap): log-odds
    hit/miss updates along each beam, clamped, thresholded into
    {unknown, free, occupied}.

A scan is a dense (n_beams, n_steps) sample lattice: one gather against
the ground-truth grid finds the first hit per beam.  The fusion traces
every beam at once with a Python loop over the static trace length (the
JAX package's `lax.scan`) on (beams,) tensors, and counts hits and
observations with integer scatter-adds, which are deterministic.  Where
the JAX package takes a scatter-max of one constant, the port writes
that constant where the mask holds, through a flat index that sends
masked-off entries to a spare cell.  One map per call (the planner
simulation and the mapped planner each hold one); `lower`, `res` and the
pose keep the caller's types, as the JAX package's weak typing does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.precision import resolve_device


class LidarConfig(NamedTuple):
    n_beams: int = 360
    fov_rad: float = 2.0 * 3.14159265      # hrz_limited off by default
    max_range: float = 10.0                # detection_range / sensing_horizon
    n_steps: int = 256                     # samples along each ray


class OccupancyConfig(NamedTuple):
    """Log-odds parameters (sdf_map.h:167-184, mapsim.yaml values)."""

    p_hit: float = 0.99
    p_miss: float = 0.35
    p_min: float = 0.12
    p_max: float = 0.90
    p_occ: float = 0.80
    # "unknown flag": occupancy_map_ initializes to clamp_min - this, so
    # a never-touched cell sits BELOW the clamp floor until first update
    # (sdf_map.h:179-180)
    unknown_flag: float = 0.01
    # static bound on Bresenham trace length in cells (>= the longest
    # beam: max_range/res per axis; both axes can step per iteration so
    # max(dx, dy) iterations suffice)
    max_trace_cells: int = 160
    # static bound on circular-support perimeter points per square edge
    # (>= 2*detection_range/res + 1; sdf_map.cpp:184-193)
    cir_sup_max_edge_points: int = 128


def _logit(p):
    return math.log(p / (1.0 - p))


# gridmap_ states (sdf_map.h:98)
UNKNOWN, UNOCCUPIED, OCCUPIED = 0, 1, 2


class OccupancyState(NamedTuple):
    log_odds: torch.Tensor   # (H, W) -- occupancy_map_
    known: torch.Tensor      # (H, W) bool -- grid != Unknown (convenience)
    grid: torch.Tensor       # (H, W) uint8 -- gridmap_ {0 unk, 1 free, 2 occ}


def occupancy_init(shape, cfg: OccupancyConfig = OccupancyConfig(),
                   dtype=torch.float32, device=None) -> OccupancyState:
    """An all-unknown map on `device` (None means the card)."""
    dev = resolve_device(device)
    return OccupancyState(
        log_odds=torch.full(tuple(shape), _logit(cfg.p_min) - cfg.unknown_flag,
                            dtype=dtype, device=dev),
        known=torch.zeros(tuple(shape), dtype=torch.bool, device=dev),
        grid=torch.zeros(tuple(shape), dtype=torch.uint8, device=dev))


def _const(value, like):
    """`value` as a 0-d tensor of `like`'s dtype and device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _stamp(shape, rows, cols, mask, device):
    """(H, W) bool, True at every (rows, cols) where mask holds: the
    scatter-max of True, with masked-off entries sent to a spare cell."""
    H, W = shape
    flat = torch.where(mask, rows.to(torch.int64) * W + cols,
                       torch.full_like(rows, H * W, dtype=torch.int64))
    out = torch.zeros(H * W + 1, dtype=torch.bool, device=device)
    out[flat.reshape(-1)] = True
    return out[:H * W].reshape(H, W)


def lidar_scan(true_occ, lower, res, pose, cfg: LidarConfig = LidarConfig()):
    """Simulate one scan against the ground-truth occupancy grid (H, W).

    Returns (ranges (n_beams,), hit_mask (n_beams,)) where hit_mask is
    False for max-range (no obstacle) beams.
    """
    H, W = true_occ.shape
    dtype, dev = pose.dtype, pose.device
    angles = pose[2] + (torch.arange(cfg.n_beams, dtype=dtype, device=dev)
                        / cfg.n_beams - 0.5) * cfg.fov_rad
    ts = (torch.arange(1, cfg.n_steps + 1, dtype=dtype, device=dev)
          / cfg.n_steps) * cfg.max_range
    px = pose[0] + torch.cos(angles)[:, None] * ts[None, :]
    py = pose[1] + torch.sin(angles)[:, None] * ts[None, :]
    ix = torch.clamp(((px - lower[0]) / res).to(torch.int32), 0, H - 1)
    iy = torch.clamp(((py - lower[1]) / res).to(torch.int32), 0, W - 1)
    inside = ((px >= lower[0]) & (px < lower[0] + H * res)
              & (py >= lower[1]) & (py < lower[1] + W * res))
    occ = inside & true_occ[ix.long(), iy.long()]
    any_hit = torch.any(occ, dim=1)
    first = torch.argmax(occ.to(torch.uint8), dim=1)     # first True per beam
    ranges = torch.where(any_hit, ts[first], _const(cfg.max_range, ts))
    return ranges, any_hit


def _bresenham_trace(start_cell, end_cells, max_steps):
    """Vectorized reference-exact Bresenham (sdf_map.cpp:387-415).

    start_cell (2,) int32; end_cells (B, 2) int32.
    Returns (cells (B, max_steps, 2), on_line (B, max_steps) bool) where
    on_line marks emitted line cells EXCLUDING the endpoint cell -- the
    reference's miss loop runs over `line[0..size-2]`
    (sdf_map.cpp:166-170).  Both axes may step in one iteration, exactly
    as the while-loop does, so max(|dx|, |dy|) iterations reach the end.
    """
    ex, ey = end_cells[:, 0], end_cells[:, 1]
    dx = torch.abs(ex - start_cell[0])
    dy = torch.abs(ey - start_cell[1])
    one = torch.ones_like(ex)
    sx = torch.where(start_cell[0] < ex, one, -one)
    sy = torch.where(start_cell[1] < ey, one, -one)
    zero = torch.zeros_like(ex)
    x = start_cell[0].expand_as(ex).clone()
    y = start_cell[1].expand_as(ey).clone()
    err = dx - dy
    done = torch.zeros_like(ex, dtype=torch.bool)
    xs, ys, valid = [], [], []
    for _ in range(max_steps):
        at_end = (x == ex) & (y == ey)
        xs.append(x)
        ys.append(y)
        valid.append(~done & ~at_end)
        e2 = 2 * err
        stepx = e2 > -dy
        stepy = e2 < dx
        nerr = err - torch.where(stepx, dy, zero) + torch.where(stepy, dx,
                                                                zero)
        done = done | at_end
        x = torch.where(done, x, x + torch.where(stepx, sx, zero))
        y = torch.where(done, y, y + torch.where(stepy, sy, zero))
        err = torch.where(done, err, nerr)
    cells = torch.stack([torch.stack(xs, 1), torch.stack(ys, 1)], dim=-1)
    return cells, torch.stack(valid, 1)


def _intbound(s, ds):
    """Smallest positive t with s + t*ds integer (raycast.cpp:39-48).

    `ds` is the reference's INTEGER cell-count difference, not the
    geometric direction -- the quirk is part of the traversal spec.
    """
    s2 = torch.where(ds < 0, -s, s)
    frac = torch.remainder(s2, 1.0)
    return torch.where(ds == 0, _const(math.inf, s),
                       (1.0 - frac) / torch.abs(ds).to(s.dtype))


def _t_for(diff, lo, up, p):
    """Ray parameter of the first map-boundary crossing along one axis
    (closetPointInMap, sdf_map.cpp:595-614)."""
    big = _const(1e6, diff)
    nz = torch.abs(diff) > 0
    t1 = torch.where(nz, (up - p) / diff, big)
    t2 = torch.where(nz, (lo - p) / diff, big)
    t1 = torch.where(t1 > 0, t1, big)
    t2 = torch.where(t2 > 0, t2, big)
    return torch.minimum(t1, t2)


def _cir_sup_raise(grid, log_odds, lower, res, pose, detection_range,
                   cfg: OccupancyConfig, fov_rad=None):
    """cirSupRaycastProcess (sdf_map.cpp:178-280), reference-exact.

    Casts a ray from every grid-interval-spaced point on the perimeter
    of the detection SQUARE toward the robot using the Amanatides-Woo
    DDA (raycast.cpp RayCaster, world/res lattice, z pinned).  A ray any
    of whose traversed cells -- or their four FLAT-INDEX neighbours
    (+-1, +-GLY with the reference's one-sided guards) -- is Occupied is
    discarded whole.  Surviving rays emit their traversed cells except
    the endpoint-adjacent one (`line[0..size-2]`) as zero-log-odds
    updates: the inline fusion loop forces `log_odds_update = 0.0`
    (sdf_map.cpp:258), so the ONLY effect is lifting below-clamp-floor
    (never-touched) cells up to exactly clamp_min, which the gridmap
    state machine then classifies Unoccupied.  Out-of-map perimeter
    points are pulled in by closetPointInMap and everything is clipped
    to the detection range; the FOV gate is the reference's
    angle-within-fov/2.2 test on the UNCLAMPED point.
    """
    H, W = grid.shape
    dtype, dev = log_odds.dtype, log_odds.device
    R = detection_range
    ox, oy = pose[0], pose[1]

    # perimeter lattice: x = ox +- R with y stepping res, then y = oy
    # +- R with x stepping (loop bound `< .. + 1e-10` inclusive)
    K = cfg.cir_sup_max_edge_points
    k = torch.arange(K, dtype=dtype, device=dev)
    off = k * res
    # the reference's `y < oy+R + 1e-10` loop bound under DOUBLE
    # accumulation includes the far corner when 2R/res is integral
    # (error ~4e-15); the f32 lattice error (~6e-8) would exclude it,
    # so count points from the ratio with an f32-sized slack instead
    n_pts = (torch.floor(2.0 * R / res + 1e-4) if torch.is_tensor(res)
             else math.floor(2.0 * R / res + 1e-4))
    kvalid = k < n_pts + 0.5
    ones = torch.ones(K, dtype=dtype, device=dev)
    pts = torch.cat([
        torch.stack([ones * (ox - R), oy - R + off], -1),
        torch.stack([ones * (ox + R), oy - R + off], -1),
        torch.stack([ox - R + off, ones * (oy - R)], -1),
        torch.stack([ox - R + off, ones * (oy + R)], -1),
    ])                                                   # (4K, 2)
    valid = kvalid.repeat(4)

    if fov_rad is not None:
        ang = torch.atan2(pts[:, 1] - oy, pts[:, 0] - ox) - pose[2]
        ang = torch.remainder(ang + math.pi, 2.0 * math.pi) - math.pi
        valid = valid & (ang >= -fov_rad / 2.2) & (ang <= fov_rad / 2.2)

    # closetPointInMap for strictly-out-of-map points (sdf_map.cpp:
    # 591-614), then the range clip -- both about the robot position
    upper = (lower[0] + H * res, lower[1] + W * res)
    px, py = pts[:, 0], pts[:, 1]
    in_map = ((px > lower[0]) & (px < upper[0])
              & (py > lower[1]) & (py < upper[1]))
    diffx, diffy = px - ox, py - oy
    t_bound = torch.minimum(_t_for(diffx, lower[0], upper[0], ox),
                            _t_for(diffy, lower[1], upper[1], oy)) - 1e-3
    px = torch.where(in_map, px, ox + t_bound * diffx)
    py = torch.where(in_map, py, oy + t_bound * diffy)
    length = torch.sqrt((px - ox) ** 2 + (py - oy) ** 2)
    scale = torch.where(length > R, R / torch.clamp(length, min=1e-12),
                        _const(1.0, length))
    px = ox + (px - ox) * scale
    py = oy + (py - oy) * scale

    # DDA setup (raycast.cpp:253-301) in world/res lattice units (the
    # reference divides raw coords by the interval, no lower offset)
    sx, sy = px / res, py / res
    x = torch.floor(sx).to(torch.int32)
    y = torch.floor(sy).to(torch.int32)
    exi = torch.floor(ox / res).to(torch.int32)
    eyi = torch.floor(oy / res).to(torch.int32)
    dx = exi - x
    dy = eyi - y
    stx = torch.sign(dx)
    sty = torch.sign(dy)
    tmx = _intbound(sx, dx)
    tmy = _intbound(sy, dy)
    inf = _const(math.inf, sx)
    tdx = torch.where(dx != 0, 1.0 / torch.abs(dx).to(dtype), inf)
    tdy = torch.where(dy != 0, 1.0 / torch.abs(dy).to(dtype), inf)

    # occupancy of a cell or its 4 flat-index neighbours, with the
    # reference's guards: -1 only if y>0, -GLY only if x>0; +1/+GLY
    # unguarded (their y<GLY/x<GLX tests are always true -- the
    # flat wrap mirrors the reference's flat-array read)
    occf = (grid == OCCUPIED).reshape(-1)
    ii = torch.arange(H * W, device=dev)
    near = (occf
            | torch.roll(occf, -1)
            | (torch.roll(occf, 1) & (ii % W > 0))
            | torch.roll(occf, -W)
            | (torch.roll(occf, W) & (ii // W > 0)))

    def _cell_to_grid(cx, cy):
        # tmp = (cell + 0.5) * res; coord2gridIndex truncates + clamps
        gx = torch.clamp((((cx.to(dtype) + 0.5) * res - lower[0])
                          / res).to(torch.int32), 0, H - 1)
        gy = torch.clamp((((cy.to(dtype) + 0.5) * res - lower[1])
                          / res).to(torch.int32), 0, W - 1)
        return gx, gy

    zero = torch.zeros_like(x)
    done = ~valid | ((dx == 0) & (dy == 0))
    occl = torch.zeros_like(done)
    gxs, gys, emitted = [], [], []
    for _ in range(cfg.max_trace_cells):
        at_end = (x == exi) & (y == eyi)
        emit = ~done & ~at_end
        gx, gy = _cell_to_grid(x, y)
        blocked = emit & near[gx.long() * W + gy]
        gxs.append(gx)
        gys.append(gy)
        emitted.append(emit)
        step_x = tmx < tmy
        done = done | at_end | blocked
        x = torch.where(done, x, x + torch.where(step_x, stx, zero))
        y = torch.where(done, y, y + torch.where(step_x, zero, sty))
        tmx = torch.where(done | ~step_x, tmx, tmx + tdx)
        tmy = torch.where(done | step_x, tmy, tmy + tdy)
        occl = occl | blocked
    gxs, gys = torch.stack(gxs, 1), torch.stack(gys, 1)     # (4K, S)
    emitted = torch.stack(emitted, 1)

    # line[0..size-2]: drop each ray's LAST emitted cell (the endpoint
    # cell itself was never emitted -- the loop exits before the body)
    count = emitted.sum(dim=1)
    S = emitted.shape[1]
    miss = emitted & (torch.arange(S, device=dev)[None, :]
                      < (count - 1)[:, None])
    keep = ~occl & valid
    touched = _stamp((H, W), gxs, gys, miss & keep[:, None], dev)
    lo_min = _const(_logit(cfg.p_min), log_odds)
    return torch.where(touched & (log_odds <= lo_min), lo_min, log_odds)


def occupancy_update(state: OccupancyState, lower, res, pose, ranges,
                     hit_mask, lidar_cfg: LidarConfig = LidarConfig(),
                     cfg: OccupancyConfig = OccupancyConfig(),
                     cir_sup: bool = False):
    """Fuse one scan -- reference-exact SDFmap semantics (the compiled
    reference's goldens, tests/golden/fusion*):

      * endpoints: setCacheOccupancy(pt, 1) for in-range returns,
        (clamped pt, 0) for out-of-range/out-of-map beams
        (raycastProcess, sdf_map.cpp:145-163);
      * traversal: integer Bresenham from the robot cell, every line
        cell except the endpoint counted as a miss (:164-170);
      * the per-cell hit VOTE: the hit update applies iff
        count_hit >= count_total - 3*count_hit, i.e. hits win only when
        they are >= 1/4 of this scan's observations of the cell
        (updateOccupancyMap, :284-297);
      * log odds clamped to [logit(p_min), logit(p_max)], initialized
        BELOW the floor by `unknown_flag` (:179-180);
      * the sticky gridmap state machine: Unknown -> Unoccupied only
        while log odds <= logit(p_occ); ANY state -> Occupied above it;
        Occupied never reverts ("will not treat obstacles as free
        space", :81-92);
      * RemoveOutliers BEFORE the state machine: interior Unknown cells
        inside the detection window with all 4 neighbours Unoccupied
        become Unoccupied, and the robot's own 3x3 Unknown cells become
        Unoccupied (:316-349).
    """
    H, W = state.log_odds.shape
    lo = state.log_odds
    dtype, dev = lo.dtype, lo.device
    n_beams = ranges.shape[0]
    angles = pose[2] + (torch.arange(n_beams, dtype=dtype, device=dev)
                        / n_beams - 0.5) * lidar_cfg.fov_rad
    dirx, diry = torch.cos(angles), torch.sin(angles)

    # endpoint world coords: in-map returns at their range; beams past
    # detection_range clamped onto the range circle (miss); endpoints
    # outside the map pulled to the boundary then range-clamped (miss)
    exw = pose[0] + dirx * ranges
    eyw = pose[1] + diry * ranges
    upper = (lower[0] + H * res, lower[1] + W * res)
    in_map = ((exw >= lower[0]) & (exw <= upper[0])
              & (eyw >= lower[1]) & (eyw <= upper[1]))
    # closetPointInMap (sdf_map.cpp:595-614): scale the ray to the first
    # boundary crossing, minus 1e-3 of the ray
    diffx = exw - pose[0]
    diffy = eyw - pose[1]
    t_bound = torch.minimum(_t_for(diffx, lower[0], upper[0], pose[0]),
                            _t_for(diffy, lower[1], upper[1], pose[1]))
    t_clamped = t_bound - 1e-3
    exw = torch.where(in_map, exw, pose[0] + t_clamped * diffx)
    eyw = torch.where(in_map, eyw, pose[1] + t_clamped * diffy)
    # range clamp (applies to both branches)
    lo_len = torch.sqrt((exw - pose[0]) ** 2 + (eyw - pose[1]) ** 2)
    over = lo_len > lidar_cfg.max_range
    scale = torch.where(over, lidar_cfg.max_range
                        / torch.clamp(lo_len, min=1e-12),
                        _const(1.0, lo_len))
    exw = pose[0] + (exw - pose[0]) * scale
    eyw = pose[1] + (eyw - pose[1]) * scale
    end_occ = hit_mask & in_map & ~over

    def to_cell(px, py):
        cx = torch.clamp(((px - lower[0]) / res).to(torch.int32), 0, H - 1)
        cy = torch.clamp(((py - lower[1]) / res).to(torch.int32), 0, W - 1)
        return cx, cy

    ecx, ecy = to_cell(exw, eyw)
    scx, scy = to_cell(pose[0], pose[1])
    cells, on_line = _bresenham_trace(
        torch.stack([scx, scy]), torch.stack([ecx, ecy], dim=-1),
        cfg.max_trace_cells)

    # per-cell counts for this scan (setCacheOccupancy counters)
    end_flat = ecx.long() * W + ecy
    hits = torch.zeros(H * W, dtype=torch.int32, device=dev)
    hits.index_put_((end_flat,), end_occ.to(torch.int32), accumulate=True)
    total = torch.zeros(H * W, dtype=torch.int32, device=dev)
    total.index_put_((end_flat,), torch.ones_like(end_flat, dtype=torch.int32),
                     accumulate=True)
    total.index_put_(((cells[..., 0].long() * W + cells[..., 1]).reshape(-1),),
                     on_line.reshape(-1).to(torch.int32), accumulate=True)
    hits, total = hits.reshape(H, W), total.reshape(H, W)
    touched = total > 0

    lo_hit = _const(_logit(cfg.p_hit), lo)
    lo_miss = _const(_logit(cfg.p_miss), lo)
    lo_min = _const(_logit(cfg.p_min), lo)
    lo_max = _const(_logit(cfg.p_max), lo)
    # vote: count_hit >= count_total - 3*count_hit  <=>  4*hits >= total
    update = torch.where(4 * hits >= total, lo_hit, lo_miss)
    log_odds = torch.where(
        touched, torch.minimum(torch.maximum(lo + update, lo_min), lo_max),
        lo)

    # circular-support carve between raycastProcess and RemoveOutliers
    # (updateOccupancyCallback :53-61).  The reference's static counter
    # `cirSup=1; ++; %3` fires on every SECOND scan (2, 4, 6, ...), not
    # every third -- the caller owns that cadence and passes cir_sup
    # accordingly.  Occlusion reads the PREVIOUS gridmap (it is only
    # rewritten at the end of the callback).
    if cir_sup:
        fov = (lidar_cfg.fov_rad
               if lidar_cfg.fov_rad < 2.0 * math.pi - 1e-6 else None)
        log_odds = _cir_sup_raise(state.grid, log_odds, lower, res, pose,
                                  lidar_cfg.max_range, cfg, fov)

    # RemoveOutliers on the PREVIOUS gridmap (callback order :52-62)
    grid = _remove_outliers(state.grid, lower, res, pose,
                            lidar_cfg.max_range, (scx, scy))

    # gridmap state machine over the detection window (here: wherever
    # the window reaches; cells outside keep their state)
    win = _window_mask((H, W), lower, res, pose, lidar_cfg.max_range)
    lo_occ = _const(_logit(cfg.p_occ), lo)
    to_free = win & (grid == UNKNOWN) & (log_odds >= lo_min) \
        & (log_odds <= lo_occ)
    to_occ = win & (log_odds > lo_occ)
    grid = torch.where(to_free, _const(UNOCCUPIED, grid), grid)
    grid = torch.where(to_occ, _const(OCCUPIED, grid), grid)
    return OccupancyState(log_odds=log_odds, known=grid != UNKNOWN,
                          grid=grid)


def occupancy_update_perspective(state: OccupancyState, lower, res, pose,
                                 points, point_mask, detection_range,
                                 cfg: OccupancyConfig = OccupancyConfig()):
    """The perspective branch of updateOccupancyCallback
    (sdf_map.cpp:96-129, `if_perspective_ == true`), used with the laser
    simulator's perspectivePoints mode: no raycasting and no log-odds --
    every Unknown cell in the odom-centred detection window becomes
    Unoccupied, then every in-map cloud point's cell is stamped
    Occupied.  Occupied never reverts (nothing ever downgrades it).

    `points` (P, 2) world coords; `point_mask` (P,) selects real points.
    occupancy_map_ (log_odds) is untouched by this branch.
    """
    H, W = state.log_odds.shape
    grid = state.grid
    win = _window_mask((H, W), lower, res, pose, detection_range)
    grid = torch.where(win & (grid == UNKNOWN), _const(UNOCCUPIED, grid),
                       grid)

    # isInGloMap is STRICT (sdf_map.cpp:591-593); coord2gridIndex
    # truncates and clamps
    px, py = points[:, 0], points[:, 1]
    upper = (lower[0] + H * res, lower[1] + W * res)
    ok = (point_mask & (px > lower[0]) & (px < upper[0])
          & (py > lower[1]) & (py < upper[1]))
    gx = torch.clamp(((px - lower[0]) / res).to(torch.int32), 0, H - 1)
    gy = torch.clamp(((py - lower[1]) / res).to(torch.int32), 0, W - 1)
    hit = _stamp((H, W), gx, gy, ok, grid.device)
    grid = torch.where(hit, _const(OCCUPIED, grid), grid)
    return OccupancyState(log_odds=state.log_odds,
                          known=grid != UNKNOWN, grid=grid)


def _window_mask(shape, lower, res, pose, detection_range):
    """Cells inside the odom-centred detection window, index bounds
    computed as the reference does (coord2gridIndex of the clamped
    window corners, sdf_map.cpp:42-46, 65-67)."""
    H, W = shape
    rng = (torch.ceil(detection_range / res) * res if torch.is_tensor(res)
           else math.ceil(detection_range / res) * res)

    def t(v):
        # a host number joins the pose's dtype, as a weakly typed one does
        return v if torch.is_tensor(v) else _const(v, pose)
    xl = torch.maximum(pose[0] - rng, t(lower[0]))
    xu = torch.minimum(pose[0] + rng, t(lower[0] + H * res))
    yl = torch.maximum(pose[1] - rng, t(lower[1]))
    yu = torch.minimum(pose[1] + rng, t(lower[1] + W * res))
    min_x = torch.clamp(((xl - lower[0]) / res).to(torch.int32), 0, H - 1)
    max_x = torch.clamp(((xu - lower[0]) / res).to(torch.int32), 0, H - 1)
    min_y = torch.clamp(((yl - lower[1]) / res).to(torch.int32), 0, W - 1)
    max_y = torch.clamp(((yu - lower[1]) / res).to(torch.int32), 0, W - 1)
    ii = torch.arange(H, device=pose.device)[:, None]
    jj = torch.arange(W, device=pose.device)[None, :]
    return (ii >= min_x) & (ii <= max_x) & (jj >= min_y) & (jj <= max_y)


def _remove_outliers(grid, lower, res, pose, detection_range, odom_cell):
    """RemoveOutliers (sdf_map.cpp:316-349): interior Unknown cells in
    the detection window whose 4 neighbours are all Unoccupied become
    Unoccupied; the robot's 3x3 Unknown neighbourhood becomes
    Unoccupied."""
    H, W = grid.shape
    free = grid == UNOCCUPIED
    up = torch.roll(free, -1, 0)
    dn = torch.roll(free, 1, 0)
    lf = torch.roll(free, -1, 1)
    rt = torch.roll(free, 1, 1)
    interior = torch.zeros((H, W), dtype=torch.bool, device=grid.device)
    interior[1:-1, 1:-1] = True
    win = _window_mask((H, W), lower, res, pose, detection_range)
    fill = (grid == UNKNOWN) & interior & win & up & dn & lf & rt
    grid = torch.where(fill, _const(UNOCCUPIED, grid), grid)
    return _fill_near_robot(grid, *odom_cell)


def _fill_near_robot(grid, scx, scy):
    """The robot's 3x3 Unknown cells become Unoccupied."""
    H, W = grid.shape
    ii = torch.arange(H, device=grid.device)[:, None]
    jj = torch.arange(W, device=grid.device)[None, :]
    near = (torch.abs(ii - scx) <= 1) & (torch.abs(jj - scy) <= 1)
    return torch.where(near & (grid == UNKNOWN), _const(UNOCCUPIED, grid),
                       grid)


def occupancy_classes(state: OccupancyState,
                      cfg: OccupancyConfig = OccupancyConfig()):
    """(occupied, free, unknown) boolean grids (gridmap_ semantics --
    served from the sticky state machine, not re-thresholded)."""
    return (state.grid == OCCUPIED, state.grid == UNOCCUPIED,
            state.grid == UNKNOWN)


def perspective_points(true_occ, lower, res, pose,
                       cfg: LidarConfig = LidarConfig()):
    """Perspective (non-occluded) local cloud: laser_sim_node.cpp:343-421.

    The reference's `perspectivePoints` mode does NOT render rays: it
    crops the global cloud to `sensing_horizon` around the robot and
    transforms every point into the sensor frame -- obstacles behind
    other obstacles are still returned.  Dense equivalent: every
    occupied cell centre within range, expressed in the sensor frame.

    Returns (pts_sensor (H, W, 2), mask (H, W)): mask selects the
    returned points; pts_sensor rows are only meaningful where mask.
    """
    H, W = true_occ.shape
    dtype, dev = pose.dtype, pose.device
    cx = lower[0] + (torch.arange(H, dtype=dtype, device=dev) + 0.5) * res
    cy = lower[1] + (torch.arange(W, dtype=dtype, device=dev) + 0.5) * res
    gx = cx[:, None] - pose[0]
    gy = cy[None, :] - pose[1]
    dist = torch.sqrt(gx * gx + gy * gy)
    mask = true_occ & (dist <= cfg.max_range)
    if cfg.fov_rad < 2.0 * math.pi - 1e-6:
        ang = torch.atan2(gy, gx) - pose[2]
        ang = torch.remainder(ang + math.pi, 2.0 * math.pi) - math.pi
        mask = mask & (torch.abs(ang) <= cfg.fov_rad / 2.0)
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    # world -> sensor frame (rot.transpose() * (p - t), :363-386)
    px = c * gx + s * gy
    py = -s * gx + c * gy
    return torch.stack([px, py], dim=-1), mask


def circular_support_update(state: OccupancyState, lower, res, pose,
                            detection_range,
                            cfg: OccupancyConfig = OccupancyConfig(),
                            fov_rad: float = None,
                            n_steps: int = None):
    """Standalone free-space carving without sensor returns:
    cirSupRaycastProcess (sdf_map.cpp:178-280) via the reference-exact
    `_cir_sup_raise`, followed by the two callback-tail steps that make
    the carve observable on the gridmap when no scan fusion runs this
    tick: the robot's 3x3 Unknown fill (RemoveOutliers' second half,
    :341-348) and the window state machine's Unknown -> Unoccupied
    transition.  Inside the live pipeline use
    `occupancy_update(..., cir_sup=True)` instead, which runs the carve
    at the reference's exact point in the callback order.  `n_steps` is
    accepted for API compatibility and ignored (the DDA is exact, not
    sampled).
    """
    H, W = state.log_odds.shape
    log_odds = _cir_sup_raise(state.grid, state.log_odds, lower, res,
                              pose, detection_range, cfg, fov_rad)
    scx = torch.clamp(((pose[0] - lower[0]) / res).to(torch.int32), 0, H - 1)
    scy = torch.clamp(((pose[1] - lower[1]) / res).to(torch.int32), 0, W - 1)
    grid = _fill_near_robot(state.grid, scx, scy)
    win = _window_mask((H, W), lower, res, pose, detection_range)
    lo_min = _const(_logit(cfg.p_min), log_odds)
    lo_occ = _const(_logit(cfg.p_occ), log_odds)
    to_free = win & (grid == UNKNOWN) & (log_odds >= lo_min) \
        & (log_odds <= lo_occ)
    grid = torch.where(to_free, _const(UNOCCUPIED, grid), grid)
    return OccupancyState(log_odds=log_odds, known=grid != UNKNOWN,
                          grid=grid)
