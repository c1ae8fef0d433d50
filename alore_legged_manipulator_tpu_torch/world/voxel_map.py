"""3-D probabilistic voxel mapping: the octomap analogue (port of
world/voxel_map.py).

The reference vendors the full OctoMap library (planning_ddr_opt/octomap,
~12k LoC) and uses it through two paths: the global map's 3-D cloud
publication (utils/simulator/src/global_map.cpp:560-571 extrudes occupied
2-D cells into a z-band; :581-630 publish_octomap_from_pcd transforms and
republishes a PCD), and the octomap_ros conversions.  The library's own
capabilities -- insertPointCloud with free-space carving, castRay,
clamped log-odds updates, bounding-box queries, multi-resolution
(tree-depth) occupancy -- are exercised by its vendored unit tests
(octomap/src/testing/test_raycasting.cpp, test_bbx.cpp, test_pruning.cpp).

A pointer-chasing octree does not batch, so the same capabilities map
onto a dense (X, Y, Z) log-odds grid on the device:

  * insert_point_cloud -- one (n_rays, n_steps) sample lattice per cloud,
    two scatters (free-carve + endpoint hits) as `amax` reductions on an
    int32 grid (duplicate voxels carrying different values reduce to
    their maximum, whatever the order; an invalid sample adds 0 at index
    0, harmless under max), one clamped log-odds update.
    Endpoint-wins-over-miss and per-cloud voxel dedup match octomap's
    discretized insertion (OccupancyOcTreeBase::insertPointCloud
    computeDiscreteUpdate semantics).
  * cast_rays -- batched first-occupied-voxel search over a sample
    lattice (octomap::castRay): `argmax` over the samples of an int32
    cast of the hits returns the first one, as in JAX.
  * pyramid / occupancy_at_depth -- the octree-depth analogue: factor-2
    max-pooling of occupancy per level reproduces octomap's
    child-maximum occupancy propagation at inner nodes.
  * from_grid_map / to_point_cloud -- the global_map roles: extrude a
    2-D occupancy grid into a z-band (global_map.cpp:560-571) and
    export occupied voxel centers through a rigid transform
    (publish_octomap_from_pcd :581-630).

World coordinates go to voxels in the wider of the points' dtype and
the map origin's (an origin given as numbers or numpy is float64), as
the JAX package computes them with x64 enabled.

Default log-odds parameters are octomap's own (OcTreeBase: prob_hit 0.7,
prob_miss 0.4, clamp [0.1192, 0.971], occupancy threshold 0.5).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.precision import resolve_device


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


class VoxelMapConfig(NamedTuple):
    """octomap OcTree defaults (octomap/include/octomap/OcTreeBaseImpl.h)."""

    p_hit: float = 0.7
    p_miss: float = 0.4
    p_clamp_min: float = 0.1192
    p_clamp_max: float = 0.971
    p_occ: float = 0.5
    n_steps: int = 128     # samples per carve ray


class VoxelMapState(NamedTuple):
    log_odds: torch.Tensor   # (X, Y, Z)
    known: torch.Tensor      # (X, Y, Z) bool -- ever observed


def voxel_map_init(shape: Tuple[int, int, int],
                   cfg: VoxelMapConfig = VoxelMapConfig(),
                   dtype=torch.float32, device=None) -> VoxelMapState:
    """An all-unknown map on `device` (None: the card)."""
    dev = resolve_device(device)
    return VoxelMapState(log_odds=torch.zeros(shape, dtype=dtype, device=dev),
                         known=torch.zeros(shape, dtype=torch.bool,
                                           device=dev))


def _as(x, like, dtype=None):
    """`x` as a tensor on `like`'s device; numbers and numpy keep their
    own float dtype (float64), tensors theirs, unless `dtype` is given."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device=like.device).to(dtype or torch.float64)


def world_to_voxel(lower, res, pts):
    """World coords (..., 3) -> integer voxel indices (..., 3)."""
    lower = _as(lower, pts)
    dt = torch.promote_types(pts.dtype, lower.dtype)
    return torch.floor((pts.to(dt) - lower.to(dt)) / res).to(torch.int32)


def voxel_center(lower, res, idx):
    idx = torch.as_tensor(idx)
    return _as(lower, idx) + (idx.to(torch.float32) + 0.5) * res


def _flat_idx(idx, shape):
    """(..., 3) voxel indices -> flat indices + validity mask."""
    ix, iy, iz = idx[..., 0], idx[..., 1], idx[..., 2]
    valid = ((ix >= 0) & (ix < shape[0]) & (iy >= 0) & (iy < shape[1])
             & (iz >= 0) & (iz < shape[2]))
    flat = (ix.long() * shape[1] + iy) * shape[2] + iz
    return torch.where(valid, flat, torch.zeros_like(flat)), valid


def _scatter_max(n, idx, val):
    """A flat bool grid of `n` cells, each the max of the `val`s aimed at
    it (False where none)."""
    grid = torch.zeros(n, dtype=torch.int32, device=idx.device)
    return grid.scatter_reduce_(0, idx.reshape(-1),
                                val.reshape(-1).to(torch.int32),
                                reduce="amax").bool()


def insert_point_cloud(state: VoxelMapState, lower, res, origin, points,
                       max_range: float = -1.0,
                       cfg: VoxelMapConfig = VoxelMapConfig()
                       ) -> VoxelMapState:
    """octomap insertPointCloud: carve free space along each ray, mark
    endpoints occupied, clamped log-odds, per-cloud dedup.

    origin: (3,) sensor position; points: (R, 3) measured endpoints.
    max_range < 0 disables range truncation; rays longer than max_range
    carve free space up to max_range and register NO hit (octomap
    maxrange semantics).
    """
    lo = state.log_odds
    shape = lo.shape
    origin = _as(origin, lo, lo.dtype)
    points = _as(points, lo, lo.dtype)
    delta = points - origin[None, :]
    dist = torch.linalg.vector_norm(delta, dim=-1)

    if max_range > 0:
        truncated = dist > max_range
        scale = torch.where(truncated,
                            max_range / torch.clamp(dist, min=1e-9),
                            torch.ones_like(dist))
        endpoints = origin[None, :] + delta * scale[:, None]
    else:
        truncated = torch.zeros(dist.shape, dtype=torch.bool,
                                device=lo.device)
        endpoints = points

    # free-space lattice: samples strictly before the endpoint voxel
    t = (torch.arange(cfg.n_steps, dtype=lo.dtype, device=lo.device)
         / cfg.n_steps)                                   # [0, 1)
    samples = origin[None, None, :] + (endpoints - origin)[:, None, :] \
        * t[None, :, None]                                # (R, S, 3)
    free_idx, free_valid = _flat_idx(
        world_to_voxel(lower, res, samples), shape)
    end_idx, end_valid = _flat_idx(
        world_to_voxel(lower, res, endpoints), shape)
    hit_valid = end_valid & ~truncated

    n = lo.numel()
    free_mask = _scatter_max(n, free_idx, free_valid).reshape(shape)
    hit_mask = _scatter_max(n, end_idx, hit_valid).reshape(shape)

    l_hit = _logit(cfg.p_hit)
    l_miss = _logit(cfg.p_miss)
    zero = torch.zeros((), dtype=lo.dtype, device=lo.device)
    upd = torch.where(hit_mask, l_hit,
                      torch.where(free_mask, l_miss, zero))
    log_odds = torch.clamp(lo + upd, _logit(cfg.p_clamp_min),
                           _logit(cfg.p_clamp_max))
    return VoxelMapState(log_odds=log_odds,
                         known=state.known | free_mask | hit_mask)


def occupied_mask(state: VoxelMapState,
                  cfg: VoxelMapConfig = VoxelMapConfig()):
    return state.known & (state.log_odds > _logit(cfg.p_occ))


def cast_rays(state: VoxelMapState, lower, res, origin, directions,
              max_range: float, cfg: VoxelMapConfig = VoxelMapConfig()):
    """octomap castRay, batched: first occupied voxel along each ray.

    directions: (R, 3) unit vectors.  Returns (hit (R,) bool,
    range (R,), end_voxel (R, 3)); misses report max_range.
    """
    lo = state.log_odds
    occ = occupied_mask(state, cfg)
    shape = occ.shape
    directions = _as(directions, lo, lo.dtype)
    n = cfg.n_steps
    r = (torch.arange(1, n + 1, dtype=lo.dtype, device=lo.device) / n) \
        * max_range
    samples = (_as(origin, lo, lo.dtype)[None, None, :]
               + directions[:, None, :] * r[None, :, None])   # (R, S, 3)
    idx = world_to_voxel(lower, res, samples)
    flat, valid = _flat_idx(idx, shape)
    occ_along = occ.reshape(-1)[flat] & valid                  # (R, S)
    any_hit = torch.any(occ_along, dim=1)
    first = torch.argmax(occ_along.to(torch.int32), dim=1)
    hit_range = torch.where(any_hit, r[first],
                            torch.full_like(r[first], max_range))
    end_voxel = torch.gather(idx, 1, first[:, None, None].expand(
        -1, 1, 3))[:, 0, :]
    return any_hit, hit_range, end_voxel


def pyramid(state: VoxelMapState, levels: int,
            cfg: VoxelMapConfig = VoxelMapConfig()):
    """Multi-resolution occupancy: factor-2 max-pool per level.

    Reproduces octomap's inner-node occupancy under the child-MAXIMUM
    policy (an inner node is occupied iff any child is).  Level 0 is the
    leaf grid; level k has voxels of size res * 2**k.  Dimensions must
    be divisible by 2**levels.  Returns [occupied_mask per level].
    """
    occ = occupied_mask(state, cfg)
    out = [occ]
    cur = occ
    for _ in range(levels):
        x, y, z = cur.shape
        assert x % 2 == 0 and y % 2 == 0 and z % 2 == 0, cur.shape
        cur = torch.any(cur.reshape(x // 2, 2, y // 2, 2, z // 2, 2),
                        dim=(1, 3, 5))
        out.append(cur)
    return out


def occupancy_at_depth(state: VoxelMapState, level: int, idx,
                       cfg: VoxelMapConfig = VoxelMapConfig()):
    """Occupancy of the size-2**level super-voxel containing leaf `idx`
    (octomap search(key, depth))."""
    i = tuple(int(v) // (2 ** level) for v in idx)
    return pyramid(state, level, cfg)[level][i]


def bbx_occupied(state: VoxelMapState, lower, res, bbx_min, bbx_max,
                 cfg: VoxelMapConfig = VoxelMapConfig()):
    """Occupied voxel centers inside a world-frame bounding box
    (octomap leaf_bbx iterator / test_bbx.cpp role).  Host-side helper:
    returns an (M, 3) numpy array of centers."""
    occ = occupied_mask(state, cfg).cpu().numpy()
    idx = np.argwhere(occ)
    centers = _host(lower) + (idx + 0.5) * res
    keep = np.all((centers >= _host(bbx_min))
                  & (centers <= _host(bbx_max)), axis=1)
    return centers[keep]


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def from_grid_map(occ2d, z_levels: int = 10) -> torch.Tensor:
    """Extrude a 2-D occupancy grid into a z-band of voxels, exactly the
    global_map laser-cloud extrusion (global_map.cpp:560-571: each
    occupied (x, y) cell becomes z in [-5, 5) grid levels).

    Returns a (X, Y, z_levels) bool grid (z index 0 = lowest level), on
    the grid's device (a numpy grid: the CPU)."""
    occ2d = torch.as_tensor(occ2d).to(torch.bool)
    return occ2d[:, :, None].expand(occ2d.shape + (z_levels,))


def state_from_occupied(occ3d, cfg: VoxelMapConfig = VoxelMapConfig()
                        ) -> VoxelMapState:
    """Build a map state from a known boolean grid (ground-truth worlds),
    float32, on the grid's device."""
    occ3d = torch.as_tensor(occ3d).to(torch.bool)
    lo = torch.where(occ3d, _logit(cfg.p_clamp_max), _logit(cfg.p_clamp_min))
    return VoxelMapState(log_odds=lo.to(torch.float32),
                         known=torch.ones_like(occ3d))


def to_point_cloud(state: VoxelMapState, lower, res, rotation=None,
                   translation=None,
                   cfg: VoxelMapConfig = VoxelMapConfig()):
    """Occupied voxel centers through an optional rigid transform --
    the publish_octomap_from_pcd role (global_map.cpp:581-630: load,
    rotate by yaw-pitch-roll, offset, publish).  Host-side export
    (numpy)."""
    occ = occupied_mask(state, cfg).cpu().numpy()
    idx = np.argwhere(occ)
    pts = _host(lower) + (idx + 0.5) * res
    if rotation is not None:
        pts = pts @ _host(rotation).T
    if translation is not None:
        pts = pts + _host(translation)
    return pts
