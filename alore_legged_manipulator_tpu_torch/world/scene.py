"""Scene / terrain assembly (capability rebuild of Simulation env/; the
port's own copy of world/scene.py, host numpy).

Reference: Simulation/isaac_b2_controller/env/terrain.py:7-80
(`uniform_discrete_obstacles_terrain`: min-distance rejection-sampled
box obstacles on a height field with a cleared center platform) and
env/sim_env.py:24-100 (sparse/medium/dense scene presets over a 50x50 m
world with a 5 m border and the origin kept clear).

No IsaacSim here: the products are (a) a height field (H, W) in meters
and (b) its occupancy grid at a threshold -- which feed the port's
planning stack (ops/esdf on the device, the JPS front end on the host)
the way the reference terrain feeds its simulator, and the arrangement
missions as generated worlds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class ObstacleTerrainConfig:
    """HfUniformDiscreteObstaclesTerrainCfg analogue (terrain.py cfg)."""

    size: Tuple[float, float] = (50.0, 50.0)
    horizontal_scale: float = 0.1      # grid resolution (m / cell)
    vertical_scale: float = 0.005      # height units (m)
    obstacle_width_range: Tuple[float, float] = (0.5, 1.0)
    obstacle_height_range: Tuple[float, float] = (1.0, 2.0)
    num_obstacles: int = 100
    obstacles_distance: float = 2.0    # min center spacing
    border_width: float = 5.0
    platform_width: float = 2.0        # cleared center platform
    avoid_positions: List[Tuple[float, float]] = field(
        default_factory=lambda: [(0.0, 0.0)])
    seed: int = 0
    max_rejection_tries: int = 200     # deterministic stand-in for the
    #                                    reference's 0.2 s wall-clock cap


def uniform_discrete_obstacles_terrain(cfg: ObstacleTerrainConfig
                                       ) -> np.ndarray:
    """Height field (W, L) in meters; terrain.py:7-80 semantics.

    Box obstacles with rejection-sampled positions keeping
    `obstacles_distance` spacing from all previous obstacles and the
    avoid list; the center platform is cleared afterwards.  The
    reference bounds rejection sampling by wall-clock (0.2 s); here a
    deterministic try cap replaces it so worlds are reproducible.
    """
    rng = np.random.default_rng(cfg.seed)
    hs = cfg.horizontal_scale
    W = int(cfg.size[0] / hs)
    L = int(cfg.size[1] / hs)
    hf = np.zeros((W, L), np.float64)

    obs_xr = np.arange(0, W, 4)
    obs_yr = np.arange(0, L, 4)
    placed = [tuple(map(float, p)) for p in cfg.avoid_positions]

    def far_enough(x, y):
        return all((x - px) ** 2 + (y - py) ** 2
                   >= cfg.obstacles_distance ** 2 for px, py in placed)

    for _ in range(cfg.num_obstacles):
        height = rng.uniform(*cfg.obstacle_height_range)
        width = int(rng.uniform(*cfg.obstacle_width_range) / hs)
        length = int(rng.uniform(*cfg.obstacle_width_range) / hs)
        ok = False
        for _try in range(cfg.max_rejection_tries):
            x0 = int(rng.choice(obs_xr))
            y0 = int(rng.choice(obs_yr))
            if far_enough(x0 * hs, y0 * hs):
                ok = True
                break
        if not ok:
            break
        placed.append((x0 * hs, y0 * hs))
        x0 = min(x0, W - width)
        y0 = min(y0, L - length)
        hf[x0:x0 + width, y0:y0 + length] = height

    # clear the center platform (terrain.py:73-78)
    pw = int(cfg.platform_width / hs)
    x1, x2 = (W - pw) // 2, (W + pw) // 2
    y1, y2 = (L - pw) // 2, (L + pw) // 2
    hf[x1:x2, y1:y2] = 0.0
    # quantize to the vertical scale like the height-field pipeline
    return np.rint(hf / cfg.vertical_scale) * cfg.vertical_scale


@dataclass
class Scene:
    height_field: np.ndarray    # (W, L) meters
    occupancy: np.ndarray       # (W, L) bool at the robot's height
    lower: Tuple[float, float]
    res: float
    clear_center: Tuple[float, float]


def _with_border(occ: np.ndarray, border_cells: int) -> np.ndarray:
    out = occ.copy()
    b = border_cells
    if b > 0:
        out[:b, :] = True
        out[-b:, :] = True
        out[:, :b] = True
        out[:, -b:] = True
    return out


def make_scene(preset: str = "sparse", seed: int = 0,
               size: Tuple[float, float] = (50.0, 50.0),
               occupancy_height: float = 0.3) -> Scene:
    """Scene presets of sim_env.py: sparse (100) / medium (200) /
    dense (300) obstacles on the same 50 m world with a 5 m border."""
    counts = {"sparse": 100, "medium": 200, "dense": 300}
    if preset not in counts:
        raise ValueError(f"unknown preset {preset!r}")
    cfg = ObstacleTerrainConfig(size=size, num_obstacles=counts[preset],
                                seed=seed)
    hf = uniform_discrete_obstacles_terrain(cfg)
    occ = hf > occupancy_height
    occ = _with_border(occ, int(cfg.border_width / cfg.horizontal_scale))
    return Scene(height_field=hf, occupancy=occ,
                 lower=(0.0, 0.0), res=cfg.horizontal_scale,
                 clear_center=(size[0] / 2, size[1] / 2))
