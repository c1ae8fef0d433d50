"""Euclidean signed distance fields (port of ops/esdf.py).

The exact 1-D squared distance transform is a dense min-reduction per
axis (one (rows, n, n) broadcast), as in the JAX package.  Distance
convention (sdf_map.cpp:670-679): outside distance where free,
-inside + h where occupied, in meters.

`ESDF.dist` is (H, W) for one map or (B, H, W) for one map per lane;
`lower` (2,) and `res` () are float32 tensors shared by all lanes.
The samplers take a per-lane field (B, H, W) and query points
(B, ..., 2).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _sq_dist_transform_1d(f, block: int = 256):
    """D[..., x] = min_y ((x - y)^2 + f[..., y]) along the last axis."""
    n = f.shape[-1]
    y = torch.arange(n, device=f.device)
    pieces = []
    for x0 in range(0, n, block):
        x = torch.arange(x0, min(x0 + block, n), device=f.device)
        d2 = (x[:, None] - y[None, :]).to(f.dtype) ** 2
        pieces.append(torch.amin(f[..., None, :] + d2, dim=-1))
    return torch.cat(pieces, dim=-1) if len(pieces) > 1 else pieces[0]


def _edt(source_mask, res, block: int = 256):
    """Euclidean distance (meters) from each cell center to the nearest
    source cell; a source-free mask yields the finite map-diagonal cap."""
    H, W = source_mask.shape[-2:]
    cap = torch.tensor(float(H * H + W * W), dtype=torch.float32,
                       device=source_mask.device)
    f = torch.where(source_mask, torch.zeros_like(cap), cap)
    d1 = _sq_dist_transform_1d(f, block)
    d2 = _sq_dist_transform_1d(d1.transpose(-1, -2), block).transpose(-1, -2)
    # the square root in float64, rounded once to float32: the correctly
    # rounded float32 root on every device (the card's float32 root was
    # 1 ulp off in 16 cells of a 500x500 field; the squares are exact)
    root = torch.sqrt(torch.minimum(d2, cap).to(torch.float64))
    return res * root.to(torch.float32)


class ESDF(NamedTuple):
    dist: torch.Tensor    # (H, W) or (B, H, W) float32
    lower: torch.Tensor   # (2,) float32
    res: torch.Tensor     # () float32

    @property
    def shape(self):
        return tuple(self.dist.shape[-2:])


def esdf_from_occupancy(occ, lower, res, block: int = 256) -> ESDF:
    """occ: (..., H, W) bool occupancy (True = occupied)."""
    occ = torch.as_tensor(occ).to(torch.bool)
    dev = occ.device
    res_t = torch.as_tensor(res, dtype=torch.float32, device=dev)
    d_pos = _edt(occ, res_t, block)
    d_neg = _edt(torch.logical_not(occ), res_t, block)
    dist = torch.where(d_neg > 0.0, d_pos - d_neg + res_t, d_pos)
    return ESDF(dist=dist.to(torch.float32),
                lower=torch.as_tensor(lower, dtype=torch.float32,
                                      device=dev).reshape(2),
                res=res_t)


def _lane_dist(esdf: ESDF, B: int):
    d = esdf.dist
    return d.expand(B, *d.shape[-2:]) if d.dim() == 2 else d


def _base_index(esdf: ESDF, pos):
    H, W = esdf.shape
    inv = 1.0 / esdf.res
    p = (pos - esdf.lower) * inv - 0.5
    idx = torch.floor(p).to(torch.int64)
    ix = torch.clamp(idx[..., 0], 0, H - 1)
    iy = torch.clamp(idx[..., 1], 0, W - 1)
    fx = p[..., 0] - ix.to(p.dtype)
    fy = p[..., 1] - iy.to(p.dtype)
    upper = esdf.lower + torch.tensor([H, W], dtype=pos.dtype,
                                      device=pos.device) * esdf.res
    inside = torch.all((pos >= esdf.lower) & (pos <= upper), dim=-1)
    interior = (ix < H - 1) & (iy < W - 1)
    return ix, iy, fx, fy, inside & interior


def _gather_cells(grid, flat_idx):
    """grid (B, C, ...) gathered at per-lane flat indices (B, ...)."""
    B = grid.shape[0]
    fi = flat_idx.reshape(B, -1)
    if grid.dim() == 2:
        return torch.gather(grid, 1, fi).reshape(flat_idx.shape)
    k = grid.shape[-1]
    out = torch.gather(grid, 1, fi[..., None].expand(B, fi.shape[1], k))
    return out.reshape(*flat_idx.shape, k)


def sample_dist_grad_bilinear(esdf: ESDF, pos, out_value: float = 1e10):
    """Bilinear distance + gradient at world pos (B, ..., 2)
    (sdf_map.cpp:796-830 semantics).  Returns (dist (B, ...),
    grad (B, ..., 2))."""
    B = pos.shape[0]
    H, W = esdf.shape
    g = _lane_dist(esdf, B).reshape(B, H * W)
    ix, iy, fx, fy, valid = _base_index(esdf, pos)
    ix1 = torch.clamp(ix + 1, max=H - 1)
    iy1 = torch.clamp(iy + 1, max=W - 1)
    v00 = _gather_cells(g, ix * W + iy)
    v10 = _gather_cells(g, ix1 * W + iy)
    v01 = _gather_cells(g, ix * W + iy1)
    v11 = _gather_cells(g, ix1 * W + iy1)
    v0 = (1 - fx) * v00 + fx * v10
    v1 = (1 - fx) * v01 + fx * v11
    d = (1 - fy) * v0 + fy * v1
    inv = 1.0 / esdf.res
    gy = (v1 - v0) * inv
    gx = ((1 - fy) * (v10 - v00) + fy * (v11 - v01)) * inv
    d = torch.where(valid, d, torch.full_like(d, out_value))
    grad = torch.where(valid[..., None], torch.stack([gx, gy], dim=-1),
                       torch.zeros_like(d)[..., None])
    return d, grad


def sample_dist_bilinear(esdf: ESDF, pos, out_value: float = 1e10):
    return sample_dist_grad_bilinear(esdf, pos, out_value)[0]


def pack_corner_grid(esdf: ESDF, B: int | None = None):
    """(B, H*W, 4) table of [v00, v10, v01, v11] per base cell."""
    g = esdf.dist if B is None else _lane_dist(esdf, B)
    gx = torch.cat([g[..., 1:, :], g[..., -1:, :]], dim=-2)
    gy = torch.cat([g[..., :, 1:], g[..., :, -1:]], dim=-1)
    gxy = torch.cat([gy[..., 1:, :], gy[..., -1:, :]], dim=-2)
    out = torch.stack([g, gx, gy, gxy], dim=-1)
    return out.reshape(*out.shape[:-3], -1, 4)


def sample_dist_bilinear_packed(esdf: ESDF, corners, pos,
                                out_value: float = 1e10):
    """sample_dist_bilinear with a pack_corner_grid table (B, H*W, 4)."""
    H, W = esdf.shape
    ix, iy, fx, fy, valid = _base_index(esdf, pos)
    v = _gather_cells(corners, ix * W + iy)       # (B, ..., 4)
    v0 = (1 - fx) * v[..., 0] + fx * v[..., 1]
    v1 = (1 - fx) * v[..., 2] + fx * v[..., 3]
    d = (1 - fy) * v0 + fy * v1
    return torch.where(valid, d, torch.full_like(d, out_value))


def dist_at_cell(esdf: ESDF, pos, out_value: float = 10000.0):
    """Nearest-cell distance lookup (getDistanceReal); pos (B, ..., 2)."""
    B = pos.shape[0]
    H, W = esdf.shape
    idx = torch.floor((pos - esdf.lower) / esdf.res).to(torch.int64)
    ix = torch.clamp(idx[..., 0], 0, H - 1)
    iy = torch.clamp(idx[..., 1], 0, W - 1)
    d = _gather_cells(_lane_dist(esdf, B).reshape(B, H * W), ix * W + iy)
    upper = esdf.lower + torch.tensor([H, W], dtype=pos.dtype,
                                      device=pos.device) * esdf.res
    inside = torch.all((pos >= esdf.lower) & (pos <= upper), dim=-1)
    return torch.where(inside, d, torch.full_like(d, out_value))
