"""Occupancy-grid construction and map painting (port of world/grid_map.py).

Covers the reference's GlobalMap yaml-obstacle path (global_map.cpp
get_grid_from_yaml) and the object painting of the task layer
(plan_manager.hpp:470-496 paintSquare): missions stamp object footprints
into the grid before planning.

Grids are (H, W) bool tensors with x along axis 0; world coordinates
follow the SDFmap convention (cell centers at lower + (idx + 0.5) * res).
The painting arithmetic runs in the promoted dtype of `lower` and
`center` on the grid's device.  The two file readers are host numpy.
"""
from __future__ import annotations

import torch

from ..utils.precision import resolve_device


def make_occupancy(h: int, w: int, device=None):
    """An empty (h, w) grid; device=None means the card."""
    return torch.zeros((h, w), dtype=torch.bool, device=resolve_device(device))


def _cell_centers(h, w, lower, res, dtype):
    dev = lower.device
    xs = lower[0] + (torch.arange(h, dtype=dtype, device=dev) + 0.5) * res
    ys = lower[1] + (torch.arange(w, dtype=dtype, device=dev) + 0.5) * res
    return xs[:, None], ys[None, :]


def _as_tensors(occ, lower, center):
    lower = torch.as_tensor(lower, device=occ.device)
    center = torch.as_tensor(center, device=occ.device)
    if not lower.is_floating_point():
        lower = lower.to(torch.get_default_dtype())
    if not center.is_floating_point():
        center = center.to(torch.get_default_dtype())
    return lower, center, torch.promote_types(lower.dtype, center.dtype)


def paint_rect(occ, lower, res, center, size, yaw=0.0, value=True):
    """Stamp a (possibly rotated) rectangle footprint into the grid.

    center: (2,) world; size: (2,) full extents; yaw: rotation.
    value=True paints obstacles, False clears (setFree analogue).
    """
    h, w = occ.shape
    lower, center, dtype = _as_tensors(occ, lower, center)
    xs, ys = _cell_centers(h, w, lower, res, dtype)
    dx = xs - center[0]
    dy = ys - center[1]
    yaw = torch.as_tensor(yaw, dtype=dtype, device=occ.device)
    c, s = torch.cos(yaw), torch.sin(yaw)
    u = c * dx + s * dy
    v = -s * dx + c * dy
    inside = (torch.abs(u) <= size[0] / 2.0) & (torch.abs(v) <= size[1] / 2.0)
    return torch.where(inside, torch.as_tensor(value, device=occ.device), occ)


def paint_circle(occ, lower, res, center, radius, value=True):
    h, w = occ.shape
    lower, center, dtype = _as_tensors(occ, lower, center)
    xs, ys = _cell_centers(h, w, lower, res, dtype)
    inside = (xs - center[0]) ** 2 + (ys - center[1]) ** 2 <= radius ** 2
    return torch.where(inside, torch.as_tensor(value, device=occ.device), occ)


def random_boxes(generator: torch.Generator, occ, lower, res, n_boxes: int,
                 size_range=(0.4, 1.2), margin: float = 1.0):
    """Random rectangular obstacles (global_map method 2 analogue).  Each
    box draws center x, center y, size x, size y and yaw, in that order,
    from `generator` (host draws; `jax.random` streams are not
    reproduced)."""
    h, w = occ.shape
    lower = [float(v) for v in lower]
    upper = (lower[0] + h * res, lower[1] + w * res)
    for _ in range(n_boxes):
        r = torch.rand(5, generator=generator, dtype=torch.float64,
                       device=generator.device).tolist()
        cx = lower[0] + margin + r[0] * (upper[0] - lower[0] - 2 * margin)
        cy = lower[1] + margin + r[1] * (upper[1] - lower[1] - 2 * margin)
        sx = size_range[0] + r[2] * (size_range[1] - size_range[0])
        sy = size_range[0] + r[3] * (size_range[1] - size_range[0])
        yaw = r[4] * 3.14159
        occ = paint_rect(occ, lower, res, (cx, cy), (sx, sy), yaw)
    return occ


def occupancy_from_png(path: str, threshold: int = 127,
                       dark_is_occupied: bool = True):
    """Load an occupancy grid from a PNG image (global_map method 3,
    utils/simulator/src/global_map.cpp get_grid_from_png).

    Minimal stdlib decoder: non-interlaced 8-bit grayscale / RGB /
    palette-less PNGs (the format map editors export).  Returns a bool
    numpy array with x along axis 0 (image rows -> map x).
    """
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    ihdr = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    w, h, bit_depth, color_type, _, _, interlace = ihdr
    assert bit_depth == 8 and interlace == 0, "only 8-bit non-interlaced"
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    img = np.zeros((h, w), np.uint8)
    prev = np.zeros(stride, np.uint8)
    off = 0
    for row in range(h):
        filt = raw[off]
        line = np.frombuffer(raw[off + 1:off + 1 + stride],
                             np.uint8).astype(np.int32)
        off += 1 + stride
        out = np.zeros(stride, np.int32)
        pv = prev.astype(np.int32)
        if filt == 0:
            out = line
        elif filt == 2:      # Up
            out = (line + pv) % 256
        elif filt in (1, 3, 4):  # Sub / Average / Paeth need a scan
            for i in range(stride):
                a = out[i - channels] if i >= channels else 0
                b = pv[i]
                c = pv[i - channels] if i >= channels else 0
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                out[i] = (line[i] + pred) % 256
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        prev = out.astype(np.uint8)
        img[row] = prev.reshape(w, channels)[:, 0] if channels > 1 \
            else prev
    occ = img < threshold if dark_is_occupied else img >= threshold
    return occ


def occupancy_from_pcd(path: str, lower, res, shape):
    """Occupancy from an ASCII PCD point cloud (global_map method 4,
    get_grid_from_pcd): each point stamps its cell occupied."""
    import numpy as np

    pts = []
    with open(path) as f:
        in_data = False
        for line in f:
            if in_data:
                vals = line.split()
                if len(vals) >= 2:
                    pts.append((float(vals[0]), float(vals[1])))
            elif line.startswith("DATA"):
                assert "ascii" in line, "only ascii PCD"
                in_data = True
    occ = np.zeros(shape, bool)
    H, W = shape
    for x, y in pts:
        i = int((x - lower[0]) / res)
        j = int((y - lower[1]) / res)
        if 0 <= i < H and 0 <= j < W:
            occ[i, j] = True
    return occ
