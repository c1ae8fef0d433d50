"""OctoMap file interchange (.bt / .ot) for the dense voxel map (port of
world/octomap_io.py; host numpy).

The reference vendors the full OctoMap library and its tools exchange
maps as `.bt` (binary, max-likelihood occupancy) and `.ot` (full
log-odds) files.  This module serializes/deserializes the port's dense
`world/voxel_map.py` state to those formats so reference-produced maps
load here and the port's maps open in octomap tooling (octovis, the
vendored bin/ examples).  The grids may be numpy arrays or tensors on
any device (they come to the host once); `write_voxel_map` writes a
`VoxelMapState`.  The files are byte for byte the JAX package's.

Format (clean-room from the writer/reader behavior in the vendored
sources, octomap/src/AbstractOccupancyOcTree.cpp:72-100 and
octomap/include/octomap/OccupancyOcTreeBase.hxx:940-1040):

  .bt: ASCII header ("# Octomap OcTree binary file", id, size, res,
       data) then a pre-order recursion from the root; each inner node
       is 16 bits -- 2 bits per child i (x = bit 0 of i, y = bit 1,
       z = bit 2; OcTreeKey.h computeChildIdx):
         00 no child (unknown), 01 occupied leaf, 10 free leaf,
         11 child is inner (recurse).
       Bit k of each byte is 1 << k; children 0-3 in byte 1, 4-7 in
       byte 2.  Leaves at any depth (octomap prunes 8 identical
       children into the parent before writing).
  .ot: ASCII header ("# Octomap OcTree file", id, size, res, data)
       then pre-order: per node a little-endian f32 log-odds
       (OcTreeDataNode::writeData) + one child-allocated bitmask byte
       (OcTreeBaseImpl.hxx writeNodesRecurs), recursing into allocated
       children.

Key space: depth-16 tree, coordToKey = floor(coord / res) + 32768
(tree_max_val); node at depth d selects children with key bit 15 - d.

Interop is pinned against the REAL vendored library: the oracle in
tests/golden/octomap_oracle links liboctomap.a, reads these files, and
writes files read back here (tests/test_torch_octomap_io.py, where the
reference tree is present).
"""
from __future__ import annotations

import math
import struct
from typing import NamedTuple, Optional

import numpy as np
import torch

from .voxel_map import VoxelMapConfig, VoxelMapState, occupied_mask

TREE_MAX_VAL = 32768          # depth-16 key offset
TREE_DEPTH = 16
BT_HEADER = "# Octomap OcTree binary file"
OT_HEADER = "# Octomap OcTree file"

# octomap OcTreeNode max-likelihood log-odds (clamping thresholds,
# AbstractOccupancyOcTree ctor: clampingThresMin/Max 0.1192 / 0.971)
_LO_OCC = math.log(0.971 / (1.0 - 0.971))
_LO_FREE = math.log(0.1192 / (1.0 - 0.1192))


class _Node:
    __slots__ = ("children", "occupied", "log_odds")

    def __init__(self):
        self.children = [None] * 8     # _Node or ("leaf", occupied, lo)
        self.occupied: Optional[bool] = None
        self.log_odds: float = 0.0


class OctomapTree(NamedTuple):
    """Parsed file: resolution + leaf boxes in key space.

    boxes: list of (key_min (3,) int, size int, occupied bool,
    log_odds float) -- each an axis-aligned cube of `size` leaf voxels.
    """
    res: float
    boxes: list

    def to_dense(self, lower, shape):
        """Rasterize into (X, Y, Z) (occupied, known) boolean grids whose
        voxel (i, j, k) is centered at lower + (idx + 0.5) * res."""
        key0 = _grid_key0(lower, self.res)
        occ = np.zeros(shape, bool)
        known = np.zeros(shape, bool)
        for kmin, size, is_occ, _ in self.boxes:
            lo = np.maximum(np.asarray(kmin) - key0, 0)
            hi = np.minimum(np.asarray(kmin) + size - key0, shape)
            if np.any(hi <= lo):
                continue
            sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
            known[sl] = True
            occ[sl] = is_occ
        return occ, known


def _grid_key0(lower, res):
    """Key of voxel (0,0,0): center coord -> coordToKey."""
    lower = np.asarray(lower, float)
    return np.floor(lower / res + 0.5).astype(np.int64) + TREE_MAX_VAL


def _build_tree(keys: np.ndarray, occ: np.ndarray,
                log_odds: Optional[np.ndarray]) -> _Node:
    """Sparse octree from leaf voxels, pruning equal-occupancy octants
    (octomap prune() semantics on max-likelihood data)."""

    def build(depth, idx):
        bit = TREE_DEPTH - 1 - depth
        node = _Node()
        child_of = (((keys[idx, 0] >> bit) & 1)
                    | (((keys[idx, 1] >> bit) & 1) << 1)
                    | (((keys[idx, 2] >> bit) & 1) << 2))
        for c in range(8):
            sub = idx[child_of == c]
            if sub.size == 0:
                continue
            if depth + 1 == TREE_DEPTH:
                lo = float(log_odds[sub[0]]) if log_odds is not None \
                    else (_LO_OCC if occ[sub[0]] else _LO_FREE)
                node.children[c] = ("leaf", bool(occ[sub[0]]), lo)
            else:
                node.children[c] = build(depth + 1, sub)
        # prune: 8 identical leaves collapse into one leaf
        kids = node.children
        if all(isinstance(k, tuple) for k in kids):
            if all(k[1] == kids[0][1] and k[2] == kids[0][2]
                   for k in kids[1:]):
                return ("leaf", kids[0][1], kids[0][2])
        return node

    root = build(0, np.arange(keys.shape[0]))
    if isinstance(root, tuple):      # fully uniform map
        n = _Node()
        n.children[0] = root
        return n
    return root


def _count_nodes(node) -> int:
    if isinstance(node, tuple):
        return 1
    return 1 + sum(_count_nodes(c) for c in node.children
                   if c is not None)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _voxels_from_dense(occupied, known, lower, res, log_odds=None):
    occupied = _host(occupied).astype(bool)
    known = _host(known).astype(bool) if known is not None \
        else np.ones_like(occupied)
    idx = np.argwhere(known)
    keys = idx + _grid_key0(_host(lower), res)[None, :]
    occ = occupied[known]
    lo = _host(log_odds)[known] if log_odds is not None else None
    return keys.astype(np.int64), occ, lo


# --------------------------------------------------------------------------
# .bt
# --------------------------------------------------------------------------

def write_bt(path, occupied, known, lower, res, tree_id="OcTree"):
    """Write a .bt file from dense boolean grids.

    occupied/known: (X, Y, Z) arrays; voxel (i,j,k) centered at
    lower + (idx+0.5)*res.  Unknown voxels (known=False) are omitted
    (octomap's unknown space)."""
    keys, occ, _ = _voxels_from_dense(occupied, known, lower, res)
    if keys.shape[0] == 0:
        raise ValueError("empty map (no known voxels)")
    root = _build_tree(keys, occ, None)

    out = bytearray()

    def emit(node: _Node):
        b1 = 0
        b2 = 0
        for i in range(8):
            c = node.children[i]
            if c is None:
                code = 0
            elif isinstance(c, _Node):
                code = 3                     # 11: inner
            elif c[1]:
                code = 2                     # 01: occupied (hi bit)
            else:
                code = 1                     # 10: free (lo bit)
            if i < 4:
                b1 |= code << (2 * i)
            else:
                b2 |= code << (2 * (i - 4))
        out.append(b1 & 0xFF)
        out.append(b2 & 0xFF)
        for i in range(8):
            c = node.children[i]
            if isinstance(c, _Node):
                emit(c)

    emit(root)
    header = (f"{BT_HEADER}\n#\n"
              f"id {tree_id}\n"
              f"size {_count_nodes(root)}\n"
              f"res {float(res):.17g}\n"
              f"data\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(bytes(out))


def read_bt(path) -> OctomapTree:
    with open(path, "rb") as f:
        res = _read_header(f, BT_HEADER)
        data = f.read()

    boxes = []
    pos = 0

    def parse(depth, key_min):
        nonlocal pos
        b1, b2 = data[pos], data[pos + 1]
        pos += 2
        half = 1 << (TREE_DEPTH - 1 - depth)
        for i in range(8):
            code = ((b1 >> (2 * i)) if i < 4 else (b2 >> (2 * (i - 4)))) & 3
            if code == 0:
                continue
            ck = key_min + half * np.array([i & 1, (i >> 1) & 1,
                                            (i >> 2) & 1])
            if code == 3:
                parse(depth + 1, ck)
            else:
                is_occ = code == 2
                boxes.append((ck.copy(), half,
                              is_occ, _LO_OCC if is_occ else _LO_FREE))

    parse(0, np.zeros(3, np.int64))
    return OctomapTree(res=res, boxes=boxes)


# --------------------------------------------------------------------------
# .ot
# --------------------------------------------------------------------------

def write_ot(path, occupied, known, lower, res, log_odds=None,
             tree_id="OcTree"):
    """Write a full .ot file; per-leaf log-odds from `log_odds` (same
    shape as occupied) or max-likelihood values when omitted.  Inner
    nodes carry the max of their children (octomap's default
    updateOccupancyChildren)."""
    keys, occ, lo = _voxels_from_dense(occupied, known, lower, res,
                                       log_odds)
    if keys.shape[0] == 0:
        raise ValueError("empty map (no known voxels)")
    root = _build_tree(keys, occ, lo)

    out = bytearray()

    def node_lo(node):
        if isinstance(node, tuple):
            return node[2]
        return max(node_lo(c) for c in node.children if c is not None)

    def emit(node):
        out.extend(struct.pack("<f", node_lo(node)))
        if isinstance(node, tuple):
            out.append(0)
            return
        mask = 0
        for i in range(8):
            if node.children[i] is not None:
                mask |= 1 << i
        out.append(mask)
        for i in range(8):
            if node.children[i] is not None:
                emit(node.children[i])

    emit(root)
    header = (f"{OT_HEADER}\n#\n"
              f"id {tree_id}\n"
              f"size {_count_nodes(root)}\n"
              f"res {float(res):.17g}\n"
              f"data\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(bytes(out))


def read_ot(path, occ_threshold=0.0) -> OctomapTree:
    with open(path, "rb") as f:
        res = _read_header(f, OT_HEADER)
        data = f.read()

    boxes = []
    pos = 0

    def parse(depth, key_min):
        nonlocal pos
        (lo,) = struct.unpack_from("<f", data, pos)
        mask = data[pos + 4]
        pos += 5
        if mask == 0:
            size = 1 << (TREE_DEPTH - depth)
            boxes.append((key_min.copy(), size, lo > occ_threshold, lo))
            return
        half = 1 << (TREE_DEPTH - 1 - depth)
        for i in range(8):
            if mask & (1 << i):
                ck = key_min + half * np.array([i & 1, (i >> 1) & 1,
                                                (i >> 2) & 1])
                parse(depth + 1, ck)

    parse(0, np.zeros(3, np.int64))
    return OctomapTree(res=res, boxes=boxes)


def write_voxel_map(path, state: VoxelMapState, lower, res,
                    cfg: VoxelMapConfig = VoxelMapConfig(),
                    tree_id="OcTree"):
    """A voxel map state as `.bt` (max-likelihood occupancy) or `.ot`
    (its log-odds), by the suffix of `path`; unknown voxels omitted."""
    occ = occupied_mask(state, cfg)
    if str(path).endswith(".bt"):
        write_bt(path, occ, state.known, lower, res, tree_id)
    elif str(path).endswith(".ot"):
        write_ot(path, occ, state.known, lower, res, state.log_odds, tree_id)
    else:
        raise ValueError(f"{path}: not a .bt or .ot path")


def _read_header(f, expect_first) -> float:
    first = f.readline().decode().rstrip("\n")
    if not first.startswith(expect_first):
        raise ValueError(f"not an octomap file (got {first!r})")
    res = None
    while True:
        line = f.readline().decode()
        if not line:
            raise ValueError("truncated octomap header")
        line = line.strip()
        if line.startswith("#") or not line:
            continue
        if line.startswith("res "):
            res = float(line.split()[1])
        elif line == "data":
            return res
        elif line.split()[0] not in ("id", "size"):
            raise ValueError(f"unexpected header line {line!r}")
