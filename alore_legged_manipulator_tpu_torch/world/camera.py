"""Synthetic pinhole camera: batched depth + semantic + color rendering
(port of world/camera.py).

The reference's Isaac bridge publishes color / depth / semantic /
depth-cloud camera topics (Simulation/isaac_b2_controller/ros1/
b2z1_ros1_bridge.py:31-600) that feed the YOLO object detector
(Deployment/perception/yolo_pose.py) and AprilTag PnP.  This module
renders those products directly from the planar scene description: every
world box (obstacle footprints and object bodies, extruded to a height)
is intersected analytically with each pixel ray.  The JAX package vmaps
a per-pixel function over the pixels; here the pixels are a leading axis
and the boxes a second one, so one render is one batched (pixels x
boxes) slab test of elementwise operations, with no data-dependent
control flow and no per-pixel Python.

Products:
  * depth image (H, W), +inf where the ray escapes,
  * semantic image (H, W) int32 (`SKY`/`GROUND` or box semantic id),
  * color image (H, W, 3) and the per-class masks recovered from it,
  * depth -> point-cloud unprojection (the depth_cloud topic),
  * bbox extraction for a semantic id (what the YOLO detector's image
    branch consumes).

Camera convention: OpenCV pinhole -- +z optical axis forward, +x right,
+y down; intrinsics (fx, fy, cx, cy).  The camera pose maps camera
coordinates to world coordinates.  Every function computes on the
device and in the dtype of its tensor inputs; `pose_matrix` from plain
numbers takes them as arguments.  `argmin` / `argmax` return the first
extremum, as in JAX: a pixel whose rays miss every box picks box 0 and
is then labelled `SKY` or `GROUND`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.precision import resolve_device

SKY = -1
GROUND = 0


class CameraModel(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class BoxScene(NamedTuple):
    """K extruded boxes: planar OBB footprint + [0, height] extrusion.

    `sem_id` >= 1 (0 is reserved for the ground plane).
    """
    center: torch.Tensor    # (K, 2) footprint center (world)
    yaw: torch.Tensor       # (K,)
    half_ext: torch.Tensor  # (K, 2)
    height: torch.Tensor    # (K,)
    sem_id: torch.Tensor    # (K,) int32


def camera_rays(cam: CameraModel, dtype=torch.float32, device=None):
    """Unit ray directions in the camera frame, (H, W, 3)."""
    dev = resolve_device(device)
    u = torch.arange(cam.width, dtype=dtype, device=dev) + 0.5
    v = torch.arange(cam.height, dtype=dtype, device=dev) + 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                     torch.ones_like(uu)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def pose_matrix(xyz, rpy, dtype=None, device=None):
    """World-from-camera SE(3) from position + roll/pitch/yaw (ZYX).

    Entries may be numbers or 0-d tensors; the result takes the dtype and
    device of the first tensor among them, else `dtype` (None: float32)
    on `device` (None: the card)."""
    tensors = [x for x in (*xyz, *rpy) if isinstance(x, torch.Tensor)]
    if tensors:
        dtype = dtype or tensors[0].dtype
        dev = tensors[0].device
    else:
        dtype = dtype or torch.float32
        dev = resolve_device(device)
    r, p, y = (torch.as_tensor(a, dtype=dtype, device=dev) for a in rpy)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    zero, one = torch.zeros_like(r), torch.ones_like(r)
    Rz = torch.stack([torch.stack([cy, -sy, zero]),
                      torch.stack([sy, cy, zero]),
                      torch.stack([zero, zero, one])])
    Ry = torch.stack([torch.stack([cp, zero, sp]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sp, zero, cp])])
    Rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cr, -sr]),
                      torch.stack([zero, sr, cr])])
    R = Rz @ Ry @ Rx
    return R, torch.stack([torch.as_tensor(a, dtype=dtype, device=dev)
                           for a in xyz])


ROBOT_CAM_RPY = (-math.pi / 2, 0.0, -math.pi / 2)  # look along +x, z-up


def _slabs(o, d, scene: BoxScene):
    """Slab test of the rays o + t d (d: (P, 3)) against every box.

    Returns (t (P, K): t of the first intersection with the box volume,
    +inf if missed; near (P, K, 3): the entry slab distances; dd (P, K, 3):
    the ray in each box's frame; c, s (K,): the boxes' yaw)."""
    c, s = torch.cos(scene.yaw), torch.sin(scene.yaw)
    # world -> box frame (rotate xy by -yaw, z unchanged)
    rx = o[0] - scene.center[:, 0]
    ry = o[1] - scene.center[:, 1]
    ox = c * rx + s * ry
    oy = -s * rx + c * ry
    dx = c * d[:, None, 0] + s * d[:, None, 1]
    dy = -s * d[:, None, 0] + c * d[:, None, 1]
    he = scene.half_ext
    lo = torch.stack([-he[:, 0], -he[:, 1], torch.zeros_like(scene.height)],
                     dim=-1)                                   # (K, 3)
    hi = torch.stack([he[:, 0], he[:, 1], scene.height], dim=-1)
    oo = torch.stack([ox, oy, o[2].expand_as(ox)], dim=-1)     # (K, 3)
    dd = torch.stack([dx, dy, d[:, None, 2].expand_as(dx)], dim=-1)
    tiny = torch.where(dd < 0, -1e-12, 1e-12)
    inv = 1.0 / torch.where(torch.abs(dd) < 1e-12, tiny, dd)
    t1 = (lo - oo) * inv
    t2 = (hi - oo) * inv
    near = torch.minimum(t1, t2)
    tmin = torch.amax(near, dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t = torch.where(tmin > 0.0, tmin, tmax)   # inside the box: exit face
    t = torch.where(hit & (t > 0.0), t, torch.full_like(t, math.inf))
    return t, near, dd, c, s


def _first_box(o, d, scene: BoxScene):
    """Nearest box along each ray and the ground plane z=0: (t_box (P,),
    k (P,), t_gnd (P,), slab terms)."""
    ts, near, dd, c, s = _slabs(o, d, scene)
    k = torch.argmin(ts, dim=1)
    t_box = torch.gather(ts, 1, k[:, None])[:, 0]
    t_gnd = torch.where(d[:, 2] < -1e-9, -o[2] / d[:, 2],
                        torch.full_like(t_box, math.inf))
    return t_box, k, t_gnd, (near, dd, c, s)


def _world_rays(cam: CameraModel, R):
    rays_c = camera_rays(cam, R.dtype, R.device)              # (H, W, 3)
    return torch.einsum("ij,hwj->hwi", R, rays_c).reshape(-1, 3)


def render(cam: CameraModel, R, t, scene: BoxScene, max_range=20.0):
    """Render (depth, semantic) for a camera at world-from-camera (R, t).

    depth is along the RAY (range image); use `depth_to_z` for the
    OpenCV z-depth convention if needed.
    """
    d = _world_rays(cam, R)
    t_box, k, t_gnd, _ = _first_box(t, d, scene)
    sem_box = scene.sem_id[k]
    t_best = torch.minimum(t_box, t_gnd)
    sem = torch.where(t_box <= t_gnd, sem_box, torch.full_like(sem_box,
                                                               GROUND))
    missed = torch.isinf(t_best) | (t_best > max_range)
    sem = torch.where(missed, torch.full_like(sem, SKY), sem)
    depth = torch.where(missed, torch.full_like(t_best, math.inf), t_best)
    return (depth.reshape(cam.height, cam.width),
            sem.reshape(cam.height, cam.width).to(torch.int32))


def depth_to_z(cam: CameraModel, depth):
    """Range image -> OpenCV z-depth (distance along the optical axis)."""
    rays = camera_rays(cam, depth.dtype, depth.device)
    return depth * rays[..., 2]


# ---------------------------------------------------------------------------
# color rendering (the Isaac bridge's color camera topic,
# Simulation/isaac_b2_controller/ros1/b2z1_ros1_bridge.py:31-600)
# ---------------------------------------------------------------------------

# distinct per-class albedo palette (index = sem_id; 0 = ground).
# Chromaticities are deliberately far apart so a shading-invariant
# color classifier can separate classes (see color_class_masks).
CLASS_ALBEDO = (
    (0.45, 0.42, 0.38),   # 0 ground (warm grey)
    (0.85, 0.20, 0.15),   # 1 red
    (0.15, 0.55, 0.85),   # 2 blue
    (0.20, 0.75, 0.25),   # 3 green
    (0.85, 0.70, 0.15),   # 4 yellow
    (0.70, 0.20, 0.75),   # 5 magenta
    (0.15, 0.75, 0.70),   # 6 teal
    (0.90, 0.45, 0.10),   # 7 orange
)
SKY_COLOR = (0.60, 0.75, 0.95)
LIGHT_DIR = (0.35, 0.25, -0.90)     # world-frame sun direction


def render_color(cam: CameraModel, R, t, scene: BoxScene,
                 max_range=20.0, albedo=None):
    """Render an (H, W, 3) RGB image in [0, 1]: per-class albedo +
    Lambert face shading + sky fill -- the Isaac bridge's color topic
    analogue for the box world.  Shading is a scalar multiple of the
    albedo, so chromaticity identifies the class (color_class_masks)."""
    z = dict(dtype=R.dtype, device=R.device)
    alb = torch.as_tensor(albedo if albedo is not None else CLASS_ALBEDO,
                          **z)
    sky = torch.tensor(SKY_COLOR, **z)
    light = torch.tensor(LIGHT_DIR, **z)
    light = light / torch.linalg.vector_norm(light)
    d = _world_rays(cam, R)
    t_box, k, t_gnd, (near, dd, c, s) = _first_box(t, d, scene)
    # the entry face's normal of the nearest box, box frame -> world
    axis = torch.argmax(near, dim=-1)                    # (P, K) entry slab
    n_box = -torch.sign(dd) * torch.nn.functional.one_hot(axis, 3).to(
        dd.dtype)
    n_w = torch.stack([c * n_box[..., 0] - s * n_box[..., 1],
                       s * n_box[..., 0] + c * n_box[..., 1],
                       n_box[..., 2]], dim=-1)           # (P, K, 3)
    n_w = torch.gather(n_w, 1, k[:, None, None].expand(-1, 1, 3))[:, 0]
    sem_box = scene.sem_id[k]
    box_first = t_box <= t_gnd
    t_best = torch.minimum(t_box, t_gnd)
    n = torch.where(box_first[:, None], n_w, torch.tensor([0.0, 0.0, 1.0],
                                                          **z))
    sem = torch.where(box_first, sem_box, torch.zeros_like(sem_box))
    # sem ids beyond the palette wrap over the non-ground entries
    n_obj_colors = alb.shape[0] - 1
    idx = torch.where(sem > 0, 1 + (sem - 1) % n_obj_colors,
                      torch.zeros_like(sem))
    base = alb[idx.long()]
    shade = 0.35 + 0.65 * torch.clamp(-(n @ light), min=0.0)
    rgb = base * shade[:, None]
    missed = torch.isinf(t_best) | (t_best > max_range)
    rgb = torch.where(missed[:, None], sky, rgb)
    return rgb.reshape(cam.height, cam.width, 3)


def color_class_masks(rgb, n_classes, albedo=None, tol=0.08):
    """Shading-invariant per-class pixel masks from an RGB frame.

    Lambert shading scales the albedo by a scalar, so the NORMALIZED
    color (chromaticity) survives shading exactly; a pixel belongs to
    class k when its chromaticity sits within `tol` of class k's and
    closer than to any other palette entry (incl. ground and sky).
    Returns (n_classes, H, W) bool for sem ids 1..n_classes -- the
    detector input the YOLO node's bbox path consumes
    (runtime/camera_perception.py).
    """
    z = dict(dtype=rgb.dtype, device=rgb.device)
    alb = torch.as_tensor(albedo if albedo is not None else CLASS_ALBEDO,
                          **z)
    cand = torch.cat([alb, torch.tensor([SKY_COLOR], **z)], 0)
    cn = cand / torch.linalg.vector_norm(cand, dim=-1, keepdim=True)
    pn = rgb / torch.clamp(torch.linalg.vector_norm(rgb, dim=-1,
                                                    keepdim=True), min=1e-9)
    d = torch.linalg.vector_norm(pn[:, :, None, :] - cn, dim=-1)
    nearest = torch.argmin(d, dim=-1)                     # (H, W)
    close = torch.gather(d, -1, nearest[..., None])[..., 0] < tol
    k = torch.arange(1, n_classes + 1, device=rgb.device)
    return (nearest[None] == k[:, None, None]) & close[None]


def depth_cloud(cam: CameraModel, R, t, depth, stride=1):
    """Unproject a depth image to a world-frame point cloud (P, 3) with a
    finite-mask (the bridge's depth-cloud topic)."""
    rays_c = camera_rays(cam, depth.dtype, depth.device)[::stride, ::stride]
    d = depth[::stride, ::stride]
    pts_c = rays_c * d[..., None]
    pts_w = torch.einsum("ij,hwj->hwi", R, pts_c) + t
    return pts_w.reshape(-1, 3), torch.isfinite(d).reshape(-1)


def cloud_for_mapping(cam: CameraModel, R, t, depth, far, stride=1):
    """Depth image -> endpoint cloud for voxel_map.insert_point_cloud.

    Misses (inf depth: sky or beyond max_range) are replaced with
    endpoints at `far` along the ray; used with
    insert_point_cloud(max_range < far) they carve free space and
    register no hit -- octomap's maxrange semantics for non-returns.
    """
    d = torch.where(torch.isfinite(depth), depth,
                    torch.full_like(depth, far))
    rays_c = camera_rays(cam, d.dtype, d.device)[::stride, ::stride]
    pts_c = rays_c * d[::stride, ::stride, None]
    pts_w = torch.einsum("ij,hwj->hwi", R, pts_c) + t
    return pts_w.reshape(-1, 3)


def semantic_bbox(sem, sem_id):
    """Pixel bbox (u_min, v_min, u_max, v_max, count) of a semantic id,
    0-d tensors.

    Branchless min/max over masked pixel coordinates; count==0 means the
    id is not visible (bbox values are then meaningless).  This is the
    detector-side input: the reference YOLO node consumes xyxy bboxes
    (yolo_pose.py:149-160).
    """
    H, W = sem.shape
    uu = torch.arange(W, device=sem.device).expand(H, W)
    vv = torch.arange(H, device=sem.device)[:, None].expand(H, W)
    m = sem == sem_id
    big = torch.iinfo(torch.int32).max
    u_min = torch.amin(torch.where(m, uu, big))
    v_min = torch.amin(torch.where(m, vv, big))
    u_max = torch.amax(torch.where(m, uu, -1))
    v_max = torch.amax(torch.where(m, vv, -1))
    return u_min, v_min, u_max, v_max, torch.sum(m)


def bbox_depth_mean(depth, sem, sem_id):
    """Mean depth over the semantic mask (the reference averages the
    depth crop inside the detection bbox, yolo_pose.py:167-173)."""
    m = (sem == sem_id) & torch.isfinite(depth)
    return torch.sum(torch.where(m, depth, torch.zeros_like(depth))) \
        / torch.clamp(torch.sum(m), min=1)
