"""Port parity: the dense voxel map (`world/voxel_map.py`).

Every function of the JAX package's voxel map against the port's on
clouds and grids drawn from a numpy seed, on the CPU, at float64 and at
the float32 default (the map origin given as numpy float64, as the JAX
tests give it): the log-odds and known grids after each insertion equal
(the scatters are max reductions, so the duplicate voxels of a cloud
land the same whatever the order), `cast_rays` hits, ranges and end
voxels equal, pyramids, depth queries, bbox queries, extrusions, exports
and voxel indices equal.  Then the camera's depth frame through
`cloud_for_mapping` -> `insert_point_cloud` -> `cast_rays`
(tests/test_camera.py's mapping scene) equal in both packages, and that
test's checks on the port: front face occupied, corridor free, the
volume behind unknown.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.world import camera as jc
from alore_legged_manipulator_tpu.world import voxel_map as jv
from alore_legged_manipulator_tpu_torch.world import camera as tc
from alore_legged_manipulator_tpu_torch.world import voxel_map as tv

LOWER = np.array([0.0, 0.0, 0.0])
RES = 0.1
SHAPE = (32, 32, 16)
DTYPES = [(jnp.float64, torch.float64), (jnp.float32, torch.float32)]
IDS = ["f64", "f32"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_state(ts, js):
    np.testing.assert_array_equal(_np(ts.log_odds), _np(js.log_odds))
    np.testing.assert_array_equal(_np(ts.known), _np(js.known))


def _clouds(rng, n_clouds=4, n_pts=60):
    out = []
    for _ in range(n_clouds):
        origin = rng.uniform([0.3, 0.3, 0.3], [2.9, 2.9, 1.2])
        pts = origin + rng.normal(0, 1.2, (n_pts, 3))
        pts[: n_pts // 6] = origin + rng.normal(0, 4.0, (n_pts // 6, 3))
        out.append((origin, pts))
    return out


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
@pytest.mark.parametrize("max_range", [-1.0, 1.5])
def test_insert_and_cast_match_jax(jdt, tdt, max_range):
    rng = np.random.default_rng(0)
    cfg = jv.VoxelMapConfig(n_steps=64)
    js = jv.voxel_map_init(SHAPE, cfg, jdt)
    ts = tv.voxel_map_init(SHAPE, tv.VoxelMapConfig(n_steps=64), tdt,
                           device="cpu")
    for origin, pts in _clouds(rng):
        js = jv.insert_point_cloud(js, LOWER, RES, origin, pts, max_range,
                                   cfg)
        ts = tv.insert_point_cloud(ts, LOWER, RES, origin, pts, max_range,
                                   tv.VoxelMapConfig(n_steps=64))
        _same_state(ts, js)
    assert _np(ts.known).sum() > 100
    np.testing.assert_array_equal(_np(tv.occupied_mask(ts)),
                                  _np(jv.occupied_mask(js)))
    dirs = rng.normal(size=(200, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origin = np.array([1.6, 1.6, 0.8])
    jh, jr, jvox = jv.cast_rays(js, LOWER, RES, origin, dirs, 2.5, cfg)
    th, tr, tvox = tv.cast_rays(ts, LOWER, RES, origin, dirs, 2.5,
                                tv.VoxelMapConfig(n_steps=64))
    np.testing.assert_array_equal(_np(th), _np(jh))
    np.testing.assert_array_equal(_np(tr), _np(jr))
    np.testing.assert_array_equal(_np(tvox), _np(jvox))
    assert 0 < _np(th).sum() < len(dirs)


def test_queries_and_exports_match_jax():
    rng = np.random.default_rng(1)
    occ = rng.random(SHAPE) < 0.03
    js, ts = jv.state_from_occupied(occ), tv.state_from_occupied(occ)
    _same_state(ts, js)
    assert ts.log_odds.dtype == torch.float32
    for jl, tl in zip(jv.pyramid(js, 3), tv.pyramid(ts, 3)):
        np.testing.assert_array_equal(_np(tl), _np(jl))
    for idx in [(7, 3, 1), (0, 0, 0), (31, 31, 15), (16, 9, 4)]:
        for level in (0, 1, 2, 3):
            assert bool(tv.occupancy_at_depth(ts, level, idx)) == \
                bool(jv.occupancy_at_depth(js, level, idx))
    np.testing.assert_array_equal(
        tv.bbx_occupied(ts, LOWER, RES, [0.5, 0.2, 0.1], [2.2, 2.9, 1.0]),
        jv.bbx_occupied(js, LOWER, RES, [0.5, 0.2, 0.1], [2.2, 2.9, 1.0]))
    yaw = math.pi / 3
    Rz = np.array([[math.cos(yaw), -math.sin(yaw), 0],
                   [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]])
    np.testing.assert_array_equal(
        tv.to_point_cloud(ts, LOWER, RES, Rz, [0.1, 0.0, 0.95]),
        jv.to_point_cloud(js, LOWER, RES, Rz, [0.1, 0.0, 0.95]))
    occ2d = rng.random((8, 9)) < 0.2
    np.testing.assert_array_equal(_np(tv.from_grid_map(occ2d, 10)),
                                  _np(jv.from_grid_map(occ2d, 10)))
    pts = rng.uniform(-0.5, 3.5, (50, 3))
    np.testing.assert_array_equal(
        _np(tv.world_to_voxel(LOWER, RES, torch.as_tensor(pts))),
        _np(jv.world_to_voxel(LOWER, RES, pts)))
    idx = rng.integers(0, 30, (5, 3))
    np.testing.assert_array_equal(_np(tv.voxel_center(LOWER, RES, idx)),
                                  _np(jv.voxel_center(LOWER, RES, idx)))


def test_camera_cloud_builds_the_same_map():
    """tests/test_camera.py::test_depth_cloud_builds_voxel_map in both
    packages: rendered depth -> mapping cloud -> voxel map -> rays."""
    boxes = np.asarray([(3.0, 0.0, 0.0, 0.4, 1.0, 2.0, 1)], np.float32)
    maps = {}
    for lib, vm, mk in (
            (jc, jv, lambda a: jnp.asarray(a)),
            (tc, tv, lambda a: torch.as_tensor(a))):
        cam = lib.CameraModel(fx=50.0, fy=50.0, cx=32.0, cy=24.0, width=64,
                              height=48)
        scene = lib.BoxScene(center=mk(boxes[:, 0:2]), yaw=mk(boxes[:, 2]),
                             half_ext=mk(boxes[:, 3:5]),
                             height=mk(boxes[:, 5]),
                             sem_id=mk(boxes[:, 6].astype(np.int32)))
        kw = {} if lib is jc else dict(device="cpu")
        R, t = lib.pose_matrix((0.0, 0.0, 1.0), lib.ROBOT_CAM_RPY,
                               **({} if lib is jc else
                                  dict(dtype=torch.float64, device="cpu")))
        depth, _ = lib.render(cam, R, t, scene, max_range=8.0)
        pts = lib.cloud_for_mapping(cam, R, t, depth, far=12.0)
        lower = np.asarray([-1.0, -4.0, -1.0])
        st = vm.voxel_map_init((40, 40, 20), **kw)
        st = vm.insert_point_cloud(st, lower, 0.2, _np(t), pts,
                                   max_range=9.0)
        dirs = np.asarray([[1.0, 0.0, 0.0], [0.8, 0.6, 0.0],
                           [0.0, 0.0, 1.0], [0.6, -0.8, 0.0]])
        rays = vm.cast_rays(st, lower, 0.2, _np(t), dirs, 6.0)
        maps[lib.__name__] = (st, [_np(r) for r in rays], _np(pts))
    (js, jrays, jpts), (ts, trays, tpts) = maps[jc.__name__], \
        maps[tc.__name__]
    np.testing.assert_allclose(tpts, jpts, rtol=0, atol=1e-12)
    _same_state(ts, js)
    for a, b in zip(trays, jrays):
        np.testing.assert_array_equal(a, b)
    assert trays[0][0] and not trays[0][2]        # the box ahead, not up
    occ = _np(tv.occupied_mask(ts))
    lower = np.asarray([-1.0, -4.0, -1.0])

    def vox(x, y, z):
        return tuple(int(v) for v in ((np.array([x, y, z]) - lower) / 0.2))

    assert occ[vox(2.59, 0.05, 1.05)]                 # front face occupied
    assert float(ts.log_odds[vox(1.5, 0.0, 1.0)]) < 0.0      # free corridor
    assert float(ts.log_odds[vox(4.5, 0.0, 1.0)]) == 0.0     # unknown behind
