"""Port parity: lidar scans and occupancy fusion (`world/lidar.py`).

* Every function against JAX on the same inputs (a 60x70 world of random
  boxes from numpy seed 0, poses inside and near the edge of the map):
  in float64 with host `lower`/`res` (as the mapped planner calls them)
  and in float32 with a float32 `lower` (as the planner simulation
  fuses).  Integer and boolean outputs (cells, masks, gridmaps, the
  first-hit ranges) are equal; float outputs agree to 1e-12 at float64
  and 1e-6 at float32 (libm's cos, sin and atan2 against XLA's: a beam's
  sample lattice is a product of them, and the gridmaps stay equal).
* The three fusion goldens of the compiled reference SDFmap
  (tests/golden/fusion, fusion_cirsup, fusion_persp) replayed through
  the port as tests/test_fusion_parity.py replays them through JAX: the
  gridmap cell for cell, the log odds to 1e-5.
* tests/test_lidar.py's and tests/test_lidar_modes.py's invariants on the
  port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.world import lidar as jl
from alore_legged_manipulator_tpu_torch.world import lidar as tl
from tests.test_fusion_parity import _load as load_golden

torch.set_num_threads(1)

SHAPE = (60, 70)
RES = 0.1


def _world():
    rng = np.random.default_rng(0)
    occ = np.zeros(SHAPE, bool)
    for _ in range(12):
        x, y = rng.integers(0, 55), rng.integers(0, 65)
        occ[x:x + rng.integers(1, 6), y:y + rng.integers(1, 6)] = True
    occ[30, 20:40] = True
    return occ


POSES = [(3.0, 3.5, 0.3), (0.35, 6.8, -2.0), (5.2, 1.1, 3.0)]


def _args(prec):
    """(lower, res, pose maker) as each caller passes them."""
    if prec == "f64":
        return ((0.0, 0.0), RES, (0.0, 0.0), RES,
                lambda p: (jnp.asarray(p, jnp.float64),
                           torch.tensor(p, dtype=torch.float64)))
    return (jnp.zeros(2, jnp.float32), RES, torch.zeros(2), RES,
            lambda p: (jnp.asarray(p, jnp.float32),
                       torch.tensor(p, dtype=torch.float32)))


TOL = {"f64": 1e-12, "f32": 1e-6}
PRECS = ["f64", "f32"]


def _eq(got, ref, tol=None, what=""):
    ref = np.asarray(ref)
    got = got.numpy()
    if tol is None or not np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("prec", PRECS)
def test_scan_and_points_match_jax(prec):
    occ = _world()
    jlow, jres, tlow, tres, mk = _args(prec)
    for pose in POSES:
        pj, pt = mk(pose)
        for cfg in (tl.LidarConfig(max_range=4.0),
                    tl.LidarConfig(n_beams=90, fov_rad=np.pi / 2,
                                   max_range=3.0, n_steps=64)):
            jcfg = jl.LidarConfig(*cfg)
            rj, hj = jl.lidar_scan(jnp.asarray(occ), jlow, jres, pj, jcfg)
            rt, ht = tl.lidar_scan(torch.as_tensor(occ), tlow, tres, pt, cfg)
            _eq(ht, hj)
            _eq(rt, rj, TOL[prec], "ranges")
            ptj, mj = jl.perspective_points(jnp.asarray(occ), jlow, jres, pj,
                                            jcfg)
            ptt, mt = tl.perspective_points(torch.as_tensor(occ), tlow, tres,
                                            pt, cfg)
            _eq(mt, mj)
            _eq(ptt[mt], np.asarray(ptj)[np.asarray(mj)], TOL[prec], "pts")


def test_bresenham_and_intbound_match_jax():
    rng = np.random.default_rng(1)
    start = np.array([20, 33], np.int32)
    ends = rng.integers(-5, 75, (200, 2)).astype(np.int32)
    cj, vj = jl._bresenham_trace(jnp.asarray(start), jnp.asarray(ends), 160)
    ct, vt = tl._bresenham_trace(torch.as_tensor(start), torch.as_tensor(ends),
                                 160)
    _eq(ct, cj)
    _eq(vt, vj)
    s = rng.uniform(-30, 30, 500)
    ds = rng.integers(-4, 5, 500).astype(np.int32)
    _eq(tl._intbound(torch.as_tensor(s), torch.as_tensor(ds)),
        jl._intbound(jnp.asarray(s), jnp.asarray(ds)), 1e-15)


@pytest.mark.parametrize("prec", PRECS)
def test_window_and_outliers_match_jax(prec):
    rng = np.random.default_rng(2)
    grid = rng.choice(np.array([0, 1, 2], np.uint8), SHAPE, p=[0.5, 0.4, 0.1])
    jlow, jres, tlow, tres, mk = _args(prec)
    for pose in POSES:
        pj, pt = mk(pose)
        _eq(tl._window_mask(SHAPE, tlow, tres, pt, 2.5),
            jl._window_mask(SHAPE, jlow, jres, pj, 2.5))
        cell = (int(pose[0] / RES), int(pose[1] / RES))
        cell_t = (torch.tensor(cell[0]), torch.tensor(cell[1]))
        _eq(tl._remove_outliers(torch.as_tensor(grid), tlow, tres, pt, 2.5,
                                cell_t),
            jl._remove_outliers(jnp.asarray(grid), jlow, jres, pj, 2.5, cell))


def _fused(mod, occ, lower, res, poses, prec, cir_sup, cfg_l, mapper, tsr):
    """Fuse scans from `poses` into a fresh map on one side."""
    ocfg = mod.OccupancyConfig()
    dt = jnp.float64 if (prec == "f64" and mod is jl) else \
        (torch.float64 if prec == "f64" else
         (jnp.float32 if mod is jl else torch.float32))
    kw = {} if mod is jl else dict(device="cpu")
    st = mod.occupancy_init(SHAPE, ocfg, dt, **kw)
    occ_w = tsr(occ)
    for i, p in enumerate(poses):
        r, h = mod.lidar_scan(occ_w, lower, res, p, cfg_l)
        st = mod.occupancy_update(st, lower, res, p, r, h, cfg_l, ocfg,
                                  cir_sup=cir_sup and i % 2 == 1)
        pts, m = mod.perspective_points(occ_w, lower, res, p, cfg_l)
        st = mod.occupancy_update_perspective(
            st, lower, res, p, mapper(pts, p), m.reshape(-1),
            cfg_l.max_range, ocfg)
    return st


def _to_world(lib):
    def f(pts, p):
        c, s = lib.cos(p[2]), lib.sin(p[2])
        px = p[0] + c * pts[..., 0] - s * pts[..., 1]
        py = p[1] + s * pts[..., 0] + c * pts[..., 1]
        return lib.stack([px.reshape(-1), py.reshape(-1)], -1)
    return f


@pytest.mark.parametrize("fov", [None, np.pi])
@pytest.mark.parametrize("prec", PRECS)
def test_fusion_matches_jax(prec, fov):
    occ = _world()
    jlow, jres, tlow, tres, mk = _args(prec)
    kw = {} if fov is None else dict(fov_rad=fov)
    cfg = tl.LidarConfig(max_range=3.0, **kw)
    poses = [mk(p) for p in POSES + [(2.0, 5.0, 1.0), (3.1, 3.4, 0.2)]]
    sj = _fused(jl, occ, jlow, jres, [p[0] for p in poses], prec, True,
                jl.LidarConfig(*cfg), _to_world(jnp), jnp.asarray)
    st = _fused(tl, occ, tlow, tres, [p[1] for p in poses], prec, True,
                cfg, _to_world(torch), torch.as_tensor)
    _eq(st.grid, sj.grid)
    _eq(st.known, sj.known)
    _eq(st.log_odds, sj.log_odds, TOL[prec], "log odds")
    assert int((st.grid == tl.OCCUPIED).sum()) > 20
    for a, b in zip(tl.occupancy_classes(st), jl.occupancy_classes(sj)):
        _eq(a, b)


@pytest.mark.parametrize("fov", [None, np.pi / 2])
@pytest.mark.parametrize("prec", PRECS)
def test_circular_support_matches_jax(prec, fov):
    occ = _world()
    jlow, jres, tlow, tres, mk = _args(prec)
    rng = np.random.default_rng(4)
    grid = np.where(occ, np.uint8(2), np.uint8(0))
    for pose in POSES:
        pj, pt = mk(pose)
        lo = rng.uniform(-2.2, 0.5, SHAPE)
        dt = jnp.float64 if prec == "f64" else jnp.float32
        sj = jl.OccupancyState(jnp.asarray(lo, dt), jnp.asarray(grid != 0),
                               jnp.asarray(grid))
        stt = tl.OccupancyState(torch.as_tensor(np.array(sj.log_odds)),
                                torch.as_tensor(grid != 0),
                                torch.as_tensor(grid))
        a = tl.circular_support_update(stt, tlow, tres, pt, 2.0,
                                       fov_rad=fov)
        b = jl.circular_support_update(sj, jlow, jres, pj, 2.0, fov_rad=fov)
        _eq(a.grid, b.grid)
        _eq(a.log_odds, b.log_odds, 0.0)


# ---- the compiled reference's goldens (tests/test_fusion_parity.py) ----

@pytest.mark.parametrize("name", ["fusion", "fusion_cirsup"])
def test_fusion_golden(name):
    (nx, ny, res, rng, n_beams, cir_sup, _), scans, gold_grid, gold_lo = \
        load_golden(name)
    lcfg = tl.LidarConfig(n_beams=n_beams, fov_rad=2.0 * np.pi, max_range=rng)
    ocfg = tl.OccupancyConfig()
    st = tl.occupancy_init((nx, ny), ocfg, device="cpu")
    lower = torch.zeros(2)
    res32 = torch.tensor(res, dtype=torch.float32)
    for i, (pose, ranges, hits) in enumerate(scans):
        # the reference's static counter fires cirSup on scans 2, 4, 6, ...
        st = tl.occupancy_update(st, lower, res32,
                                 torch.tensor(pose, dtype=torch.float32),
                                 torch.as_tensor(ranges),
                                 torch.as_tensor(hits), lcfg, ocfg,
                                 cir_sup=cir_sup and i % 2 == 1)
    mism = st.grid.numpy().astype(int) != gold_grid
    assert mism.sum() == 0, np.argwhere(mism)[:10]
    np.testing.assert_allclose(st.log_odds.double().numpy(), gold_lo,
                               atol=1e-5)


def test_perspective_golden():
    (nx, ny, res, rng, _, _, persp), scans, gold_grid, gold_lo = \
        load_golden("fusion_persp")
    assert persp
    st = tl.occupancy_init((nx, ny), tl.OccupancyConfig(), device="cpu")
    init_lo = st.log_odds.clone()
    for pose, pts in scans:
        st = tl.occupancy_update_perspective(
            st, torch.zeros(2), torch.tensor(res, dtype=torch.float32),
            torch.tensor(pose, dtype=torch.float32), torch.as_tensor(pts),
            torch.ones(pts.shape[0], dtype=torch.bool), rng)
    mism = st.grid.numpy().astype(int) != gold_grid
    assert mism.sum() == 0, np.argwhere(mism)[:10]
    assert torch.equal(st.log_odds, init_lo)
    np.testing.assert_allclose(st.log_odds.double().numpy(), gold_lo,
                               atol=1e-5)


# ---- tests/test_lidar.py and tests/test_lidar_modes.py on the port ----

def _wall_world():
    occ = np.zeros((100, 100), bool)
    occ[60:65, 40:60] = True     # wall north of the robot
    return torch.as_tensor(occ), (0.0, 0.0), 0.1


def test_scan_ranges_match_geometry():
    occ, lower, res = _wall_world()
    cfg = tl.LidarConfig(n_beams=360, max_range=8.0, n_steps=400)
    ranges, hits = tl.lidar_scan(occ, lower, res,
                                 torch.tensor([5.0, 5.0, 0.0]), cfg)
    assert hits[180] and abs(float(ranges[180]) - 1.0) < 0.06
    assert not hits[0] or float(ranges[0]) > 4.9


def test_occupancy_mapping_converges():
    occ, lower, res = _wall_world()
    cfg_l = tl.LidarConfig(n_beams=720, max_range=8.0, n_steps=400)
    st = tl.occupancy_init(occ.shape, device="cpu")
    for _ in range(4):
        for pose in [(5.0, 5.0, 0.0), (4.0, 4.5, 0.5), (6.0, 4.0, 1.5)]:
            p = torch.tensor(pose)
            ranges, hits = tl.lidar_scan(occ, lower, res, p, cfg_l)
            st = tl.occupancy_update(st, lower, res, p, ranges, hits, cfg_l)
    occ_est, free_est, unknown = tl.occupancy_classes(st)
    assert int(occ_est[60, 45:55].sum()) >= 8
    assert int(free_est[50:59, 50].sum()) >= 8
    assert bool(unknown[70:80, 45:55].all())


def test_esdf_from_mapped_occupancy():
    from alore_legged_manipulator_tpu_torch.ops.esdf import (
        esdf_from_occupancy, sample_dist_bilinear)
    occ, lower, res = _wall_world()
    cfg_l = tl.LidarConfig(n_beams=720, max_range=9.0, n_steps=500)
    st = tl.occupancy_init(occ.shape, device="cpu")
    p = torch.tensor([5.0, 5.0, 1.57])
    for _ in range(8):
        ranges, hits = tl.lidar_scan(occ, lower, res, p, cfg_l)
        st = tl.occupancy_update(st, lower, res, p, ranges, hits, cfg_l)
    occ_est, _, _ = tl.occupancy_classes(st)
    q = torch.tensor([[[5.0, 5.8]]])
    d1 = float(sample_dist_bilinear(
        esdf_from_occupancy(occ_est, torch.zeros(2), res), q))
    d2 = float(sample_dist_bilinear(
        esdf_from_occupancy(occ, torch.zeros(2), res), q))
    assert abs(d1 - d2) < 0.15


def _occluder_world():
    occ = np.zeros((60, 60), bool)
    occ[30, 28:33] = True     # wall at x = 3.05
    occ[45, 30] = True        # target BEHIND the wall at x = 4.55
    return torch.as_tensor(occ), torch.zeros(2), 0.1


def test_perspective_sees_through_occlusion():
    occ, lower, res = _occluder_world()
    pose = torch.tensor([1.0, 3.0, 0.0])
    cfg = tl.LidarConfig(max_range=6.0)
    ranges, _ = tl.lidar_scan(occ, lower, res, pose, cfg)
    assert float(ranges[ranges.shape[0] // 2]) < 2.5
    pts, mask = tl.perspective_points(occ, lower, res, pose, cfg)
    got = pts[mask].numpy()
    d = np.linalg.norm(got - np.array([3.55, 0.05]), axis=-1)
    assert d.min() < 1e-5
    assert np.linalg.norm(got, axis=-1).max() <= cfg.max_range + 1e-6


def test_perspective_fov_gate():
    occ, lower, res = _occluder_world()
    cfg = tl.LidarConfig(max_range=6.0, fov_rad=np.pi / 2)
    _, mask = tl.perspective_points(occ, lower, res,
                                    torch.tensor([1.0, 3.0, np.pi]), cfg)
    assert not bool(mask.any())


def test_circular_support_carves_free_space():
    occ, lower, res = _occluder_world()
    st = tl.occupancy_init((60, 60), device="cpu")
    st = tl.circular_support_update(st, lower, res,
                                    torch.tensor([1.0, 3.0, 0.0]),
                                    detection_range=2.0)
    occ_g, free, unknown = tl.occupancy_classes(st)
    assert bool(free[10, 30]) and bool(free[25, 30])
    assert bool(unknown[50, 50])
    assert not bool(occ_g.any())


def test_circular_support_fov_limited():
    occ, lower, res = _occluder_world()
    st = tl.occupancy_init((60, 60), device="cpu")
    st = tl.circular_support_update(st, lower, res,
                                    torch.tensor([3.0, 3.0, 0.0]),
                                    detection_range=2.0, fov_rad=np.pi / 2)
    _, free, unknown = tl.occupancy_classes(st)
    assert bool(free[40, 30]) and bool(unknown[20, 30])


def test_modes_agree_in_open_space():
    occ = torch.zeros((60, 60), dtype=torch.bool)
    occ[40, 30] = True
    pose = torch.tensor([1.0, 3.0, 0.0])
    cfg = tl.LidarConfig(max_range=6.0)
    ranges, hits = tl.lidar_scan(occ, torch.zeros(2), 0.1, pose, cfg)
    fwd = ranges.shape[0] // 2
    assert bool(hits[fwd])
    pts, mask = tl.perspective_points(occ, torch.zeros(2), 0.1, pose, cfg)
    got = pts[mask].numpy()
    assert got.shape[0] == 1
    assert abs(np.linalg.norm(got[0]) - float(ranges[fwd])) < 0.1


def test_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tl.occupancy_init((4, 4))
