"""Port parity: the synthetic camera (`world/camera.py`).

The JAX package's renderer against the port's on the scenes of
tests/test_camera.py (plus one whose semantic ids wrap the palette and
one of the camera perception node's), on the CPU:

* float64 (scene, pose and rays float64 on both sides): depth, z-depth,
  RGB, rays, pose matrices, the depth clouds and the mapping cloud
  within 1e-12; semantics, color masks, finite masks, bboxes and pixel
  counts equal;
* float32, each package building its own float32 pose matrix (XLA's and
  PyTorch's `cos`/`sin` may differ by an ulp): depth within 1e-5 where
  both are finite, and at most `EDGE_PIXELS_F32` pixels whose semantic
  label or color mask differs (silhouette pixels; 0 seen on these
  scenes);
* the JAX tests' own geometric assertions on the port.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.world import camera as jc
from alore_legged_manipulator_tpu_torch.world import camera as tc

EDGE_PIXELS_F32 = 4

# (camera (w, h, f), boxes (cx, cy, yaw, hx, hy, height, sem), pose
# (x, y, z, yaw))
SCENES = {
    "two_rotated": ((64, 48, 60.0), [(3.0, -0.6, 0.2, 0.4, 0.4, 1.2, 1),
                                     (3.0, 0.8, -0.4, 0.3, 0.3, 1.2, 2)],
                    (0.0, 0.0, 1.0, 0.0)),
    "occlusion": ((64, 48, 40.0), [(5.0, 0.0, 0.0, 0.5, 1.0, 2.0, 1),
                                   (2.5, 0.0, 0.0, 0.3, 0.6, 2.0, 2)],
                  (0.0, 0.0, 1.0, 0.0)),
    "side_yawed": ((64, 48, 40.0), [(0.0, 3.0, 0.0, 0.5, 0.5, 2.0, 3)],
                   (0.0, 0.0, 1.0, math.pi / 2)),
    "palette_wrap": ((48, 36, 30.0), [(2.5, -1.5, 0.3, 0.3, 0.3, 1.0, 8),
                                      (3.0, 0.0, -0.7, 0.4, 0.2, 0.8, 9),
                                      (3.5, 1.6, 1.1, 0.3, 0.5, 1.5, 15)],
                     (0.2, -0.1, 0.8, 0.1)),
    "perception_node": ((96, 72, 90.0), [(4.0, 0.5, 0.3, 0.3, 0.3, 1.0, 1),
                                         (3.0, -1.0, 0.0, 0.3, 0.3, 1.0, 2),
                                         (6.0, 1.5, -0.2, 0.3, 0.3, 1.0,
                                          3)],
                        (0.1, 0.2, 0.5, 0.05)),
}


def _cam(lib, w, h, f):
    return lib.CameraModel(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)


def _both(name, npdt):
    (w, h, f), boxes, (x, y, z, yaw) = SCENES[name]
    a = np.asarray(boxes, np.float64)
    jscene = jc.BoxScene(center=jnp.asarray(a[:, 0:2], npdt),
                         yaw=jnp.asarray(a[:, 2], npdt),
                         half_ext=jnp.asarray(a[:, 3:5], npdt),
                         height=jnp.asarray(a[:, 5], npdt),
                         sem_id=jnp.asarray(a[:, 6], jnp.int32))
    tdt = getattr(torch, np.dtype(npdt).name)
    tscene = tc.BoxScene(*(torch.as_tensor(np.array(v)) for v in jscene))
    rpy = (jc.ROBOT_CAM_RPY[0], jc.ROBOT_CAM_RPY[1],
           jc.ROBOT_CAM_RPY[2] + yaw)
    jR, jt = jc.pose_matrix(tuple(npdt(v) for v in (x, y, z)),
                            tuple(npdt(v) for v in rpy))
    tR, tt = tc.pose_matrix((x, y, z), rpy, dtype=tdt, device="cpu")
    return (_cam(jc, w, h, f), jscene, jR, jt), (_cam(tc, w, h, f), tscene,
                                                  tR, tt)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_float64_matches_jax(name):
    (jcam, js, jR, jt), (tcam, ts, tR, tt) = _both(name, np.float64)
    assert tR.dtype == torch.float64
    np.testing.assert_allclose(_np(tR), _np(jR), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(tt), _np(jt), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(tc.camera_rays(tcam, torch.float64,
                                                  "cpu")),
                               _np(jc.camera_rays(jcam, jnp.float64)),
                               rtol=0, atol=1e-12)
    jd, jsem = jc.render(jcam, jR, jt, js)
    td, tsem = tc.render(tcam, tR, tt, ts)
    np.testing.assert_array_equal(_np(tsem), _np(jsem))
    np.testing.assert_array_equal(np.isinf(_np(td)), np.isinf(_np(jd)))
    fin = np.isfinite(_np(jd))
    np.testing.assert_allclose(_np(td)[fin], _np(jd)[fin], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(_np(tc.depth_to_z(tcam, td))[fin],
                               _np(jc.depth_to_z(jcam, jd))[fin], rtol=0,
                               atol=1e-12)
    jrgb = jc.render_color(jcam, jR, jt, js)
    trgb = tc.render_color(tcam, tR, tt, ts)
    np.testing.assert_allclose(_np(trgb), _np(jrgb), rtol=0, atol=1e-12)
    n_cls = int(max(b[6] for b in SCENES[name][1]))
    np.testing.assert_array_equal(_np(tc.color_class_masks(trgb, n_cls)),
                                  _np(jc.color_class_masks(jrgb, n_cls)))
    for sid in sorted({int(b[6]) for b in SCENES[name][1]}) + [99]:
        jb = [int(v) for v in jc.semantic_bbox(jsem, sid)]
        tb = [int(v) for v in tc.semantic_bbox(tsem, sid)]
        assert tb == jb, sid
        np.testing.assert_allclose(
            float(tc.bbox_depth_mean(td, tsem, sid)),
            float(jc.bbox_depth_mean(jd, jsem, sid)), rtol=0, atol=1e-12)
    for stride in (1, 3):
        jp, jm = jc.depth_cloud(jcam, jR, jt, jd, stride)
        tp, tm = tc.depth_cloud(tcam, tR, tt, td, stride)
        np.testing.assert_array_equal(_np(tm), _np(jm))
        np.testing.assert_allclose(_np(tp)[_np(jm)], _np(jp)[_np(jm)],
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            _np(tc.cloud_for_mapping(tcam, tR, tt, td, 12.0, stride)),
            _np(jc.cloud_for_mapping(jcam, jR, jt, jd, 12.0, stride)),
            rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_float32_edge_pixels(name):
    (jcam, js, jR, jt), (tcam, ts, tR, tt) = _both(name, np.float32)
    assert tR.dtype == torch.float32 and jR.dtype == jnp.float32
    jd, jsem = jc.render(jcam, jR, jt, js)
    td, tsem = tc.render(tcam, tR, tt, ts)
    fin = np.isfinite(_np(jd)) & np.isfinite(_np(td))
    np.testing.assert_allclose(_np(td)[fin], _np(jd)[fin], rtol=0,
                               atol=1e-5)
    assert int((_np(tsem) != _np(jsem)).sum()) <= EDGE_PIXELS_F32
    n_cls = int(max(b[6] for b in SCENES[name][1]))
    tmask = _np(tc.color_class_masks(tc.render_color(tcam, tR, tt, ts),
                                     n_cls))
    jmask = _np(jc.color_class_masks(jc.render_color(jcam, jR, jt, js),
                                     n_cls))
    assert int((tmask != jmask).any(axis=0).sum()) <= EDGE_PIXELS_F32


def _fwd(x, y, z, yaw=0.0):
    return tc.pose_matrix((x, y, z), (tc.ROBOT_CAM_RPY[0],
                                      tc.ROBOT_CAM_RPY[1],
                                      tc.ROBOT_CAM_RPY[2] + yaw),
                          device="cpu")


def _scene(boxes):
    a = torch.as_tensor(np.asarray(boxes, np.float32))
    return tc.BoxScene(center=a[:, 0:2], yaw=a[:, 2], half_ext=a[:, 3:5],
                       height=a[:, 5], sem_id=a[:, 6].to(torch.int32))


def test_geometry_on_the_port():
    """tests/test_camera.py's analytic checks, on the port."""
    cam = tc.CameraModel(fx=40.0, fy=40.0, cx=32.0, cy=24.0, width=64,
                         height=48)
    R, t = _fwd(0.0, 0.0, 1.0)
    np.testing.assert_allclose(_np(R @ torch.tensor([0.0, 0.0, 1.0])),
                               [1.0, 0.0, 0.0], atol=1e-6)
    depth, sem = tc.render(cam, R, t, _scene([(3.0, 0.0, 0.0, 0.5, 0.5, 2.0,
                                               1)]))
    assert depth.dtype == torch.float32 and sem.dtype == torch.int32
    np.testing.assert_allclose(float(depth[24, 32]), 2.5, atol=2e-3)
    assert int(sem[24, 32]) == 1
    _, sem = tc.render(cam, R, t, _scene([(100.0, 100.0, 0.0, 0.1, 0.1, 0.1,
                                           1)]))
    assert int(sem[0, 32]) == tc.SKY and int(sem[47, 32]) == tc.GROUND
    depth, sem = tc.render(cam, R, t, _scene([(3.0, 0.0, 0.0, 0.5, 2.0, 3.0,
                                               1)]))
    pts, mask = tc.depth_cloud(cam, R, t, depth)
    on_box = _np(mask) & (_np(sem).reshape(-1) == 1)
    assert on_box.sum() > 50
    np.testing.assert_allclose(_np(pts)[on_box, 0], 2.5, atol=1e-3)
    rgb = tc.render_color(cam, R, t, _scene([(3.0, -0.6, 0.2, 0.4, 0.4, 1.2,
                                              1)]))
    assert bool(((rgb >= 0) & (rgb <= 1)).all())
    masks = tc.color_class_masks(rgb, 1)
    _, sem = tc.render(cam, R, t, _scene([(3.0, -0.6, 0.2, 0.4, 0.4, 1.2,
                                           1)]))
    assert int((masks[0] != (sem == 1)).sum()) <= 2
