"""Port parity: the perception node analogues (`runtime/perception.py`).

The port keeps its own copy of the JAX package's numpy module; both draw
their noise from numpy generators with the same seeds.  Each scenario
runs through both packages with noise on, and every output and every
message published on the bus must be equal, bit for bit: the rotation
helpers, the AprilTag detector (trigger, one-shot, misses), the YOLO
detector on projected frames (buffering, depth window, yaw bins,
retrigger) and on rendered frames (the JAX renderer's frames for the JAX
detector, the port's for the port's: at float32 the two renders agree
pixel for pixel here, tests/test_torch_camera.py), and AutoPerception's
lidar-to-base algebra and `/env_obs`.
"""
import math

import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.runtime import deploy as jdep
from alore_legged_manipulator_tpu.runtime import perception as jp
from alore_legged_manipulator_tpu.world import camera as jc
from alore_legged_manipulator_tpu_torch.runtime import deploy as tdep
from alore_legged_manipulator_tpu_torch.runtime import perception as tp
from alore_legged_manipulator_tpu_torch.world import camera as tc

PAIRS = ((jp, jdep), (tp, tdep))


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bus(dep, topics):
    bus = dep.MessageBus()
    log = []
    for t in topics:
        bus.subscribe(t, lambda m, t=t: log.append((t, np.array(m,
                                                                copy=True))))
    return bus, log


def _same_logs(a, b):
    assert len(a) == len(b)
    for (ta, ma), (tb, mb) in zip(a, b):
        assert ta == tb
        np.testing.assert_array_equal(ma, mb)


def test_rotation_helpers_equal():
    rng = np.random.default_rng(0)
    for _ in range(20):
        ypr = rng.uniform(-math.pi, math.pi, 3)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = jp.rot_from_euler_zyx(*ypr)
        _same(tp.rot_from_euler_zyx(*ypr), R)
        _same(tp.rot_from_quat_xyzw(q), jp.rot_from_quat_xyzw(q))
        _same(tp.quat_xyzw_from_rot(R), jp.quat_xyzw_from_rot(R))
        _same(tp.euler_xyz_from_rot(R), jp.euler_xyz_from_rot(R))
        for f in ("rot_x", "rot_y", "rot_z"):
            _same(getattr(tp, f)(ypr[0]), getattr(jp, f)(ypr[0]))


def _camera(mod, cam_p, yaw):
    fwd = np.array([math.cos(yaw), math.sin(yaw), 0.0])
    right = np.array([math.sin(yaw), -math.cos(yaw), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    return mod.SE3(np.stack([right, down, fwd], axis=1),
                   np.asarray(cam_p, float))


def test_apriltag_detector_equal():
    outs, logs = [], []
    for mod, dep in PAIRS:
        bus, log = _bus(dep, [mod.TOPIC_TAG_RESULT])
        det = mod.AprilTagDetector(bus, mod.CameraIntrinsics(), seed=4)
        rng = np.random.default_rng(1)
        out = []
        for k in range(30):
            cam = _camera(mod, rng.uniform(-1, 1, 3), rng.uniform(-3, 3))
            rel = np.array([rng.uniform(-0.6, 0.6), rng.uniform(-0.4, 0.4),
                            rng.uniform(-1.0, 4.0)])
            tag = mod.SE3(mod.rot_from_euler_zyx(*rng.uniform(-1, 1, 3)),
                          cam.p + cam.R @ rel)
            if k % 3 != 2:
                bus.publish(mod.TOPIC_TAG_TRIGGER, True)
            out.append(det.process_frame(cam, tag))
            out.append(det.start_detect)
        outs.append(out)
        logs.append(log)
    for a, b in zip(*outs):
        _same(a, b)
    assert any(isinstance(o, np.ndarray) for o in outs[0])
    _same_logs(*logs)


def test_yolo_detector_projected_frames_equal():
    outs, logs = [], []
    for mod, dep in PAIRS:
        bus, log = _bus(dep, [mod.TOPIC_YOLO_POSE, "/object_detection"])
        det = mod.YoloPoseDetector(bus, seed=5)
        cam = _camera(mod, [0.0, 0.0, 0.5], 0.2)
        rng = np.random.default_rng(2)
        out = []
        for k in range(200):
            if k % 40 == 0 or k == 7:
                bus.publish(mod.TOPIC_YOLO_TRIGGER, True)
            rel = np.array([rng.uniform(-0.6, 0.6), 0.0,
                            rng.uniform(1.5, 5.0)])
            obj = mod.SE3(np.eye(3), cam.p + cam.R @ rel)
            out.append(det.process_frame(cam, obj, rng.uniform(-3, 3)))
            out += [det.frame_count, det.state_finding,
                    len(det.pose_buffer)]
        outs.append(out)
        logs.append(log)
    for a, b in zip(*outs):
        _same(a, b)
    assert sum(isinstance(o, np.ndarray) for o in outs[0]) >= 3
    _same_logs(*logs)


@pytest.mark.parametrize("obj_xy,obj_yaw,sem_id", [
    ((3.0, 0.25), math.radians(40.0), 5), ((2.6, -0.4), -1.2, 5),
    ((3.0, 0.0), 0.0, 99)], ids=["left", "right", "no_mask"])
def test_yolo_detector_rendered_frames_equal(obj_xy, obj_yaw, sem_id):
    w, h, f = 160, 120, 120.0
    outs = []
    for mod, dep, cm in ((jp, jdep, jc), (tp, tdep, tc)):
        cam = cm.CameraModel(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w,
                             height=h)
        if cm is jc:
            import jax.numpy as jnp
            mk = lambda a: jnp.asarray(np.asarray(a))  # noqa: E731
            pose = dict()
        else:
            mk = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
            pose = dict(device="cpu")
        scene = cm.BoxScene(
            center=mk(np.asarray([obj_xy], np.float32)),
            yaw=mk(np.asarray([obj_yaw], np.float32)),
            half_ext=mk(np.asarray([[0.3, 0.3]], np.float32)),
            height=mk(np.asarray([1.2], np.float32)),
            sem_id=mk(np.asarray([5], np.int32)))
        R, t = cm.pose_matrix((0.0, 0.0, 0.5), cm.ROBOT_CAM_RPY, **pose)
        R, t = mk(np.asarray(R, np.float32)), mk(np.asarray(t, np.float32))
        depth, sem = cm.render(cam, R, t, scene)
        bus, log = _bus(dep, [mod.TOPIC_YOLO_POSE])
        det = mod.YoloPoseDetector(bus, intr=mod.CameraIntrinsics(
            fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h), seed=6)
        bus.publish(mod.TOPIC_YOLO_TRIGGER, True)
        out = [det.process_rendered_frame(depth, sem, sem_id, mod.SE3(
            np.asarray(R, float), np.asarray(t, float)), obj_yaw)
            for _ in range(40)]
        outs.append((out, log, det.state_finding))
    for a, b in zip(outs[0][0], outs[1][0]):
        _same(a, b)
    _same_logs(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2] == (sem_id == 99)


def test_auto_perception_equal():
    outs, logs = [], []
    for mod, dep in PAIRS:
        bus, log = _bus(dep, [mod.TOPIC_ENV_OBS])
        node = mod.AutoPerception(bus)
        rng = np.random.default_rng(3)
        out = []
        for k in range(10):
            q = rng.normal(size=4)
            node.on_odom(rng.uniform(-5, 5, 3), q / np.linalg.norm(q))
            if k == 4:
                node.set_object_pose(2, 1.5, -0.5, 0.3)
            out += [node.robot.xyz, node.robot.yaw, node.robot.quat_xyzw]
            node.publish()
        outs.append(out)
        logs.append(log)
    for a, b in zip(*outs):
        _same(a, b)
    _same_logs(*logs)
