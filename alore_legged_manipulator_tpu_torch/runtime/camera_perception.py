"""Vision-based perception node: rendered camera frames -> /env_obs.

The reference's `env_perception_auto.py` composes a coarse long-range
object detector (YOLO range/bearing, yolo_pose.py) with precise
close-range relative pose (AprilTag PnP, apriltag_pose.py) on top of
lidar localization.  This node reproduces that architecture with the
REAL image pipeline in the middle:

  1. a forward-looking camera on the robot renders depth + COLOR (+
     semantic ground truth) frames from the true world (world/camera.py
     -- the Isaac bridge's camera topics);
  2. each visible object's position is ESTIMATED FROM THE COLOR IMAGE:
     per-object pixel masks recovered from chromaticity
     (color_class_masks -- the YOLO detector stand-in), bbox from the
     mask, range from the depth crop mean, bearing from the bbox-center
     pixel offset (the YOLO node's arithmetic, yolo_pose.py:167-181),
     plus a face-to-center range correction;
  3. within `close_range`, the estimate switches to a tag-style precise
     relative pose (AprilTag analogue: truth + mm noise) -- exactly the
     reference's near-field handoff;
  4. unseen objects keep their last estimate (initialized from a coarse
     prior map, like env_perception_auto.py's fixed object table).

Robot pose comes from the localization channel (truth + noise), as in
AutoPerception.  The FSM downstream only ever sees `/env_obs`.

Port of runtime/camera_perception.py: the render (`_ensure_render`) is
one plain function over tensors on the node's `device` (None: the card),
float32 as the JAX node's; only the depth frame and the color masks come
to the host, once per render.  The noise channels draw from numpy with
the JAX node's seeds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..utils.precision import resolve_device
from ..world import camera as cmr
from .contracts import (EnvObs, RigidBodyPose, N_OBJECTS,
                        yaw_to_quat_xyzw)
from .deploy import MessageBus
from .perception import _host

TOPIC_OBS = "/env_obs"

CAM_HEIGHT = 0.5
OBJ_BOX_HALF = 0.3
OBJ_BOX_HEIGHT = 1.0


@dataclass
class CameraPerceptionNode:
    bus: MessageBus
    n_objects: int
    cam: cmr.CameraModel = field(default_factory=lambda: cmr.CameraModel(
        fx=90.0, fy=90.0, cx=48.0, cy=36.0, width=96, height=72))
    close_range: float = 2.0
    min_pixels: int = 12
    loc_noise: float = 0.003       # localization (robot pose) noise
    tag_noise: float = 0.002       # close-range tag-pose noise
    prior_noise: float = 0.25      # coarse prior map error
    seed: int = 0
    max_range: float = 12.0
    period: int = 5                # render every k-th bus tick (the
                                   # detector's process_interval idea,
                                   # yolo_pose.py:98; at bus_mission's
                                   # 20 Hz dt this is 4 Hz vision)
    device: object = None          # the render's device (None: the card)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._est: Optional[List[np.ndarray]] = None
        self._render = None
        self._tick_count = 0

    def _ensure_render(self):
        if self._render is not None:
            return
        cam = self.cam
        dev = resolve_device(self.device)
        z = dict(dtype=torch.float32, device=dev)
        n = self.n_objects

        def render(robot_pose, centers, yaws):
            robot_pose, centers, yaws = (torch.as_tensor(x).to(**z) for x
                                         in (robot_pose, centers, yaws))
            scene = cmr.BoxScene(
                center=centers, yaw=yaws,
                half_ext=torch.full((n, 2), OBJ_BOX_HALF, **z),
                height=torch.full((n,), OBJ_BOX_HEIGHT, **z),
                sem_id=torch.arange(1, n + 1, dtype=torch.int32, device=dev))
            R, t = cmr.pose_matrix(
                (robot_pose[0], robot_pose[1], CAM_HEIGHT),
                (cmr.ROBOT_CAM_RPY[0], cmr.ROBOT_CAM_RPY[1],
                 cmr.ROBOT_CAM_RPY[2] + robot_pose[2]))
            depth, sem = cmr.render(cam, R, t, scene,
                                    max_range=self.max_range)
            # the detector consumes the COLOR image: per-object masks
            # recovered from chromaticity (world/camera.py
            # color_class_masks), the YOLO path's real input; the
            # semantic frame stays available as test ground truth
            rgb = cmr.render_color(cam, R, t, scene,
                                   max_range=self.max_range)
            masks = cmr.color_class_masks(rgb, n)
            return depth, sem, rgb, masks

        self._render = render

    def _estimate_from_image(self, depth, masks, robot_pose):
        """Per-object range/bearing estimates from the rendered frame.

        masks: (n_objects, H, W) bool per-object pixel masks recovered
        from the COLOR image (world/camera.color_class_masks) -- the
        bbox path runs on what the detector can actually see, not on
        the semantic ground truth."""
        depth = _host(depth)
        masks = _host(masks)
        out = {}
        for i in range(self.n_objects):
            mask = masks[i]
            cnt = int(mask.sum())
            if cnt < self.min_pixels:
                continue
            vs, us = np.nonzero(mask)
            u_c = (us.min() + us.max()) / 2.0
            rng = depth[vs, us]
            rng = rng[np.isfinite(rng)]
            if rng.size == 0:
                continue
            r = float(rng.mean()) + 0.6 * OBJ_BOX_HALF   # face -> center
            # bearing: +u (image right) is clockwise of the heading
            alpha = -np.arctan((u_c - self.cam.cx) / self.cam.fx)
            heading = robot_pose[2] + alpha
            out[i] = robot_pose[:2] + r * np.array(
                [np.cos(heading), np.sin(heading)])
        return out

    def tick(self, world):
        """world: bus_mission.WorldState (truth; only the camera and the
        noisy localization/tag channels may read it)."""
        robot_true = np.asarray(world.robot, float)
        robot_est = robot_true + self._rng.normal(0, self.loc_noise, 3)

        if self._est is None:
            # coarse prior map (fixed table analogue)
            self._est = [np.asarray(o, float)[:2]
                         + self._rng.normal(0, self.prior_noise, 2)
                         for o in world.objects]

        self._tick_count += 1
        if self._tick_count % self.period == 0:
            self._ensure_render()
            centers = np.asarray([np.asarray(o, float)[:2]
                                  for o in world.objects], np.float32)
            yaws = np.asarray([float(np.asarray(o, float)[2])
                               for o in world.objects], np.float32)
            # the physical camera sits on the TRUE robot; the frame is
            # rendered from truth and unprojected through the ESTIMATE,
            # so localization error propagates into the object estimates
            # (it must not cancel)
            depth, sem, rgb, masks = self._render(
                robot_true.astype(np.float32), centers, yaws)
            vision = self._estimate_from_image(depth, masks, robot_est)
            for i, pos in vision.items():
                self._est[i] = pos
        for i, o in enumerate(world.objects):
            true_xy = np.asarray(o, float)[:2]
            if np.linalg.norm(true_xy - robot_true[:2]) < self.close_range:
                # AprilTag-style near-field handoff: the tag gives a
                # RELATIVE pose in the robot frame (truth-relative +
                # noise), composed with the noisy localization estimate
                cy, sy = np.cos(robot_true[2]), np.sin(robot_true[2])
                R_true = np.array([[cy, sy], [-sy, cy]])   # world->robot
                rel = R_true @ (true_xy - robot_true[:2]) \
                    + self._rng.normal(0, self.tag_noise, 2)
                ce, se = np.cos(robot_est[2]), np.sin(robot_est[2])
                R_est = np.array([[ce, -se], [se, ce]])    # robot->world
                self._est[i] = robot_est[:2] + R_est @ rel

        def body_of(x, y, yaw):
            return RigidBodyPose(
                xyz=np.array([x, y, 0.0], np.float32), yaw=float(yaw),
                quat_xyzw=yaw_to_quat_xyzw(float(yaw)))

        bodies = []
        for i in range(N_OBJECTS):
            if i < self.n_objects:
                yaw = float(np.asarray(world.objects[i], float)[2]) \
                    + float(self._rng.normal(0, 0.01))
                xy = self._est[i]
            else:
                yaw, xy = 0.0, np.zeros(2)
            bodies.append(body_of(xy[0], xy[1], yaw))
        obs = EnvObs(robot=body_of(*robot_est), objects=bodies)
        self.bus.publish(TOPIC_OBS, obs.pack())
        return obs
