"""Port parity: the vision perception node
(`runtime/camera_perception.py`) and the bus mission on it.

* tests/test_camera_perception.py's checks on the port's node (on the
  CPU): the image-space estimate within 15 cm at mid range, an unseen
  object keeping its prior, the near-field tag handoff, a localization
  bias propagating into the estimate.
* The port's node against the JAX package's, tick by tick on a moving
  scene (render every tick and every 5th): every `/env_obs` within
  `OBS_TOL` m (the float32 renders agree pixel for pixel on these frames,
  so the estimates agree to float32 rounding; 9.5e-7 seen), the render's masks
  equal and its depth within 2e-6 relative (the JAX node's box sizes are
  float64 constants, so with x64 on its slab test runs partly in
  float64; the port's is float32 throughout; 1.0e-6 seen).
* `run_bus_mission(perception="camera")`, the two-object mission of
  tests/test_camera_perception.py, through both packages: the same
  delivered flags, ticks within `TICK_BAND` of JAX's and each final error
  within `ERR_BAND` m of JAX's (both runs gave 654 ticks and the same
  errors to the last bit), and that test's own bounds on the port.
"""
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.runtime import bus_mission as jbm
from alore_legged_manipulator_tpu.runtime import camera_perception as jcp
from alore_legged_manipulator_tpu.runtime import deploy as jdep
from alore_legged_manipulator_tpu_torch.runtime import bus_mission as tbm
from alore_legged_manipulator_tpu_torch.runtime import camera_perception as tcp
from alore_legged_manipulator_tpu_torch.runtime import deploy as tdep

torch.set_num_threads(2)

OBS_TOL = 1e-4
TICK_BAND = 0.05
ERR_BAND = 0.05


def _node(**kw):
    return tcp.CameraPerceptionNode(tdep.MessageBus(), device="cpu", **kw)


def test_vision_estimate_accuracy_mid_range():
    node = _node(n_objects=1, seed=0, period=1, close_range=0.5,
                 loc_noise=0.0)
    world = tbm.WorldState(robot=np.array([0.0, 0.0, 0.0]),
                           objects=[np.array([4.0, 0.5, 0.3])])
    for _ in range(3):
        obs = node.tick(world)
    est = np.asarray(obs.objects[0].xyz[:2])
    assert np.linalg.norm(est - [4.0, 0.5]) < 0.15, est


def test_out_of_view_object_keeps_prior():
    node = _node(n_objects=1, seed=1, period=1, close_range=0.5,
                 prior_noise=0.2)
    world = tbm.WorldState(robot=np.array([0.0, 0.0, 0.0]),
                           objects=[np.array([-4.0, 0.0, 0.0])])
    prior = np.asarray(node.tick(world).objects[0].xyz[:2]).copy()
    for _ in range(4):
        obs = node.tick(world)
    np.testing.assert_allclose(np.asarray(obs.objects[0].xyz[:2]), prior,
                               atol=1e-6)


def test_near_field_tag_handoff():
    node = _node(n_objects=1, seed=2, period=1)
    world = tbm.WorldState(robot=np.array([0.0, 0.0, 0.0]),
                           objects=[np.array([1.2, 0.1, 0.0])])
    est = np.asarray(node.tick(world).objects[0].xyz[:2])
    assert np.linalg.norm(est - [1.2, 0.1]) < 0.02


def test_localization_error_propagates_to_estimates():
    node = _node(n_objects=1, seed=0, period=1)
    node._ensure_render()
    depth, sem, rgb, masks = node._render(
        np.zeros(3, np.float32), np.asarray([[4.0, 0.0]], np.float32),
        np.zeros(1, np.float32))
    assert depth.dtype == torch.float32 and masks.dtype == torch.bool
    est0 = node._estimate_from_image(depth, masks, np.zeros(3))[0]
    assert np.linalg.norm(est0 - [4.0, 0.0]) < 0.15
    est1 = node._estimate_from_image(depth, masks,
                                     np.array([0.0, 0.2, 0.0]))[0]
    assert abs((est1 - est0)[1] - 0.2) < 0.02, (est0, est1)


@pytest.mark.parametrize("period", [1, 5])
def test_node_matches_jax_tick_by_tick(period):
    objects = [np.array([3.0, 0.5, 0.2]), np.array([3.5, -1.2, -0.4]),
               np.array([6.0, 1.8, 0.0])]
    nodes = []
    for cp, dep, bm, kw in ((jcp, jdep, jbm, {}),
                            (tcp, tdep, tbm, dict(device="cpu"))):
        bus = dep.MessageBus()
        log = []
        bus.subscribe(cp.TOPIC_OBS, lambda m, log=log: log.append(
            np.array(m, copy=True)))
        node = cp.CameraPerceptionNode(bus, n_objects=3, seed=4,
                                       period=period, **kw)
        nodes.append((node, bm, log))
    for k in range(30):
        robot = np.array([0.1 * k, 0.02 * k, 0.03 * np.sin(0.3 * k)])
        for node, bm, _ in nodes:
            node.tick(bm.WorldState(robot=robot.copy(),
                                    objects=[o.copy() for o in objects]))
    (jn, _, jlog), (tn, _, tlog) = nodes
    assert len(jlog) == len(tlog) == 30
    for a, b in zip(jlog, tlog):
        np.testing.assert_allclose(b, a, rtol=0, atol=OBS_TOL)
    args = (np.array([0.3, 0.1, 0.05], np.float32),
            np.asarray([o[:2] for o in objects], np.float32),
            np.asarray([o[2] for o in objects], np.float32))
    jd, _, _, jm = jn._render(*args)
    td, _, _, tm = tn._render(*args)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    fin = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(np.isfinite(td.numpy()), fin)
    np.testing.assert_allclose(td.numpy()[fin], np.asarray(jd)[fin],
                               rtol=2e-6, atol=0)


def test_bus_mission_on_vision_perception_matches_jax():
    kw = dict(items=[(3.0, 0.5, 0.0), (3.0, -1.0, 0.0)],
              targets=[(6.0, 1.5, 0.0), (6.0, -1.5, 0.0)],
              robot_start=(0.0, 0.0, 0.0), perception="camera")
    ref = jbm.run_bus_mission(**kw)
    got = tbm.run_bus_mission(**kw, device="cpu")
    assert got.delivered == ref.delivered
    assert all(got.delivered) and max(got.final_err) < 0.35, got
    assert abs(got.ticks - ref.ticks) <= TICK_BAND * ref.ticks
    np.testing.assert_allclose(got.final_err, ref.final_err, rtol=0,
                               atol=ERR_BAND)
