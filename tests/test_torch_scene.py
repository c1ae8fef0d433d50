"""Port parity: scene and terrain generation (`world/scene.py`, the
port's own copy, host numpy).

Height fields and occupancy bit for bit the JAX package's per seed and
preset; tests/test_scene.py's invariants on the port; and a scene feeding
the port's planning stack as test_scene_feeds_planning_stack feeds the
JAX package's: the port's ESDF equal to the JAX package's within 1e-5 m
(float32) and the same JPS path from the clear center to a free cell.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.ops.esdf import esdf_from_occupancy as jesdf
from alore_legged_manipulator_tpu.planner import frontend as jf
from alore_legged_manipulator_tpu.world import scene as js
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
from alore_legged_manipulator_tpu_torch.planner import frontend as tf
from alore_legged_manipulator_tpu_torch.world import scene as ts


@pytest.mark.parametrize("seed,n,size", [(3, 40, (20.0, 20.0)),
                                         (7, 25, (15.0, 15.0)),
                                         (11, 300, (50.0, 50.0))])
def test_height_field_bit_for_bit(seed, n, size):
    kw = dict(size=size, num_obstacles=n, seed=seed)
    got = ts.uniform_discrete_obstacles_terrain(
        ts.ObstacleTerrainConfig(**kw))
    ref = js.uniform_discrete_obstacles_terrain(
        js.ObstacleTerrainConfig(**kw))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("preset", ["sparse", "medium", "dense"])
def test_presets_bit_for_bit(preset):
    got = ts.make_scene(preset, seed=1, size=(30.0, 30.0))
    ref = js.make_scene(preset, seed=1, size=(30.0, 30.0))
    np.testing.assert_array_equal(got.height_field, ref.height_field)
    np.testing.assert_array_equal(got.occupancy, ref.occupancy)
    assert (got.lower, got.res, got.clear_center) == \
        (ref.lower, ref.res, ref.clear_center)
    carried = from_jax_numpy(ref)
    assert type(carried) is ts.Scene
    np.testing.assert_array_equal(carried.occupancy, got.occupancy)


def test_invariants():
    cfg = ts.ObstacleTerrainConfig(size=(20.0, 20.0), num_obstacles=40,
                                   obstacles_distance=2.0, seed=3,
                                   platform_width=2.0, border_width=0.0)
    hf = ts.uniform_discrete_obstacles_terrain(cfg)
    assert hf.shape == (200, 200) and hf.max() > 0.5
    assert np.all(hf[90:110, 90:110] == 0)
    s = ts.make_scene("sparse", seed=1, size=(30.0, 30.0))
    assert s.occupancy[0, :].all() and s.occupancy[:, -1].all()
    with pytest.raises(ValueError):
        ts.make_scene("ultra")


def test_esdf_root_is_correctly_rounded():
    """ops/esdf.py takes the root in float64 and rounds it once to
    float32: the correctly rounded float32 root (numpy's), on every
    device.  On the dense 500x500 scene torch's float32 root on the CPU
    is 1 ulp off in 16 cells of the inside field (the squares are exact
    integers), which is where the card and the CPU differed.  The whole
    field equals the JAX package's bit for bit."""
    from alore_legged_manipulator_tpu_torch.ops import esdf as te
    occ = torch.as_tensor(ts.make_scene("dense", seed=0).occupancy)
    res = torch.tensor(0.1)
    for mask in (occ, ~occ):
        H, W = mask.shape
        cap = torch.tensor(float(H * H + W * W))
        f = torch.where(mask, torch.zeros_like(cap), cap)
        d2 = torch.minimum(te._sq_dist_transform_1d(
            te._sq_dist_transform_1d(f).T).T, cap)
        ref = res * torch.from_numpy(np.sqrt(d2.numpy()))
        assert torch.equal(te._edt(mask, res), ref)
    got = esdf_from_occupancy(occ, torch.zeros(2), 0.1).dist.numpy()
    ref = np.asarray(jesdf(jnp.asarray(occ.numpy()), jnp.zeros(2), 0.1).dist)
    np.testing.assert_array_equal(got, ref)


def test_scene_feeds_planning_stack():
    s = ts.make_scene("sparse", seed=2, size=(20.0, 20.0))
    esdf = esdf_from_occupancy(torch.as_tensor(s.occupancy),
                               torch.zeros(2), s.res)
    ref = jesdf(jnp.asarray(s.occupancy), jnp.zeros(2), s.res)
    np.testing.assert_allclose(esdf.dist.numpy(), np.asarray(ref.dist),
                               rtol=0, atol=1e-5)
    blocked = esdf.dist.numpy() < 0.3
    assert np.array_equal(blocked, np.asarray(ref.dist) < 0.3)
    start = tf.world_to_grid(np.array([10.0, 10.0]), s.lower, s.res)
    free = np.argwhere(~blocked)
    d = np.abs(free - start).max(1)
    goal = tuple(free[(d > 30) & (d < 60)][0])
    cells = tf.jps_search(blocked.astype(np.uint8), start, goal)
    assert cells is not None and len(cells) >= 2
    np.testing.assert_array_equal(
        np.asarray(cells), np.asarray(jf.jps_search(blocked.astype(np.uint8),
                                                    start, goal)))
