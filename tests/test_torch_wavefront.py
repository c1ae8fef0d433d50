"""Port parity: octile wavefront front end and its two kernels.

The plain PyTorch versions (ops/wavefront.py of the port) must give the
same float32 field, bit for bit, as the JAX package's XLA field
(`octile_distance_field(impl="xla")`) and the same packed int32 word as
the Pallas kernel `wavefront_packed_pallas` run as the JAX tests run it
off-TPU (interpret mode); `wavefront_path` must give identical cells and
valid masks.  Tolerance: none -- the min-plus field, the policy argmin
and the run lengths are exact in f32.  The CUDA kernels are held to the
plain versions on the card by the tests marked `cuda`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.ops import wavefront as jw
from alore_legged_manipulator_tpu.ops.wavefront_pallas import (
    octile_distance_field_pallas, wavefront_packed_pallas)
from alore_legged_manipulator_tpu_torch.ops import wavefront as tw
from alore_legged_manipulator_tpu_torch.ops import wavefront_cuda as twc

# one intra-op thread: these tests run beside other test workers, and
# their many small tensor ops only slow down when threads oversubscribe
torch.set_num_threads(1)


def _grid(seed=0, shape=(48, 56), p=0.25):
    rng = np.random.default_rng(seed)
    return rng.random(shape) < p


def _lane(a, dtype=None):
    """numpy (H, W) / (2,) -> a one-lane torch batch."""
    t = torch.as_tensor(np.asarray(a))
    return (t if dtype is None else t.to(dtype))[None]


def _field_port(occ, goal):
    return tw.octile_distance_field(_lane(occ), _lane(goal), impl="torch")[0]


def _assert_field_and_packed(occ, goal):
    d_ref = np.asarray(jw.octile_distance_field(jnp.asarray(occ),
                                                jnp.asarray(goal), impl="xla"))
    d_pal, p_pal = wavefront_packed_pallas(jnp.asarray(occ), jnp.asarray(goal))
    d_t, p_t = tw.wavefront_packed_torch(_lane(occ), _lane(goal))
    np.testing.assert_array_equal(d_t[0].numpy(), d_ref)
    np.testing.assert_array_equal(d_t[0].numpy(), np.asarray(d_pal))
    np.testing.assert_array_equal(p_t[0].numpy(), np.asarray(p_pal))
    np.testing.assert_array_equal(_field_port(occ, goal).numpy(), d_ref)
    return d_ref


def test_open_grid_bit_identical():
    occ = np.zeros((40, 40), bool)
    _assert_field_and_packed(occ, np.array([7, 31]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_obstacles_bit_identical(seed):
    occ = _grid(seed)
    occ[3, 4] = False
    d = _assert_field_and_packed(occ, np.array([3, 4]))
    # the corner rule matters on these grids
    assert (d >= jw._BIG).sum() > occ.sum()


def test_blocked_goal_all_big():
    occ = _grid(5)
    occ[10, 10] = True
    goal = np.array([10, 10])
    d_t, p_t = tw.wavefront_packed_torch(_lane(occ), _lane(goal))
    assert bool((d_t >= jw._BIG).all())
    _, p_pal = wavefront_packed_pallas(jnp.asarray(occ), jnp.asarray(goal))
    np.testing.assert_array_equal(p_t[0].numpy(), np.asarray(p_pal))


def test_disconnected_region():
    occ = np.zeros((32, 32), bool)
    occ[:, 16] = True
    d = _assert_field_and_packed(occ, np.array([5, 25]))
    assert (d[:, :16] >= jw._BIG).all()


def _assert_paths(occ, goal, start, max_len):
    d_ref = jw.octile_distance_field(jnp.asarray(occ), jnp.asarray(goal),
                                     impl="xla")
    c_ref, v_ref = jw.extract_path(d_ref, jnp.asarray(occ),
                                   jnp.asarray(start), max_len)
    d_t, c_t, v_t = tw.wavefront_path(_lane(occ), _lane(goal), _lane(start),
                                      max_len)
    np.testing.assert_array_equal(d_t[0].numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(c_t[0].numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(v_t[0].numpy(), np.asarray(v_ref))
    # the per-cell descent of the port agrees with its turn descent
    c2, v2 = tw.extract_path(d_t, _lane(occ), _lane(start), max_len)
    np.testing.assert_array_equal(c2.numpy(), c_t.numpy())
    np.testing.assert_array_equal(v2.numpy(), v_t.numpy())
    return v_t[0].numpy()


def test_long_straight_runs_chain():
    """A 100x8 corridor: straight runs longer than the 16-cell cap chain."""
    occ = np.zeros((100, 8), bool)
    occ[:, 0] = occ[:, -1] = occ[0, :] = occ[-1, :] = True
    goal, start = np.array([97, 4]), np.array([2, 4])
    _assert_field_and_packed(occ, goal)
    valid = _assert_paths(occ, goal, start, 128)
    assert valid.sum() >= 90


def test_disconnected_start():
    occ = np.zeros((24, 24), bool)
    occ[:, 12] = True
    valid = _assert_paths(occ, np.array([5, 4]), np.array([5, 20]), 48)
    assert valid.sum() == 1


def test_wavefront_path_random_grids():
    rng = np.random.default_rng(7)
    for _ in range(6):
        occ = rng.random((40, 40)) < 0.25
        occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
        goal = rng.integers(1, 39, 2)
        start = rng.integers(1, 39, 2)
        occ[tuple(goal)] = occ[tuple(start)] = False
        _assert_paths(occ, goal, start, 96)


def test_fleet_lanes_match_single_lanes():
    """Lanes are independent: a batch gives each lane its one-lane result
    (the turn descent freezes finished lanes while others go on)."""
    B = 5
    occ = np.stack([_grid(s, (30, 34)) for s in range(B)])
    goals = np.array([[2, 2], [28, 3], [15, 17], [4, 30], [20, 20]])
    starts = np.array([[27, 30], [3, 31], [1, 1], [25, 2], [20, 21]])
    for b in range(B):
        occ[b, goals[b, 0], goals[b, 1]] = False
        occ[b, starts[b, 0], starts[b, 1]] = False
    d, c, v = tw.wavefront_path(torch.as_tensor(occ), torch.as_tensor(goals),
                                torch.as_tensor(starts), 80)
    for b in range(B):
        d1, c1, v1 = tw.wavefront_path(_lane(occ[b]), _lane(goals[b]),
                                       _lane(starts[b]), 80)
        np.testing.assert_array_equal(d[b].numpy(), d1[0].numpy())
        np.testing.assert_array_equal(c[b].numpy(), c1[0].numpy())
        np.testing.assert_array_equal(v[b].numpy(), v1[0].numpy())


def test_field_kernel_twin_matches_pallas_field():
    occ = _grid(3)
    occ[2, 2] = False
    ref = octile_distance_field_pallas(jnp.asarray(occ), jnp.asarray([2, 2]))
    np.testing.assert_array_equal(_field_port(occ, np.array([2, 2])).numpy(),
                                  np.asarray(ref))


def test_trapezoid_profiles_match():
    rng = np.random.default_rng(1)
    length = rng.uniform(0.01, 12.0, 64)
    curt = rng.uniform(0.0, 8.0, 64)
    sv = rng.uniform(0.0, 1.0, 64)
    ref_d = jw._trapezoid_duration(jnp.asarray(length), jnp.asarray(sv),
                                   3.0, 2.0)
    ref_l = jw._trapezoid_length(jnp.asarray(curt), jnp.asarray(length),
                                 jnp.asarray(sv), 3.0, 2.0)
    got_d = tw._trapezoid_duration(torch.as_tensor(length),
                                   torch.as_tensor(sv), 3.0, 2.0)
    got_l = tw._trapezoid_length(torch.as_tensor(curt),
                                 torch.as_tensor(length),
                                 torch.as_tensor(sv), 3.0, 2.0)
    # same f64 formulas, evaluated in the same order
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), rtol=0,
                               atol=1e-12)


def test_impl_cuda_on_cpu_tensor_raises():
    occ = _lane(np.zeros((8, 8), bool))
    goal = _lane(np.array([1, 1]))
    with pytest.raises(ValueError):
        tw.octile_distance_field(occ, goal, impl="cuda")
    with pytest.raises(ValueError):
        tw.wavefront_path(occ, goal, goal, 8, impl="cuda")
    with pytest.raises(ValueError):
        tw.octile_distance_field(occ, goal, impl="xla")
    with pytest.raises(ValueError):
        twc.wavefront_packed_cuda(occ, goal)


def test_shared_memory_budget():
    """10 B per cell: the mission's 80x80 and the bench's 100x100 grids fit
    in Hopper's 227 KB of dynamic shared memory; 160x160 does not."""
    assert twc.smem_bytes(80, 80) == 64_000
    assert twc.smem_bytes(100, 100) == 100_000
    assert twc.smem_bytes(160, 160) > twc.MAX_SMEM_BYTES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seed", [((80, 80), 0), ((100, 100), 1),
                                        ((100, 8), 2)])
def test_kernels_match_plain_on_card(cuda_device, shape, seed):
    rng = np.random.default_rng(seed)
    B = 8
    occ = rng.random((B, *shape)) < 0.2
    goals = np.stack([rng.integers(0, shape[0], B),
                      rng.integers(0, shape[1], B)], 1)
    occ[np.arange(B), goals[:, 0], goals[:, 1]] = False
    blk = torch.as_tensor(occ, device=cuda_device)
    g = torch.as_tensor(goals, device=cuda_device)
    d_k, p_k = twc.wavefront_packed_cuda(blk, g)
    d_p, p_p = tw.wavefront_packed_torch(blk, g)
    assert torch.equal(d_k, d_p) and torch.equal(p_k, p_p)
    assert torch.equal(twc.octile_distance_field_cuda(blk, g), d_p)


@pytest.mark.cuda
def test_oversized_grid_raises_on_card(cuda_device):
    blk = torch.zeros((1, 160, 160), dtype=torch.bool, device=cuda_device)
    g = torch.zeros((1, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        twc.wavefront_packed_cuda(blk, g)
