"""Port parity: octile wavefront front end and its two kernels.

The plain PyTorch versions (ops/wavefront.py of the port) must give the
same float32 field, bit for bit, as the JAX package's XLA field
(`octile_distance_field(impl="xla")`) and the same packed int32 word as
the Pallas kernel `wavefront_packed_pallas` run as the JAX tests run it
off-TPU (interpret mode); `wavefront_path` must give identical cells and
valid masks.  Tolerance: none -- the min-plus field, the policy argmin
and the run lengths are exact in f32.  The CUDA kernels are held to the
plain versions on the card by the tests marked `cuda`; their schedule
(register strips, active-front sweeps, the goal's strip as the only
seed, the block-wide vote) is held here by a numpy model of it against
the plain relaxation, field and sweep count, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
    """8 B per bordered cell and 12 B per bordered row: the mission's 80x80
    and the bench's 100x100 grids fit three and two blocks to an SM, a
    160x160 grid fits in Hopper's 232,448 B of dynamic shared memory, and
    162x162 is the first square grid that does not."""
    assert twc.smem_bytes(80, 80) == 82 * (8 * 92 + 12) == 61_336
    assert twc.smem_bytes(100, 100) == 102 * (8 * 108 + 12) == 89_352
    assert 3 * (twc.smem_bytes(80, 80) + 1024) <= 233_472
    assert 2 * (twc.smem_bytes(100, 100) + 1024) <= 233_472
    assert twc.smem_bytes(160, 160) == 230_040 <= twc.MAX_SMEM_BYTES
    assert twc.smem_bytes(161, 161) <= twc.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="162x162"):
        twc.smem_bytes(162, 162)


@pytest.mark.parametrize("shape,strip,threads", [
    ((80, 80), 20, 320), ((100, 100), 20, 512), ((150, 150), 28, 928),
    ((8, 8), 8, 32), ((50, 83), 8, 576), ((83, 50), 8, 608),
    ((900, 20), 20, 928)])
def test_strip_geometry_picks(shape, strip, threads):
    g = twc.strip_geometry(*shape)
    assert (g.strip, g.threads) == (strip, threads)
    assert g.threads <= twc.MAX_THREADS and g.threads % 32 == 0
    assert g.strips_per_row * g.strip >= shape[1] and g.strips_per_row <= 30
    assert g.pitch % 4 == 0 and g.strip % 4 == 0      # float4 loads legal
    assert g.smem == (shape[0] + 2) * (8 * g.pitch + 12)


def test_strip_geometry_few_lanes_takes_short_strips():
    """No more lanes than two per SM: every lane is resident anyway, so
    the shortest strip that pads no more is taken (more threads a lane);
    the shared memory a lane needs is the same."""
    many, few = twc.strip_geometry(80, 80), twc.strip_geometry(80, 80, None, True)
    assert (many.strip, many.threads) == (20, 320)
    assert (few.strip, few.threads) == (8, 800)
    assert few.smem == many.smem
    assert twc.strip_geometry(100, 100, None, True).strip == 20


def test_strip_geometry_refuses_what_fits_no_block():
    with pytest.raises(ValueError):
        twc.strip_geometry(2000, 8)           # 2000 rows need 2000 threads
    with pytest.raises(ValueError):
        twc.strip_geometry(80, 80, strip=10)  # no such instantiation
    with pytest.raises(ValueError):
        twc.strip_geometry(150, 150, strip=20)  # 1200 threads
    assert twc.strip_geometry(80, 80, strip=8).threads == 800


def test_wrapper_builds_no_start_field():
    """The kernel sets its own start field from the goal cells."""
    assert not hasattr(twc, "_dist0")


# --- a relaxation cut short by n_iters ---

def _serpentine(H, W):
    """Walls on every other row, the gap at alternating ends: the field
    needs far more than H + W sweeps."""
    occ = np.zeros((H, W), bool)
    for n, i in enumerate(range(1, H, 2)):
        occ[i, :] = True
        occ[i, W - 1 if n % 2 == 0 else 0] = False
    return occ


@pytest.mark.parametrize("n_iters", [9, 40])
def test_capped_relaxation_bit_identical(n_iters):
    occ, goal = _serpentine(16, 14), np.array([0, 0])
    full = tw.octile_distance_field_torch(_lane(occ), _lane(goal), 1000)[0]
    d_t, p_t, sw = tw.wavefront_packed_torch(_lane(occ), _lane(goal), n_iters,
                                             return_sweeps=True)
    # the cap really cuts this relaxation short
    assert int(sw[0]) == n_iters
    assert int((d_t < jw._BIG).sum()) < int((full < jw._BIG).sum())
    d_ref = jw.octile_distance_field(jnp.asarray(occ), jnp.asarray(goal),
                                     n_iters=n_iters, impl="xla")
    d_pal, p_pal = wavefront_packed_pallas(jnp.asarray(occ), jnp.asarray(goal),
                                           n_iters=n_iters)
    d_fld = octile_distance_field_pallas(jnp.asarray(occ), jnp.asarray(goal),
                                         n_iters=n_iters)
    np.testing.assert_array_equal(d_t[0].numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(d_t[0].numpy(), np.asarray(d_pal))
    np.testing.assert_array_equal(d_t[0].numpy(), np.asarray(d_fld))
    np.testing.assert_array_equal(p_t[0].numpy(), np.asarray(p_pal))
    d_f = tw.octile_distance_field(_lane(occ), _lane(goal), n_iters,
                                   impl="torch")
    np.testing.assert_array_equal(d_f[0].numpy(), np.asarray(d_ref))


def test_sweep_counts_per_lane():
    """Each lane counts up to and including its first sweep without a
    change, whatever the other lanes of the batch still do."""
    occ = np.stack([np.zeros((12, 12), bool), _serpentine(12, 12),
                    np.ones((12, 12), bool)])
    goals = np.array([[0, 0], [0, 0], [3, 3]])
    _, sw = tw.octile_distance_field_torch(torch.as_tensor(occ),
                                           torch.as_tensor(goals), 500,
                                           return_sweeps=True)
    for b in range(3):
        _, one = tw.octile_distance_field_torch(_lane(occ[b]), _lane(goals[b]),
                                                500, return_sweeps=True)
        assert int(sw[b]) == int(one[0])
    assert sw.tolist() == [12, 67, 1]
    _, capped = tw.octile_distance_field_torch(torch.as_tensor(occ),
                                               torch.as_tensor(goals), 20,
                                               return_sweeps=True)
    assert capped.tolist() == [12, 20, 1]


# --- the goal outside the grid, and on a blocked cell ---

@pytest.mark.parametrize("goal", [(-1, 3), (-20, -24), (-21, 3), (20, 3),
                                  (2, 24), (2, -25), (1000, 1000), (5, 5)])
def test_goal_outside_grid_or_blocked_matches_jax(goal):
    """A negative index counts from the end once; a goal still outside the
    grid, or on a blocked cell ((5, 5) here), leaves the field at 1e9."""
    occ = _grid(11, (20, 24), 0.2)
    occ[5, 5] = True
    occ[19, 3] = occ[0, 0] = False
    goal = np.array(goal)
    d_ref = np.asarray(jw.octile_distance_field(jnp.asarray(occ),
                                                jnp.asarray(goal), impl="xla"))
    d_pal, p_pal = wavefront_packed_pallas(jnp.asarray(occ), jnp.asarray(goal))
    d_t, p_t, sw = tw.wavefront_packed_torch(_lane(occ), _lane(goal),
                                             return_sweeps=True)
    np.testing.assert_array_equal(d_t[0].numpy(), d_ref)
    np.testing.assert_array_equal(d_t[0].numpy(), np.asarray(d_pal))
    np.testing.assert_array_equal(p_t[0].numpy(), np.asarray(p_pal))
    reached = bool((d_ref < jw._BIG).any())
    assert reached == (tuple(goal) in ((-1, 3), (-20, -24)))
    if not reached:
        assert int(sw[0]) == 1


# --- numpy model of the CUDA kernel's schedule ---

def _model_relax(occ, goal, S, n_iters):
    """The schedule of csrc/wavefront.cu for one lane, in numpy.

    Threads own strips of S cells of a row and keep them in `regs`; the
    two bordered field buffers are written only by threads that recompute;
    a thread recomputes only if its own or a neighbouring strip's changed
    bit (one word per row, three rotating buffers) was set in the sweep
    before; the start field flags the goal's strip alone; out-of-grid
    neighbours are read from the 1e9 border without a mask; the lane ends
    at the first sweep in which no strip changed.  Returns (field, sweeps).
    """
    H, W = occ.shape
    geo = twc._geometry(H, W, S)
    NS, P, R, pad = geo.strips_per_row, geo.pitch, H + 2, 4
    big, one, sq2 = np.float32(1e9), np.float32(1.0), np.float32(tw.SQ2)
    cols = slice(pad, pad + NS * S)

    def cells(buf, di, dj):                   # neighbour (i + di, j + dj)
        return buf[1 + di:1 + di + H, pad + dj:pad + dj + NS * S]

    blk = np.ones((R, P), bool)               # the border counts as blocked
    blk[1:H + 1, pad:pad + W] = occ
    mb = cells(blk, 0, 0)
    corner = {(di, dj): cells(blk, di, 0) & cells(blk, 0, dj)
              for di in (1, -1) for dj in (1, -1)}

    bufs = [np.full((R, P), big, np.float32) for _ in range(2)]
    flags = np.zeros((3, R), np.int64)
    regs = np.full((H, NS * S), big, np.float32)
    gi, gj = (int(g) + (n if g < 0 else 0) for g, n in zip(goal, (H, W)))
    if 0 <= gi < H and 0 <= gj < W and not occ[gi, gj]:
        regs[gi, gj] = 0.0
        for b in bufs:
            b[gi + 1, pad + gj] = 0.0
        flags[0, gi + 1] = 1 << (gj // S + 1)

    cur, nxt, fr, fw, fc = 0, 1, 0, 1, 2
    sweeps = 0
    for _ in range(n_iters):
        c = bufs[cur]
        # registers and the read buffer agree on every strip, active or not
        assert np.array_equal(regs, c[1:H + 1, cols])
        words = flags[fr]
        near = words[:-2] | words[1:-1] | words[2:]
        active = ((near[:, None] >> np.arange(NS)[None, :]) & 7) != 0
        flags[fc, 1:H + 1] = 0
        ms = np.minimum(np.minimum(cells(c, 1, 0), cells(c, -1, 0)),
                        np.minimum(cells(c, 0, 1), cells(c, 0, -1)))
        mo = None
        for d, bad in corner.items():
            cand = np.where(bad, big, cells(c, *d))
            mo = cand if mo is None else np.minimum(mo, cand)
        best = np.minimum(regs, np.minimum(ms + one, mo + sq2))
        best = np.where(mb, big, best)
        act_cells = np.repeat(active, S, axis=1)
        changed = ((best < regs) & act_cells).reshape(H, NS, S).any(-1)
        regs = np.where(act_cells, best, regs)
        bufs[nxt][1:H + 1, cols] = np.where(act_cells, best,
                                            bufs[nxt][1:H + 1, cols])
        flags[fw, 1:H + 1] |= (changed.astype(np.int64)
                               << (np.arange(NS) + 1)[None, :]).sum(1)
        cur, nxt = nxt, cur
        fr, fw, fc = fw, fc, fr
        sweeps += 1
        if not changed.any():
            break
    return bufs[cur][1:H + 1, pad:pad + W].copy(), sweeps


def _plain_relax(occ, goal, n_iters):
    blk, g = _lane(occ), _lane(np.asarray(goal))
    d, sw = tw._relax(tw._dist0(blk, g), blk, tw._invalid_masks(blk), n_iters,
                      return_sweeps=True)
    return d[0].numpy(), int(sw[0])


def _assert_model(occ, goal, S, n_iters):
    d_m, s_m = _model_relax(occ, goal, S, n_iters)
    d_p, s_p = _plain_relax(occ, goal, n_iters)
    np.testing.assert_array_equal(d_m, d_p)
    assert s_m == s_p


@pytest.mark.parametrize("S", [4, 8, 10, 12, 20, 28])
@pytest.mark.parametrize("n_iters", [13, 1000])
def test_kernel_schedule_model_serpentine(S, n_iters):
    _assert_model(_serpentine(14, 23), (0, 0), S, n_iters)


@pytest.mark.parametrize("shape,S", [((30, 50), 8), ((21, 83), 10),
                                     ((21, 83), 12), ((40, 40), 20),
                                     ((7, 3), 4), ((1, 30), 8), ((30, 1), 20)])
def test_kernel_schedule_model_random(shape, S):
    rng = np.random.default_rng(shape[0] * 100 + S)
    for p in (0.0, 0.2, 0.45):
        occ = rng.random(shape) < p
        goal = (int(rng.integers(0, shape[0])), int(rng.integers(0, shape[1])))
        occ[goal] = False
        _assert_model(occ, goal, S, sum(shape))
        _assert_model(occ, goal, S, max(1, sum(shape) // 5))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(S=st.sampled_from([4, 8, 10]), H=st.integers(1, 24),
       W=st.sampled_from([5, 24, 50, 83]), p=st.floats(0.0, 0.5),
       seed=st.integers(0, 2 ** 16), cap=st.one_of(st.none(),
                                                    st.integers(0, 40)),
       goal_off=st.sampled_from([0, 0, 0, -1, 1]))
def test_kernel_schedule_model_hypothesis(S, H, W, p, seed, cap, goal_off):
    """Random grids, ragged widths, capped and uncapped, the goal free,
    blocked or outside: the model's field and sweep count are the plain
    relaxation's."""
    rng = np.random.default_rng(seed)
    occ = rng.random((H, W)) < p
    goal = [int(rng.integers(0, H)), int(rng.integers(0, W))]
    if goal_off < 0:
        goal[1] -= W                          # counts from the end
    elif goal_off > 0:
        goal[0] += H                          # outside: nothing is set
    _assert_model(occ, tuple(goal), S, H + W if cap is None else cap)


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
    d_k, p_k, s_k = twc.wavefront_packed_cuda(blk, g, return_sweeps=True)
    d_p, p_p, s_p = tw.wavefront_packed_torch(blk, g, return_sweeps=True)
    assert torch.equal(d_k, d_p) and torch.equal(p_k, p_p)
    assert torch.equal(s_k, s_p)
    assert torch.equal(twc.octile_distance_field_cuda(blk, g), d_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n_iters", [0, 9, 40, 1000])
def test_capped_kernels_match_plain_on_card(cuda_device, n_iters):
    blk = torch.as_tensor(_serpentine(16, 14)[None], device=cuda_device)
    g = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    d_p, p_p, s_p = tw.wavefront_packed_torch(blk, g, n_iters,
                                              return_sweeps=True)
    for strip in twc.STRIPS:
        d_k, p_k, s_k = twc.wavefront_packed_cuda(blk, g, n_iters,
                                                  return_sweeps=True,
                                                  strip=strip)
        assert torch.equal(d_k, d_p) and torch.equal(p_k, p_p)
        assert torch.equal(s_k, s_p)


@pytest.mark.cuda
def test_goal_outside_grid_on_card(cuda_device):
    occ = _grid(11, (20, 24), 0.2)
    occ[5, 5] = True
    goals = np.array([[-1, 3], [-20, -24], [-21, 3], [20, 3], [2, 24],
                      [2, -25], [1000, 1000], [5, 5]])
    blk = torch.as_tensor(np.broadcast_to(occ, (8, 20, 24)).copy(),
                          device=cuda_device)
    g = torch.as_tensor(goals, device=cuda_device)
    d_k, p_k = twc.wavefront_packed_cuda(blk, g)
    d_p, p_p = tw.wavefront_packed_torch(blk, g)
    assert torch.equal(d_k, d_p) and torch.equal(p_k, p_p)


@pytest.mark.cuda
def test_oversized_grid_raises_on_card(cuda_device):
    blk = torch.zeros((1, 162, 162), dtype=torch.bool, device=cuda_device)
    g = torch.zeros((1, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        twc.wavefront_packed_cuda(blk, g)
