"""Port parity: the MINCO back end (stage costs, gradients, plan_backend).

The same numpy-built FlatTraj lanes (carried over with
`convert.from_jax_numpy`) go through the JAX package's vmapped functions
and the port's batched ones, in float64.

* `stage1_cost`, `stage2_cost` and their gradients agree to 1e-10
  (relative to max(1, |value|)): the same formulas, autodiff on both
  sides; summation order differs.
* `plan_backend` is judged on quality, not iterates: last-bit differences
  send the line searches to different valid optima, so each lane must be
  collision-free, reach the goal within 1e-2 m, and take a total
  duration within 5% of the JAX plan's.  The lanes cover both branches
  of the JAX `lax.cond`s: a short path (the larger `past` window) and a
  cut path (the cut ALM schedule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.ops.esdf import (
    esdf_from_occupancy as j_esdf_from_occupancy)
from alore_legged_manipulator_tpu.planner import backend as jb
from alore_legged_manipulator_tpu.planner.flat_traj import FlatTraj as JFlat
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
from alore_legged_manipulator_tpu_torch.planner import backend as tb

# one intra-op thread: these tests run beside other test workers, and
# their many small tensor ops only slow down when threads oversubscribe
torch.set_num_threads(1)

N_PIECES = 6


def _occ():
    occ = np.zeros((80, 80), bool)
    occ[30:40, 44:50] = True
    return occ


def _flats(goals, start=(1.0, 4.0), if_cut=None):
    """Straight-line FlatTraj lanes (bench.py's back-end scenario)."""
    start = np.asarray(start, float)
    B = len(goals)
    fr = np.arange(1, N_PIECES) / N_PIECES
    out = {k: [] for k in JFlat._fields}
    for g in np.asarray(goals, float):
        d = g - start
        L = float(np.hypot(*d))
        yaw = float(np.arctan2(d[1], d[0]))
        pos = np.concatenate([start[None] + fr[:, None] * d[None], g[None]])
        out["inner_yaw_s"].append(np.stack([np.full(N_PIECES - 1, yaw), L * fr]))
        out["init_piece_time"].append(np.float64(max(L / 3.0 * 2.0, 1.0)
                                                 / N_PIECES))
        out["inner_positions"].append(
            np.concatenate([pos, np.full((N_PIECES, 1), yaw)], 1))
        out["start_state"].append(np.array([[yaw, 0.0, 0.0], [0.0, 0.0, 0.0]]))
        out["final_state"].append(np.array([[yaw, 0.0, 0.0], [L, 0.0, 0.0]]))
        out["start_xytheta"].append(np.array([*start, yaw]))
        out["final_xytheta"].append(np.array([*g, yaw]))
    out["if_cut"] = (np.zeros(B, bool) if if_cut is None
                     else np.asarray(if_cut, bool))
    return JFlat(**{k: np.stack(v) if isinstance(v, list) else v
                    for k, v in out.items()})


GOALS = np.array([[6.0, 4.0],      # across the block's flank
                  [6.5, 4.8],      # through the block
                  [5.2, 3.1],
                  [1.3, 4.1]])     # short: |L| < shot_path_horizon
IF_CUT = [False, False, True, False]


def _x_samples(flat_np, n_samples=3, seed=0):
    """Decision vectors near each lane's initial point (B, n)."""
    rng = np.random.default_rng(seed)
    tau0 = np.asarray(jb.real_to_virtual_time(
        jnp.asarray(np.repeat(flat_np.init_piece_time[:, None], N_PIECES, 1))))
    x0 = np.asarray(jax.vmap(jb.pack_vars)(
        jnp.asarray(flat_np.inner_yaw_s),
        jnp.asarray(flat_np.final_state[:, 1, 0]), jnp.asarray(tau0)))
    x0 = np.array(x0)
    return [x0] + [x0 + 0.05 * rng.standard_normal(x0.shape)
                   for _ in range(n_samples - 1)]


def _assert_rel(got, ref, tol=1e-10):
    ref = np.asarray(ref)
    scale = np.maximum(1.0, np.abs(ref).max(axis=-1, keepdims=True)
                       if ref.ndim > 1 else np.abs(ref))
    np.testing.assert_array_less(np.abs(np.asarray(got) - ref) / scale, tol)


def test_stage1_cost_and_grad():
    flat_np = _flats(GOALS, if_cut=IF_CUT)
    cfg_j, cfg_t = jb.BackendConfig(), tb.BackendConfig()
    flat_t = from_jax_numpy(flat_np)
    vg = jax.vmap(jax.value_and_grad(lambda x, f: jb.stage1_cost(x, f, cfg_j)))
    for x in _x_samples(flat_np):
        f_ref, g_ref = vg(jnp.asarray(x), jax.tree.map(jnp.asarray, flat_np))
        f, g, _ = tb._value_and_grad(lambda q: tb.stage1_cost(q, flat_t, cfg_t),
                                     torch.as_tensor(x))
        _assert_rel(f.numpy(), f_ref)
        _assert_rel(g.numpy(), g_ref)


def test_stage2_cost_and_grad():
    flat_np = _flats(GOALS, if_cut=IF_CUT)
    cfg_j, cfg_t = jb.BackendConfig(), tb.BackendConfig()
    e_j = j_esdf_from_occupancy(jnp.asarray(_occ()), jnp.zeros(2), 0.1)
    e_t = esdf_from_occupancy(torch.as_tensor(_occ()), torch.zeros(2), 0.1)
    B = len(GOALS)
    rng = np.random.default_rng(4)
    safe = rng.uniform(0.3, 0.6, B)
    lam = rng.standard_normal((B, 2))
    rho = rng.uniform(1e3, 1e5, (B, 2))
    flat_t = from_jax_numpy(flat_np)

    def one(x, f, s, l, r):
        c, h = jb.stage2_cost_aux(x, f, e_j, s, l, r, cfg_j)
        return c, h

    vg = jax.vmap(jax.value_and_grad(one, has_aux=True))
    for x in _x_samples(flat_np, seed=1):
        (f_ref, h_ref), g_ref = vg(jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, flat_np),
                                   jnp.asarray(safe), jnp.asarray(lam),
                                   jnp.asarray(rho))
        f, g, h = tb._value_and_grad(
            lambda q: tb.stage2_cost_aux(q, flat_t, e_t, torch.as_tensor(safe),
                                         torch.as_tensor(lam),
                                         torch.as_tensor(rho), cfg_t),
            torch.as_tensor(x))
        _assert_rel(f.numpy(), f_ref)
        _assert_rel(g.numpy(), g_ref)
        _assert_rel(h.detach().numpy(), h_ref)
        # the collision term is live at these points
        assert float(tb.collision_penalty(
            *_nodes(torch.as_tensor(x), flat_t, cfg_t), e_t,
            torch.as_tensor(safe), cfg_t).max()) > 0.0


def _nodes(x, flat_t, cfg):
    inner, tail_s, tau = tb.unpack_vars(x, flat_t.num_pieces)
    coeffs, times = tb._spline(flat_t, inner, tail_s, tau)
    from alore_legged_manipulator_tpu_torch.core.flow import (
        simpson_flow_positions)
    node_xy, _, samples = simpson_flow_positions(
        coeffs, times, flat_t.start_xytheta[:, :2], tb._xv(cfg),
        cfg.sparse_resolution)
    return node_xy, samples, times


def test_pack_unpack_and_time_maps():
    rng = np.random.default_rng(2)
    inner = rng.standard_normal((3, 2, N_PIECES - 1))
    tail = rng.standard_normal(3)
    tau = rng.standard_normal((3, N_PIECES))
    x_ref = np.asarray(jax.vmap(jb.pack_vars)(*map(jnp.asarray,
                                                   (inner, tail, tau))))
    x = tb.pack_vars(*map(torch.as_tensor, (inner, tail, tau)))
    np.testing.assert_array_equal(x.numpy(), x_ref)
    for a, b in zip(tb.unpack_vars(x, N_PIECES), (inner, tail, tau)):
        np.testing.assert_array_equal(a.numpy(), b)
    T = np.array([0.1, 0.5, 1.0, 2.0, 7.3])
    np.testing.assert_allclose(
        tb.real_to_virtual_time(torch.as_tensor(T)).numpy(),
        np.asarray(jb.real_to_virtual_time(jnp.asarray(T))), rtol=0,
        atol=1e-15)
    np.testing.assert_allclose(
        tb.virtual_to_real_time(torch.as_tensor(tau)).numpy(),
        np.asarray(jb.virtual_to_real_time(jnp.asarray(tau))), rtol=0,
        atol=1e-15)


@pytest.fixture(scope="module")
def plans():
    flat_np = _flats(GOALS, if_cut=IF_CUT)
    e_j = j_esdf_from_occupancy(jnp.asarray(_occ()), jnp.zeros(2), 0.1)
    e_t = esdf_from_occupancy(torch.as_tensor(_occ()), torch.zeros(2), 0.1)
    cfg_j = jb.BackendConfig()
    ref = jax.jit(jax.vmap(lambda f: jb.plan_backend(f, e_j, cfg_j)))(
        jax.tree.map(jnp.asarray, flat_np))
    got = tb.plan_backend(from_jax_numpy(flat_np), e_t, tb.BackendConfig())
    return jax.tree.map(np.asarray, ref), got


def test_plan_backend_quality(plans):
    ref, got = plans
    _quality(got, ref)


def test_plan_backend_lanes_independent(plans):
    """A lane planned alone gives the lane's result in the batch."""
    _, got = plans
    flat_np = _flats(GOALS, if_cut=IF_CUT)
    e_t = esdf_from_occupancy(torch.as_tensor(_occ()), torch.zeros(2), 0.1)
    one = jax.tree.map(lambda a: a[1:2], flat_np)
    alone = tb.plan_backend(from_jax_numpy(one), e_t, tb.BackendConfig())
    np.testing.assert_allclose(alone.coeffs.numpy(), got.coeffs[1:2].numpy(),
                               rtol=0, atol=1e-9)
    assert int(alone.replans[0]) == int(got.replans[1])


def _quality(got, ref):
    assert got.coeffs.shape == ref.coeffs.shape
    assert not bool(got.collision.any())
    assert not bool(np.any(ref.collision))
    err = torch.linalg.vector_norm(got.final_xy_err, dim=-1).numpy()
    # a cut lane runs the cut ALM schedule, whose tolerance is 0.5 m
    cut = np.asarray(IF_CUT)
    assert (err[~cut] < 1e-2).all(), err
    assert (err[cut] < tb.BackendConfig().cut_alm.tolerance).all(), err
    dur = got.times.sum(-1).numpy()
    dur_ref = ref.times.sum(-1)
    np.testing.assert_array_less(np.abs(dur - dur_ref) / dur_ref, 0.05)


@pytest.mark.parametrize("variant", [dict(solver_direction="compact"),
                                     dict(flat_bfgs=False)],
                         ids=["compact", "nested"])
def test_plan_backend_variant_quality(variant):
    """The compact direction and the nested `lbfgs_minimize` path, held to
    the JAX plan under the same option as `test_plan_backend_quality`
    holds the default: collision-free, goal within 1e-2 m (cut lane: the
    cut schedule's tolerance), total duration within 5%."""
    flat_np = _flats(GOALS, if_cut=IF_CUT)
    e_j = j_esdf_from_occupancy(jnp.asarray(_occ()), jnp.zeros(2), 0.1)
    e_t = esdf_from_occupancy(torch.as_tensor(_occ()), torch.zeros(2), 0.1)
    cfg_j = jb.BackendConfig(**variant)
    ref = jax.jit(jax.vmap(lambda f: jb.plan_backend(f, e_j, cfg_j)))(
        jax.tree.map(jnp.asarray, flat_np))
    got = tb.plan_backend(from_jax_numpy(flat_np), e_t,
                          tb.BackendConfig(**variant))
    _quality(got, jax.tree.map(np.asarray, ref))


@pytest.mark.parametrize("variant", [dict(solver_direction="ring"),
                                     dict(solver_direction="compact"),
                                     dict(solver_direction="dense"),
                                     dict(flat_bfgs=False)],
                         ids=["ring", "compact", "dense", "nested"])
def test_alm_stage_first_trips_match_jax(variant):
    """Stage 2 from the same start, stopped after 4 accepted iterations
    of one inner solve: the decision vectors agree to 1e-7 (relative to
    max(1, |x|)) and the iteration counts are equal.  Later trips may
    part after last-bit differences in a line-search test."""
    flat_np = _flats(GOALS, if_cut=IF_CUT)
    e_j = j_esdf_from_occupancy(jnp.asarray(_occ()), jnp.zeros(2), 0.1)
    e_t = esdf_from_occupancy(torch.as_tensor(_occ()), torch.zeros(2), 0.1)
    B = len(GOALS)
    x0 = _x_samples(flat_np)[0]
    safe = np.full(B, 0.4)
    tw = np.full(B, jb.BackendConfig().weights.time_weight)

    def cfg_of(mod):
        c = mod.BackendConfig(**variant)
        return c._replace(lbfgs=c.lbfgs._replace(max_iterations=4),
                          alm=c.alm._replace(max_outer=1))

    cfg_j, cfg_t = cfg_of(jb), cfg_of(tb)
    x_ref, k_ref = jax.jit(jax.vmap(
        lambda x, f, s, t: jb._alm_stage(x, f, e_j, s, cfg_j, cfg_j.alm, t)))(
            jnp.asarray(x0), jax.tree.map(jnp.asarray, flat_np),
            jnp.asarray(safe), jnp.asarray(tw))
    x, k = tb._alm_stage(torch.as_tensor(x0), from_jax_numpy(flat_np), e_t,
                         torch.as_tensor(safe), cfg_t, cfg_t.alm,
                         torch.as_tensor(tw))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))
    _assert_rel(x.numpy(), np.asarray(x_ref), tol=1e-7)
