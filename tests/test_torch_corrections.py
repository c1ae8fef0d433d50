"""Port parity: correction legs, the straight front end and the mission
time models.

The scenario of tests/test_mission_fleet.py::test_host_redispatch_correction:
B=2 missions of K=1 object on an empty 80x80 map, push_ticks=220 (2.2 s),
float64, plant noise off (the only random input; `jax.random` streams are
not reproduced by the port).  Lane 0's 5 m leg misses that budget, lane
1's short leg delivers.  The JAX fleet result is converted with
`from_jax_numpy` and handed to the port's `correct_missed_legs`, so both
sides correct from the very same state.  The correction rounds on the
contact plant are held to JAX in tests/test_torch_closed_loop_physics.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.core.dynamics import ICRParams as JICR
from alore_legged_manipulator_tpu.ops.esdf import (
    esdf_from_occupancy as j_esdf_from_occupancy)
from alore_legged_manipulator_tpu.runtime import closed_loop as jcl
from alore_legged_manipulator_tpu.runtime import mission_fleet as jmf
from alore_legged_manipulator_tpu.world import plant as jpl
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams as TICR
from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
from alore_legged_manipulator_tpu_torch.runtime import closed_loop as tcl
from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as tmf
from alore_legged_manipulator_tpu_torch.world import plant as tpl

torch.set_num_threads(1)

ITEMS = np.array([[[1.0, 4.0]], [[2.0, 2.0]]])
TARGETS = np.array([[[6.0, 4.0]], [[3.5, 2.0]]])
ROBOT0 = np.tile(np.array([0.5, 4.0, 0.0]), (2, 1))
ICR = (-0.3, 0.3, 0.2)
CORR = 220


def _esdfs():
    occ = np.zeros((80, 80), bool)
    return (j_esdf_from_occupancy(jnp.asarray(occ), jnp.zeros(2), 0.1),
            esdf_from_occupancy(torch.as_tensor(occ), torch.zeros(2), 0.1))


def _cfgs(**kw):
    kw = dict(approach_ticks=300, push_ticks=220, **kw)
    return (jmf.MissionFleetConfig(
                loop=jcl.LoopConfig(plant=jpl.PlantConfig(add_noise=False)),
                **kw),
            tmf.MissionFleetConfig(
                loop=tcl.LoopConfig(plant=tpl.PlantConfig(add_noise=False)),
                **kw))


@pytest.fixture(scope="module")
def corrected():
    """(JAX fleet result, JAX corrected, port corrected from the converted
    JAX result, counts)."""
    e_j, e_t = _esdfs()
    cfg_j, cfg_t = _cfgs()
    res = jax.jit(jax.vmap(lambda i, t, r: jmf.run_mission(
        i, t, r, e_j, JICR(*ICR), cfg_j)))(
            jnp.asarray(ITEMS), jnp.asarray(TARGETS), jnp.asarray(ROBOT0))
    fixed_j, n_j = jmf.correct_missed_legs(res, jnp.asarray(TARGETS), e_j,
                                           JICR(*ICR), cfg_j, CORR)
    res_np = jax.tree.map(np.asarray, res)
    res_t = from_jax_numpy(res_np)
    assert isinstance(res_t, tmf.MissionFleetResult)
    fixed_t, n_t = tmf.correct_missed_legs(res_t, TARGETS, e_t, TICR(*ICR),
                                           cfg_t, CORR)
    return res_np, jax.tree.map(np.asarray, fixed_j), n_j, res_t, fixed_t, n_t


def test_same_lane_corrected_and_delivered(corrected):
    res, fixed_j, n_j, res_t, fixed_t, n_t = corrected
    missed = ~res.delivered
    assert missed[0, 0] and not missed[1, 0]
    assert n_j == n_t == 1
    assert bool(fixed_t.delivered.all()) and bool(fixed_j.delivered.all())
    assert float(fixed_t.object_err[0, 0]) < 0.15
    assert float(fixed_j.object_err[0, 0]) < 0.15
    # both sides end within 5 cm of each other (the two back ends may
    # take different valid optima after last-bit differences)
    np.testing.assert_allclose(fixed_t.push_traj[0, 0, -1, :2].numpy(),
                               fixed_j.push_traj[0, 0, -1, :2], atol=0.05)
    for v in fixed_t:
        if v.dtype.is_floating_point:
            assert bool(torch.isfinite(v).all())


def test_delivered_lane_untouched_bit_for_bit(corrected):
    res, fixed_j, _, res_t, fixed_t, _ = corrected
    for name in ("object_err", "track_err_max", "collision", "delivered",
                 "plan_err", "push_traj"):
        np.testing.assert_array_equal(getattr(fixed_t, name)[1].numpy(),
                                      getattr(res, name)[1], err_msg=name)
    # untouched fields of the corrected lane too
    np.testing.assert_array_equal(fixed_t.plan_err.numpy(), res.plan_err)
    np.testing.assert_array_equal(fixed_t.robot_final.numpy(),
                                  res.robot_final)
    np.testing.assert_array_equal(fixed_t.push_traj[0, 0, :-1].numpy(),
                                  res.push_traj[0, 0, :-1])
    # the input result is not written to
    np.testing.assert_array_equal(res_t.push_traj.numpy(), res.push_traj)


def test_corrected_lane_fields(corrected):
    res, fixed_j, _, _, fixed_t, _ = corrected
    # the trace's last sample moved to the corrected pose
    moved = np.linalg.norm(fixed_t.push_traj[0, 0, -1, :2].numpy()
                           - res.push_traj[0, 0, -1, :2])
    assert moved > 0.3
    np.testing.assert_allclose(
        float(fixed_t.object_err[0, 0]),
        np.linalg.norm(fixed_t.push_traj[0, 0, -1, :2].numpy()
                       - TARGETS[0, 0]), rtol=0, atol=1e-12)
    assert float(fixed_t.track_err_max[0, 0]) >= float(res.track_err_max[0, 0])
    assert fixed_t.object_err.dtype == torch.float64
    assert fixed_t.object_err.device == torch.device("cpu")


def test_single_mission_form(corrected):
    """A result without the fleet axis goes through and comes back
    without it, equal to the fleet form's lane (1e-12: the same lane
    alone)."""
    res, _, _, res_t, fixed_t, _ = corrected
    _, e_t = _esdfs()
    one = tmf.MissionFleetResult(*(a[0] for a in res_t))
    out, n = tmf.correct_missed_legs(one, TARGETS[0], e_t, TICR(*ICR),
                                     _cfgs()[1], CORR)
    assert n == 1 and out.object_err.shape == (1,)
    np.testing.assert_allclose(out.object_err.numpy(),
                               fixed_t.object_err[0].numpy(), rtol=0,
                               atol=1e-12)


def test_correct_until_delivered_rounds(corrected):
    """One round recovers the lane; the loop stops when nothing is missed
    and returns the per-round counts, as the JAX function does."""
    res, _, _, res_t, fixed_t, _ = corrected
    e_j, e_t = _esdfs()
    cfg_j, cfg_t = _cfgs()
    out, counts = tmf.correct_until_delivered(res_t, TARGETS, e_t,
                                              TICR(*ICR), cfg_t, CORR)
    assert counts == [1]
    assert bool(out.delivered.all())
    res_j = jmf.MissionFleetResult(*(jnp.asarray(a) for a in res))
    out_j, counts_j = jmf.correct_until_delivered(
        res_j, jnp.asarray(TARGETS), e_j, JICR(*ICR), cfg_j, CORR)
    assert counts_j == counts
    # nothing missed: no round, the very same result back, esdf unread
    again, counts2 = tmf.correct_until_delivered(out, TARGETS, None,
                                                 TICR(*ICR), cfg_t, CORR)
    assert counts2 == [] and again is out
    same, n = tmf.correct_missed_legs(out, TARGETS, None, TICR(*ICR), cfg_t,
                                      CORR)
    assert n == 0 and same is out
    # a budget too short to recover: every round bills the lane again
    out3, counts3 = tmf.correct_until_delivered(res_t, TARGETS, e_t,
                                                TICR(*ICR), cfg_t, 20,
                                                max_rounds=2)
    assert counts3 == [1, 1]
    assert not bool(out3.delivered[0, 0]) and bool(out3.delivered[1, 0])
    # each round starts where the last one ended
    e0 = float(res_t.object_err[0, 0])
    assert float(out3.object_err[0, 0]) < e0


def test_other_finals_match_np_delete():
    """The gather of the other objects' final poses equals the JAX
    package's `np.delete` row for row (exact), for every (lane, object)
    pair at K = 2, 3, 4 and for a repeated fleet lane."""
    rng = np.random.default_rng(7)
    for K in (2, 3, 4):
        finals = rng.normal(size=(3, K, 3))
        pairs = [(b, k) for b in range(3) for k in range(K)] + [(1, K - 1)]
        b_idx, k_idx = (torch.as_tensor(a) for a in zip(*pairs))
        got = tmf._other_finals(torch.as_tensor(finals), b_idx, k_idx)
        want = np.stack([np.delete(finals[b, :, :2], k, axis=0)
                         for b, k in pairs])
        assert got.shape == (len(pairs), K - 1, 2)
        np.testing.assert_array_equal(got.numpy(), want)


# K = 3: two missed legs with different object indices.  Lane (0, 1) must
# detour round object 0, whose painted box (3.0-3.8 x 3.9-4.7) lies across
# its straight line y = 4; lane (1, 2) has a free line.
K3_FINALS = np.array([[[3.4, 4.3, 0.3], [2.0, 4.0, 0.0], [6.0, 6.0, 1.0]],
                      [[5.0, 5.0, 0.0], [6.0, 2.0, -0.5], [2.0, 2.0, 0.1]]])
K3_TARGETS = np.array([[[3.4, 4.3], [5.2, 4.0], [6.0, 6.0]],
                       [[5.0, 5.0], [6.0, 2.0], [3.5, 2.0]]])
K3_DELIVERED = np.array([[True, False, True], [True, True, False]])


def _k3_result():
    """A fleet result as `run_mission` would leave it at B=2, K=3 (numpy
    leaves), with the push traces cut to 4 samples."""
    rng = np.random.default_rng(11)
    traj = rng.normal(size=(2, 3, 4, 3))
    traj[:, :, -1] = K3_FINALS
    err = np.linalg.norm(K3_FINALS[..., :2] - K3_TARGETS, axis=-1)
    return jmf.MissionFleetResult(
        object_err=err, delivered=K3_DELIVERED,
        plan_err=rng.uniform(0, 0.01, (2, 3)),
        collision=np.zeros((2, 3), bool),
        track_err_max=rng.uniform(0, 0.05, (2, 3)),
        robot_final=rng.normal(size=(2, 3)), push_traj=traj)


def test_k3_correction_paints_the_others_as_jax(monkeypatch):
    """K = 3, the branch every round of the production mission takes: the
    field each corrected lane plans in is the JAX package's painting of
    `np.delete(finals, k)` (the same occupied cells; distances to 1e-6,
    the field is f32 on both sides and one ulp at 4 m is 4.8e-7; a
    misplaced box moves it by a cell, 0.1), the same two lanes are corrected
    on both sides with the same outcome (both deliver; final poses within
    5 cm, the two back ends may take different valid optima after last-bit
    differences), and the four delivered legs keep every field bit for
    bit."""
    occ = np.zeros((80, 80), bool)
    occ[20:24, 60:70] = True                  # a base obstacle out of the way
    e_j = j_esdf_from_occupancy(jnp.asarray(occ), jnp.zeros(2), 0.1)
    e_t = esdf_from_occupancy(torch.as_tensor(occ), torch.zeros(2), 0.1)
    cfg_j, cfg_t = _cfgs()
    res = _k3_result()
    res_t = from_jax_numpy(res)

    seen = {}
    real_push_leg = tmf._push_leg

    def spy(start_xy, start_yaw, target, esdf, *a, **kw):
        seen["esdf"], seen["start"], seen["target"] = esdf, start_xy, target
        return real_push_leg(start_xy, start_yaw, target, esdf, *a, **kw)

    monkeypatch.setattr(tmf, "_push_leg", spy)
    fixed_t, n_t = tmf.correct_missed_legs(res_t, K3_TARGETS, e_t,
                                           TICR(*ICR), cfg_t, 400)
    lanes = [(0, 1), (1, 2)]
    assert n_t == 2 and seen["esdf"].dist.shape == (2, 80, 80)
    for m, (b, k) in enumerate(lanes):
        want = jmf._painted_esdf(
            e_j, jnp.asarray(np.delete(K3_FINALS[b, :, :2], k, axis=0)),
            cfg_j.paint_half_extents)
        np.testing.assert_allclose(seen["esdf"].dist[m].numpy(),
                                   np.asarray(want.dist), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(seen["esdf"].dist[m].numpy() <= 0.0,
                                      np.asarray(want.dist) <= 0.0)
        np.testing.assert_array_equal(seen["start"][m].numpy(),
                                      K3_FINALS[b, k, :2])
        np.testing.assert_array_equal(seen["target"][m].numpy(),
                                      K3_TARGETS[b, k])
    # the corrected object itself is not in its own field, the parked
    # neighbour is
    d0 = seen["esdf"].dist[0]
    assert float(d0[20, 40]) > 0.5 and float(d0[34, 43]) <= 0.0

    res_j = jmf.MissionFleetResult(*(jnp.asarray(a) for a in res))
    fixed_j, n_j = jmf.correct_missed_legs(res_j, jnp.asarray(K3_TARGETS),
                                           e_j, JICR(*ICR), cfg_j, 400)
    assert n_j == 2
    np.testing.assert_array_equal(fixed_t.delivered.numpy(),
                                  np.asarray(fixed_j.delivered))
    assert bool(fixed_t.delivered.all())
    np.testing.assert_array_equal(fixed_t.collision.numpy(),
                                  np.asarray(fixed_j.collision))
    for b, k in lanes:
        np.testing.assert_allclose(
            fixed_t.push_traj[b, k, -1, :2].numpy(),
            np.asarray(fixed_j.push_traj)[b, k, -1, :2], atol=0.05)
    keep = torch.as_tensor(K3_DELIVERED)
    for name in ("object_err", "track_err_max", "collision", "plan_err"):
        np.testing.assert_array_equal(getattr(fixed_t, name)[keep].numpy(),
                                      getattr(res, name)[K3_DELIVERED],
                                      err_msg=name)
    np.testing.assert_array_equal(fixed_t.push_traj[keep].numpy(),
                                  res.push_traj[K3_DELIVERED])
    np.testing.assert_array_equal(fixed_t.push_traj[:, :, :-1].numpy(),
                                  res.push_traj[:, :, :-1])


def test_mission_seconds_match_jax(corrected):
    res, fixed_j, _, res_t, fixed_t, _ = corrected
    cfg_j, cfg_t = _cfgs()
    res_j = jmf.MissionFleetResult(*(jnp.asarray(a) for a in res))
    for mc in (None, [1], [3, 1], []):
        a = tmf.mission_seconds_exact(res_t, cfg_t, CORR, miss_counts=mc)
        b = jmf.mission_seconds_exact(res_j, cfg_j, CORR, miss_counts=mc)
        assert abs(a - b) < 1e-9
    per_leg = (300 + 25 + 25) * 0.02 + 220 * 0.01
    assert abs(tmf.mission_seconds_exact(res_t, cfg_t, CORR)
               - (2 * per_leg + CORR * 0.01)) < 1e-9
    for kw in ({}, dict(correction_ticks=150)):
        cj, ct = _cfgs(**kw)
        assert abs(tmf.mission_seconds(ct, 3) - jmf.mission_seconds(cj, 3)) \
            < 1e-9


def test_inline_correction_recovers_short_budget(corrected):
    """`correction_ticks=220` inside `run_mission`: the 5 m leg misses the
    2.2 s budget single-shot (as the JAX fleet's lane 0 does) and one
    correction leg recovers it; the short lane delivers on its main leg
    and keeps its result bit for bit."""
    res = corrected[0]
    _, e_t = _esdfs()
    _, cfg_t = _cfgs()
    short = tmf.run_mission(ITEMS, TARGETS, ROBOT0, e_t, TICR(*ICR), cfg_t,
                            device="cpu")
    np.testing.assert_array_equal(short.delivered.numpy(), res.delivered)
    fixed = tmf.run_mission(ITEMS, TARGETS, ROBOT0, e_t, TICR(*ICR),
                            cfg_t._replace(correction_ticks=CORR),
                            device="cpu")
    assert bool(fixed.delivered.all())
    assert float(fixed.object_err.max()) < 0.15
    for name in ("object_err", "track_err_max", "plan_err", "collision"):
        assert torch.equal(getattr(fixed, name)[1], getattr(short, name)[1])
    assert float(fixed.object_err[0, 0]) < float(short.object_err[0, 0])
    # the robot ends at the corrected pose
    np.testing.assert_allclose(fixed.robot_final[0, :2].numpy(),
                               TARGETS[0, 0], atol=0.15)


def test_straight_flat_matches_jax():
    """`_straight_flat` field for field, 1e-12 (f64)."""
    rng = np.random.default_rng(4)
    start = rng.uniform(1.0, 3.0, (5, 2))
    goal = rng.uniform(4.0, 7.0, (5, 2))
    goal[4] = start[4] + 1e-5                 # the 1e-3 length floor
    yaw = rng.uniform(-1, 1, 5)
    ref = jax.vmap(lambda s, y, g: jmf._straight_flat(s, y, g, 6, 3.0))(
        *map(jnp.asarray, (start, yaw, goal)))
    got = tmf._straight_flat(*map(torch.as_tensor, (start, yaw, goal)), 6, 3.0)
    for name, a, b in zip(got._fields, got, ref):
        assert a.shape == np.asarray(b).shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=name)


def test_straight_front_end_mission():
    """frontend_mode="straight" runs the mission and delivers on the
    empty map."""
    _, e_t = _esdfs()
    cfg = tmf.MissionFleetConfig(
        approach_ticks=300, push_ticks=400, frontend_mode="straight",
        loop=tcl.LoopConfig(plant=tpl.PlantConfig(add_noise=False)))
    got = tmf.run_mission(ITEMS[1:], TARGETS[1:], ROBOT0[1:], e_t,
                          TICR(*ICR), cfg, device="cpu")
    assert bool(got.delivered.all())
    assert float(got.object_err.max()) < 0.1
    assert not bool(got.collision.any())


def test_default_device_is_the_card(monkeypatch):
    """`run_mission(device=None)` means CUDA and raises without a card,
    with corrections configured as without."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, e_t = _esdfs()
    with pytest.raises(RuntimeError):
        tmf.run_mission(ITEMS, TARGETS, ROBOT0, e_t, TICR(*ICR),
                        _cfgs(correction_ticks=CORR)[1])
