"""Port parity, whole slice: one mission fleet end to end.

`run_mission` at B=2 missions of K=1 object on the 80x80 mission map
(bench.py's geometry), approach_ticks=300, push_ticks=400, float64, on
the CPU: the JAX program vmapped over the fleet, the port batched.

* The kinematic approach agrees to 1e-12 (the same closed-form ticks).
* The front end's path cells are identical (exact integer search on the
  same blocked grid), and its FlatTraj agrees to 1e-12.
* Both sides deliver every object (`object_err < deliver_tol`).  The
  back end's line searches may take different valid optima after
  last-bit differences, so the pushes are compared on outcome, not
  iterate by iterate.

The contact plant has its own file (tests/test_torch_closed_loop_physics.py),
as do the correction legs and the straight front end
(tests/test_torch_corrections.py).  The options still unported, the
lidar-mapped arrangement mission and its `MappedPlanManager`, raise
NotImplementedError naming world/lidar.py instead of being ignored.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.core.dynamics import ICRParams as JICR
from alore_legged_manipulator_tpu.ops import wavefront as jw
from alore_legged_manipulator_tpu.ops.esdf import (
    esdf_from_occupancy as j_esdf_from_occupancy)
from alore_legged_manipulator_tpu.runtime import mission_fleet as jmf
from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams as TICR
from alore_legged_manipulator_tpu_torch.ops import wavefront as tw
from alore_legged_manipulator_tpu_torch.ops.esdf import esdf_from_occupancy
from alore_legged_manipulator_tpu_torch.runtime import mission_fleet as tmf

# one intra-op thread: these tests run beside other test workers, and
# their many small tensor ops only slow down when threads oversubscribe
torch.set_num_threads(1)

ITEMS = np.array([[[2.0, 2.5]], [[2.2, 5.5]]])
TARGETS = np.array([[[6.0, 2.5]], [[6.2, 5.5]]])
ROBOT0 = np.array([[1.0, 4.0, 0.0], [1.0, 4.0, 0.0]])
ICR = (-0.3, 0.3, 0.2)


def _occ():
    occ = np.zeros((80, 80), bool)
    occ[30:40, 44:50] = True
    return occ


def _esdfs():
    return (j_esdf_from_occupancy(jnp.asarray(_occ()), jnp.zeros(2), 0.1),
            esdf_from_occupancy(torch.as_tensor(_occ()), torch.zeros(2), 0.1))


def _cfgs():
    kw = dict(approach_ticks=300, push_ticks=400)
    return jmf.MissionFleetConfig(**kw), tmf.MissionFleetConfig(**kw)


@pytest.fixture(scope="module")
def missions():
    e_j, e_t = _esdfs()
    cfg_j, cfg_t = _cfgs()
    ref = jax.jit(jax.vmap(lambda i, t, r: jmf.run_mission(
        i, t, r, e_j, JICR(*ICR), cfg_j)))(
        jnp.asarray(ITEMS), jnp.asarray(TARGETS), jnp.asarray(ROBOT0))
    got = tmf.run_mission(ITEMS, TARGETS, ROBOT0, e_t, TICR(*ICR), cfg_t,
                          device="cpu")
    return jax.tree.map(np.asarray, ref), got


def test_both_deliver(missions):
    ref, got = missions
    cfg_t = _cfgs()[1]
    assert got.object_err.shape == (2, 1)
    assert got.push_traj.shape == (2, 1, cfg_t.push_ticks, 3)
    assert got.object_err.dtype == torch.float64
    for v in got:
        if v.dtype.is_floating_point:
            assert bool(torch.isfinite(v).all())
    assert bool(got.delivered.all()), got.object_err
    assert bool(np.all(ref.delivered)), ref.object_err
    assert float(got.object_err.max()) < cfg_t.deliver_tol
    assert not bool(got.collision.any())
    assert float(got.plan_err.max()) < 1e-2


def test_front_end_identical(missions):
    """Approach, path cells and FlatTraj of the leg, from the same state."""
    e_j, e_t = _esdfs()
    cfg_j, cfg_t = _cfgs()
    rob_ref = jax.vmap(lambda r, g: jmf._approach(r, g, cfg_j.fsm,
                                                  cfg_j.approach_ticks))(
        jnp.asarray(ROBOT0), jnp.asarray(ITEMS[:, 0]))
    rob = tmf._approach(torch.as_tensor(ROBOT0), torch.as_tensor(ITEMS[:, 0]),
                        cfg_t.fsm, cfg_t.approach_ticks)
    np.testing.assert_allclose(rob.numpy(), np.asarray(rob_ref), rtol=0,
                               atol=1e-12)

    start, tgt = ITEMS[:, 0], TARGETS[:, 0]
    yaw = np.asarray(rob_ref)[:, 2]
    flat_ref = jax.vmap(lambda s, y, g: jmf._wavefront_flat(
        e_j, s, y, g, cfg_j))(*map(jnp.asarray, (start, yaw, tgt)))
    flat = tmf._wavefront_flat(e_t, *map(torch.tensor, (start, yaw, tgt)),
                               cfg_t)
    for name, a, b in zip(flat._fields, flat, flat_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=name)

    blocked = np.asarray(e_j.dist) < cfg_j.wf_safe_dis
    cells = lambda p: np.clip(((p - 0.0) / 0.1).astype(np.int32), 0, 79)
    for b in range(2):
        _, c_ref, v_ref = jw.wavefront_path(
            jnp.asarray(blocked), jnp.asarray(cells(tgt[b])),
            jnp.asarray(cells(start[b])), cfg_j.path_max_len, impl="xla")
        _, c, v = tw.wavefront_path(
            torch.as_tensor(blocked)[None], torch.as_tensor(cells(tgt[b]))[None],
            torch.as_tensor(cells(start[b]))[None], cfg_t.path_max_len)
        np.testing.assert_array_equal(c[0].numpy(), np.asarray(c_ref))
        np.testing.assert_array_equal(v[0].numpy(), np.asarray(v_ref))
        assert int(v.sum()) > 30


def test_painted_esdf_matches():
    e_j, e_t = _esdfs()
    centers = np.array([[[3.0, 5.0], [5.5, 2.0]], [[4.2, 6.1], [2.0, 1.5]]])
    ref = jax.vmap(lambda c: jmf._painted_esdf(e_j, c, (0.4, 0.4)).dist)(
        jnp.asarray(centers))
    got = tmf._painted_esdf(e_t, torch.as_tensor(centers), (0.4, 0.4))
    # float32 fields: the painted occupancy is identical, and the EDT's
    # last bit may differ (XLA fuses res * sqrt(.) and the signed
    # combination in its own order): 1e-6 m, two ulps at 5 m
    np.testing.assert_array_equal(got.dist.numpy() <= 0.05,
                                  np.asarray(ref) <= 0.05)
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("option", ["mapped_mission", "mapped_plan_manager"])
def test_unported_options_raise(option):
    from alore_legged_manipulator_tpu_torch.mission.plan_manager import (
        MappedPlanManager)
    from alore_legged_manipulator_tpu_torch.runtime.arrangement import (
        ArrangementMission)
    occ = np.zeros((40, 40), bool)
    with pytest.raises(NotImplementedError, match="world/lidar.py"):
        if option == "mapped_mission":
            ArrangementMission(occ=occ, lower=(0.0, 0.0), res=0.1,
                               items=[(1.0, 1.0, 0.0)],
                               targets=[(3.0, 3.0, 0.0)], mapped=True,
                               device="cpu").run((0.5, 0.5, 0.0))
        else:
            MappedPlanManager(occ=occ, lower=(0.0, 0.0), res=0.1,
                              device="cpu")


def test_default_device_is_the_card(monkeypatch):
    """device=None means CUDA; without a card it raises, never falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, e_t = _esdfs()
    with pytest.raises(RuntimeError):
        tmf.run_mission(ITEMS, TARGETS, ROBOT0, e_t, TICR(*ICR))
