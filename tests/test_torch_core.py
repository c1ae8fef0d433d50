"""Port parity: core math, angles, MINCO and the ESDF.

Same numpy inputs through the JAX function (vmapped over lanes where the
JAX function is single-lane) and the port's batched function, in
float64.  Tolerance 1e-12 (absolute, on values up to a few hundred): the
two sides evaluate the same formulas; what differs is summation order,
the polynomial powers (pow vs repeated products) and the LU library,
worth ~1e-13 here.  The ESDF field is float32 on both sides and its
samples are compared to 1e-6 (1e-5 for gradients, which divide by the
0.1 m resolution).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.core import dynamics as jd
from alore_legged_manipulator_tpu.core import flow as jf
from alore_legged_manipulator_tpu.core import poly as jp
from alore_legged_manipulator_tpu.core.smoothing import (
    positive_smoothed_l1 as j_sl1)
from alore_legged_manipulator_tpu.ops import esdf as je
from alore_legged_manipulator_tpu.solvers import minco as jm
from alore_legged_manipulator_tpu.utils import angles as ja
from alore_legged_manipulator_tpu_torch.core import dynamics as td
from alore_legged_manipulator_tpu_torch.core import flow as tf
from alore_legged_manipulator_tpu_torch.core import poly as tp
from alore_legged_manipulator_tpu_torch.core.smoothing import (
    positive_smoothed_l1 as t_sl1)
from alore_legged_manipulator_tpu_torch.ops import esdf as te
from alore_legged_manipulator_tpu_torch.solvers import minco as tm
from alore_legged_manipulator_tpu_torch.utils import angles as ta

# one intra-op thread: these tests run beside other test workers, and
# their many small tensor ops only slow down when threads oversubscribe
torch.set_num_threads(1)

TOL = 1e-12
B = 16


def _close(got, ref, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_dynamics():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 3))
    u = rng.normal(size=(B, 2))
    icr = (-0.31, 0.27, 0.18)
    _close(td.icr_dynamics(_t(x), _t(u), td.ICRParams(*icr)),
           jd.icr_dynamics(jnp.asarray(x), jnp.asarray(u), jd.ICRParams(*icr)))
    om, v = rng.normal(size=B), rng.normal(size=B)
    for a, b in zip(td.wheel_speeds_from_flat(_t(om), _t(v), td.ICRParams(*icr)),
                    jd.wheel_speeds_from_flat(jnp.asarray(om), jnp.asarray(v),
                                              jd.ICRParams(*icr))):
        _close(a, b)
    for a, b in zip(td.body_vel_from_wheels(_t(om), _t(v), td.ICRParams(*icr)),
                    jd.body_vel_from_wheels(jnp.asarray(om), jnp.asarray(v),
                                            jd.ICRParams(*icr))):
        _close(a, b)


def test_smoothing():
    x = np.linspace(-0.05, 0.2, 301)
    _close(t_sl1(_t(x), 0.01), j_sl1(jnp.asarray(x), 0.01))


def test_angles():
    rng = np.random.default_rng(1)
    th = rng.uniform(-20, 20, (B, 9))
    _close(ta.normalize_angle(_t(th)), ja.normalize_angle(jnp.asarray(th)))
    ref = rng.uniform(-10, 10, (B, 9))
    _close(ta.unwrap_to(_t(ref), _t(th)),
           ja.unwrap_to(jnp.asarray(ref), jnp.asarray(th)))
    est = rng.uniform(-7, 7, B)
    seq = np.cumsum(rng.uniform(-2.5, 2.5, (B, 12)), axis=1)
    ref_seq = jax.vmap(ja.smooth_yaw_sequence)(jnp.asarray(est),
                                               jnp.asarray(seq))
    _close(ta.smooth_yaw_sequence(_t(est), _t(seq)), ref_seq)


def _rand_traj(rng, n=5):
    coeffs = rng.normal(size=(B, n, 6, 2))
    times = rng.uniform(0.3, 1.5, (B, n))
    return coeffs, times


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_poly_eval(order):
    rng = np.random.default_rng(2 + order)
    coeffs, times = _rand_traj(rng)
    t = rng.uniform(-0.5, times.sum(1)[:, None] + 0.5, (B, 17))
    ref = jax.vmap(lambda c, T, tt: jp.eval_traj(jp.PolyTraj(c, T), tt, order))(
        jnp.asarray(coeffs), jnp.asarray(times), jnp.asarray(t))
    got = tp.eval_traj(tp.PolyTraj(_t(coeffs), _t(times)), _t(t), order)
    _close(got, ref)


def test_flow():
    rng = np.random.default_rng(9)
    coeffs, times = _rand_traj(rng, 4)
    coeffs *= 0.2
    ini = rng.normal(size=(B, 3))
    ref = jax.vmap(lambda c, T, p: jf.simpson_flow_positions(c, T, p, 0.2, 8))(
        jnp.asarray(coeffs), jnp.asarray(times), jnp.asarray(ini[:, :2]))
    got = tf.simpson_flow_positions(_t(coeffs), _t(times), _t(ini[:, :2]),
                                    0.2, 8)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    for a, b in zip(got[2], ref[2]):
        _close(a, b)
    ref_seq, ref_dt = jax.vmap(lambda c, T, p: jf.flow_state_sequence(
        jp.PolyTraj(c, T), p, 0.2, 64))(jnp.asarray(coeffs),
                                        jnp.asarray(times), jnp.asarray(ini))
    seq, dt = tf.flow_state_sequence(tp.PolyTraj(_t(coeffs), _t(times)),
                                     _t(ini), 0.2, 64)
    _close(seq, ref_seq)
    _close(dt, ref_dt)


@pytest.mark.parametrize("n", [1, 2, 6])
def test_minco_coeffs_and_energy(n):
    rng = np.random.default_rng(10 + n)
    head = rng.normal(size=(B, 2, 3))
    tail = rng.normal(size=(B, 2, 3))
    inner = rng.normal(size=(B, 2, n - 1))
    times = rng.uniform(0.4, 1.6, (B, n))
    ref = jax.vmap(jm.minco_coeffs)(jnp.asarray(head), jnp.asarray(tail),
                                    jnp.asarray(inner), jnp.asarray(times))
    got = tm.minco_coeffs(_t(head), _t(tail), _t(inner), _t(times))
    _close(got, ref)
    w = np.array([0.33, 1.0])
    e_ref = jax.vmap(lambda c, T: jm.minco_energy(c, T, jnp.asarray(w)))(
        ref, jnp.asarray(times))
    e_got = tm.minco_energy(got, _t(times), _t(w))
    np.testing.assert_allclose(e_got.numpy(), np.asarray(e_ref), rtol=TOL)


def test_esdf_and_samplers():
    occ = np.zeros((40, 44), bool)
    occ[10:16, 20:26] = True
    occ[30:33, 3:9] = True
    ref = je.esdf_from_occupancy(jnp.asarray(occ), jnp.zeros(2), 0.1)
    got = te.esdf_from_occupancy(_t(occ), torch.zeros(2), 0.1)
    # float32 on both sides; the EDT and sqrt round alike
    _close(got.dist, ref.dist, 1e-6)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-0.2, 4.6, (3, 50, 2))
    d_ref, g_ref = jax.vmap(lambda p: je.sample_dist_grad_bilinear(ref, p))(
        jnp.asarray(pts))
    d_got, g_got = te.sample_dist_grad_bilinear(got, _t(pts))
    _close(d_got, d_ref, 1e-6)
    _close(g_got, g_ref, 1e-5)
    corners_ref = je.pack_corner_grid(ref)
    p_ref = jax.vmap(lambda p: je.sample_dist_bilinear_packed(
        ref, corners_ref, p))(jnp.asarray(pts))
    p_got = te.sample_dist_bilinear_packed(got, te.pack_corner_grid(got, 3),
                                           _t(pts))
    _close(p_got, p_ref, 1e-6)
    c_ref = jax.vmap(lambda p: je.dist_at_cell(ref, p))(jnp.asarray(pts))
    _close(te.dist_at_cell(got, _t(pts)), c_ref, 1e-6)
