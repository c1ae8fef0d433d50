"""Port parity: the septic MINCO (`solvers/minco_s4.py`), float64.

* the compiled reference's goldens (tests/golden/minco_s4_oracle, the
  inputs regenerated by tests/test_minco_s4.py's LCG) with that test's
  tolerances: coefficients 1e-9, energy 1e-7 relative, the adjoint
  gradients 1e-7 relative;
* the JAX package's coefficients, energy and gradients within 1e-9 (on
  the largest golden case: the JAX function takes seconds to compile);
* every boundary derivative and waypoint hit; a batch of lanes equal to
  each lane alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.solvers import minco_s4 as jm
from alore_legged_manipulator_tpu_torch.solvers import minco_s4 as tm
from tests.test_minco_s4 import CASES, INPUTS, WEIGHTS

F64 = torch.float64


def _lane(*xs):
    return [torch.tensor(np.asarray(x), dtype=F64)[None] for x in xs]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_goldens(i):
    case = CASES[i]
    head, tail, inner, ts = _lane(*INPUTS[i])
    c = tm.minco_s4_coeffs(head, tail, inner, ts)
    np.testing.assert_allclose(c[0].numpy(), case["coeffs"], rtol=1e-9,
                               atol=1e-9)
    e = float(tm.minco_s4_energy(c, ts, WEIGHTS)[0])
    assert abs(e - case["energy"]) < 1e-7 * max(1.0, case["energy"])
    gp, gt = tm.minco_s4_energy_grads(head, tail, inner, ts, WEIGHTS)
    np.testing.assert_allclose(gp[0].numpy(), case["gp"], rtol=1e-7)
    np.testing.assert_allclose(gt[0].numpy(), case["gt"], rtol=1e-7)


def test_matches_jax():
    """On the 7-piece case (the goldens cover all three)."""
    head, tail, inner, ts = INPUTS[2]
    j = [jnp.asarray(x, jnp.float64) for x in (head, tail, inner, ts)]
    jc = jax.jit(jm.minco_s4_coeffs)(*j)
    je = jm.minco_s4_energy(jc, j[3], WEIGHTS)
    jgp, jgt = jax.jit(jm.minco_s4_energy_grads,
                       static_argnums=4)(*j, WEIGHTS)
    t = _lane(head, tail, inner, ts)
    c = tm.minco_s4_coeffs(*t)
    np.testing.assert_allclose(c[0].numpy(), np.asarray(jc), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(float(tm.minco_s4_energy(c, t[3],
                                                        WEIGHTS)[0]),
                               float(je), rtol=1e-9)
    gp, gt = tm.minco_s4_energy_grads(*t, WEIGHTS)
    np.testing.assert_allclose(gp[0].numpy(), np.asarray(jgp), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(gt[0].numpy(), np.asarray(jgt), rtol=1e-9,
                               atol=1e-9)


def _eval(c, s, order):
    """d^order/ds^order of a piece (8, 2) at s."""
    k = np.arange(8)
    ff = np.ones(8)
    for d in range(order):
        ff = ff * np.maximum(k - d, 0)
    pw = np.where(k >= order, s ** np.maximum(k - order, 0), 0.0)
    return (ff * pw) @ c


def test_boundary_and_waypoints():
    head, tail, inner, ts = INPUTS[1]
    c = tm.minco_s4_coeffs(*_lane(head, tail, inner, ts))[0].numpy()
    for o in range(4):
        np.testing.assert_allclose(_eval(c[0], 0.0, o), head[:, o],
                                   atol=1e-9)
        np.testing.assert_allclose(_eval(c[-1], ts[-1], o), tail[:, o],
                                   atol=1e-8)
    for k in range(len(ts) - 1):
        np.testing.assert_allclose(_eval(c[k], ts[k], 0), inner[:, k],
                                   atol=1e-9)
        for o in range(7):          # C6 continuity at the joints
            np.testing.assert_allclose(_eval(c[k], ts[k], o),
                                       _eval(c[k + 1], 0.0, o),
                                       rtol=1e-9, atol=1e-8)


def test_batch_equals_lanes():
    head, tail, inner, ts = INPUTS[1]
    B = 16
    h, t, _, T = _lane(head, tail, inner, ts)
    inns = torch.tensor(np.stack([inner + 0.01 * b for b in range(B)]),
                        dtype=F64)
    c = tm.minco_s4_coeffs(h.expand(B, -1, -1), t.expand(B, -1, -1), inns,
                           T.expand(B, -1))
    e = tm.minco_s4_energy(c, T.expand(B, -1), WEIGHTS)
    assert e.shape == (B,) and bool(torch.isfinite(e).all())
    for b in (0, 7, 15):
        cb = tm.minco_s4_coeffs(h, t, inns[b:b + 1], T)
        np.testing.assert_allclose(c[b].numpy(), cb[0].numpy(), rtol=1e-12,
                                   atol=1e-12)
