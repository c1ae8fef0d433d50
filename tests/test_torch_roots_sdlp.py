"""Port parity: polynomial roots and extremum rates (`ops/roots.py`) and
Seidel's LP (`ops/sdlp.py`).

Root order is not defined (an eigendecomposition), so roots are compared
sorted, and `real_roots_in` by its mask and the set of roots it keeps.
Held against the JAX package at float64: the companion roots and the
masks on random polynomials, `poly_max_abs_on` and `max_rates` of MINCO
trajectories within 1e-9 (and `max_rates` against dense sampling, as
tests/test_ops.py holds JAX); `seidel_lp` equal to the JAX package's on
tests/test_ops.py's LPs, feasible and infeasible, with the same random
draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.ops import roots as jr
from alore_legged_manipulator_tpu.ops import sdlp as js
from alore_legged_manipulator_tpu.solvers import minco as jminco
from alore_legged_manipulator_tpu_torch.ops import roots as tr
from alore_legged_manipulator_tpu_torch.ops import sdlp as ts

F64 = torch.float64


def _polys(seed, n, deg):
    return np.random.default_rng(seed).normal(size=(n, deg + 1))


@pytest.mark.parametrize("deg", [3, 5])
def test_companion_roots_and_masks_match_jax(deg):
    P = _polys(deg, 32, deg)
    P[:, -1] += np.sign(P[:, -1])            # keep the leading term away
    got = tr.companion_roots(torch.tensor(P, dtype=F64)).numpy()
    x, mask = tr.real_roots_in(torch.tensor(P, dtype=F64), -1.5, 1.5)
    for p, g, xm, m in zip(P, got, x.numpy(), mask.numpy()):
        ref = np.asarray(jr.companion_roots(jnp.asarray(p)))
        key = lambda r: (round(r.real, 6), round(r.imag, 6))  # noqa: E731
        np.testing.assert_allclose(sorted(g, key=key), sorted(ref, key=key),
                                   atol=1e-9)
        jx, jm = jr.real_roots_in(jnp.asarray(p), -1.5, 1.5)
        assert int(m.sum()) == int(np.asarray(jm).sum())
        np.testing.assert_allclose(np.sort(xm[m]),
                                   np.sort(np.asarray(jx)[np.asarray(jm)]),
                                   atol=1e-9)
        assert np.all(xm[~m] == -1.5)


def test_known_roots_and_poly_max():
    r = np.sort(tr.companion_roots(
        torch.tensor([6.0, -7.0, 0.0, 1.0], dtype=F64)).real.numpy())
    np.testing.assert_allclose(r, [-3.0, 1.0, 2.0], atol=1e-8)
    m = float(tr.poly_max_abs_on(torch.tensor([-1.0, 0.0, 1.0], dtype=F64),
                                 0.0, 3.0))
    assert abs(m - 8.0) < 1e-8
    P = _polys(7, 16, 4)
    got = tr.poly_max_abs_on(torch.tensor(P, dtype=F64), -1.0, 2.0).numpy()
    for p, g in zip(P, got):
        assert abs(g - float(jr.poly_max_abs_on(jnp.asarray(p), -1.0,
                                                2.0))) < 1e-9


def _trajs(n_lanes):
    out = []
    for b in range(n_lanes):
        key = jax.random.PRNGKey(b)
        head = jax.random.normal(key, (2, 3), jnp.float64)
        tail = jax.random.normal(jax.random.fold_in(key, 1), (2, 3),
                                 jnp.float64)
        inner = jax.random.normal(jax.random.fold_in(key, 2), (2, 3),
                                  jnp.float64)
        times = jnp.array([0.7, 1.1, 0.9, 1.3]) * (1.0 + 0.1 * b)
        out.append((np.asarray(jminco.minco_coeffs(head, tail, inner,
                                                   times)),
                    np.asarray(times)))
    return out


def test_max_rates_match_jax_and_sampling():
    trajs = _trajs(4)
    C = torch.tensor(np.stack([c for c, _ in trajs]), dtype=F64)
    T = torch.tensor(np.stack([t for _, t in trajs]), dtype=F64)
    got = torch.stack(tr.max_rates(C, T), dim=-1).numpy()     # (4, 4)
    for b, (c, t) in enumerate(trajs):
        ref = np.array([float(v) for v in jax.jit(jr.max_rates)(
            jnp.asarray(c), jnp.asarray(t))])
        np.testing.assert_allclose(got[b], ref, rtol=1e-9, atol=1e-12)
        dense_v, dense_a = [], []
        for i in range(len(t)):
            s = np.linspace(0.0, t[i], 4001)[:, None] ** np.arange(6)
            d1 = (s[:, :5] * np.arange(1, 6)) @ c[i, 1:]
            d2 = (s[:, :4] * np.arange(1, 5) * np.arange(2, 6)) @ c[i, 2:]
            dense_v.append(np.abs(d1))
            dense_a.append(np.abs(d2))
        dv, da = np.concatenate(dense_v), np.concatenate(dense_a)
        np.testing.assert_allclose(got[b], [dv[:, 0].max(), dv[:, 1].max(),
                                            da[:, 0].max(), da[:, 1].max()],
                                   rtol=1e-4)


def test_sdlp_is_the_jax_packages_and_equal():
    rng = np.random.default_rng(0)
    for trial in range(20):
        m = 8
        A = rng.standard_normal((m, 2))
        b = A @ np.array([0.3, -0.2]) + rng.uniform(0.1, 2.0, m)
        c = rng.standard_normal(2)
        x = ts.seidel_lp(c, A, b, bound=50.0)
        np.testing.assert_array_equal(x, js.seidel_lp(c, A, b, bound=50.0))
        assert np.all(A @ x <= b + 1e-6)
    for d in (1, 3):
        A = rng.standard_normal((12, d))
        b = rng.uniform(0.5, 2.0, 12)
        c = rng.standard_normal(d)
        np.testing.assert_array_equal(ts.seidel_lp(c, A, b, bound=10.0),
                                      js.seidel_lp(c, A, b, bound=10.0))
    A = np.array([[1.0, 0.0], [-1.0, 0.0]])
    b = np.array([-1.0, -1.0])
    assert ts.seidel_lp(np.array([1.0, 0.0]), A, b, bound=10.0) is None
