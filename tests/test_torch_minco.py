"""Port parity: the MINCO spline solvers (dense 6N system, reduced dense
solve, block Thomas, block cyclic reduction) against the JAX package and
against each other, f64 on the CPU.  The same numpy problems go through
both sides; the JAX functions are vmapped over the lane axis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.solvers import minco as jm
from alore_legged_manipulator_tpu_torch.solvers import minco as tm

B = 3


def _problem(n, seed=0):
    rng = np.random.default_rng(seed + n)
    head = rng.standard_normal((B, 2, 3))
    tail = rng.standard_normal((B, 2, 3))
    inner = rng.standard_normal((B, 2, n - 1))
    times = rng.uniform(0.3, 1.5, (B, n))
    return head, tail, inner, times


def _t(args):
    return [torch.as_tensor(a) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("n", [1, 2, 6, 17, 32])
def test_minco_system_and_dense_match_jax(n):
    """The assembled 6N x 6N system is equal entry for entry (1e-14: only
    the powers of T are computed); its solution to 1e-8 relative to the
    largest coefficient (two LU libraries on a system whose condition
    grows with N)."""
    args = _problem(n)
    A_ref, b_ref = jax.vmap(jm.minco_system)(*_j(args))
    A, b = tm.minco_system(*_t(args))
    np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=0,
                               atol=1e-14)
    c_ref = np.asarray(jax.vmap(jm.minco_coeffs_dense)(*_j(args)))
    c = tm.minco_coeffs_dense(*_t(args)).numpy()
    assert c.shape == c_ref.shape == (B, n, 6, 2)
    np.testing.assert_allclose(c, c_ref, rtol=0,
                               atol=1e-8 * np.abs(c_ref).max())


@pytest.mark.parametrize("n", [2, 6, 12, 17, 32])
def test_minco_coeffs_matches_jax_and_dense(n):
    """`minco_coeffs` picks the dense reduced solve below 16 interior
    joints and cyclic reduction from there on, as the JAX package; both
    against JAX (1e-9 relative) and against the 6N-system solve (1e-7,
    the JAX test's tolerance)."""
    args = _problem(n)
    c_ref = np.asarray(jax.vmap(jm.minco_coeffs)(*_j(args)))
    c = tm.minco_coeffs(*_t(args)).numpy()
    scale = np.abs(c_ref).max()
    np.testing.assert_allclose(c, c_ref, rtol=0, atol=1e-9 * scale)
    dense = tm.minco_coeffs_dense(*_t(args)).numpy()
    np.testing.assert_allclose(c, dense, rtol=1e-7, atol=1e-7 * scale)
    tr = tm.minco_traj(*_t(args))
    assert tr.num_pieces == n
    np.testing.assert_array_equal(tr.coeffs.numpy(), c)


@pytest.mark.parametrize("n", [6, 17, 32])
def test_block_solvers_match_jax_and_dense(n):
    """Thomas, Thomas-scan and cyclic reduction on the reduced blocks:
    blocks equal to JAX's (1e-12 relative), each solver against its JAX
    twin and against the dense solve of the same system (1e-9 relative
    to the largest unknown)."""
    args = _problem(n, seed=5)
    ref_blocks = jax.vmap(jm._reduced_blocks)(*_j(args))
    blocks = tm._reduced_blocks(*_t(args))
    for r, g in zip(ref_blocks, blocks):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                   atol=1e-12 * np.abs(r).max())
    D, L, U, rhs, _ = blocks
    A, b, _ = tm._reduced_system(*_t(args))
    x_d = torch.linalg.solve(A, b).reshape(B, n - 1, 2, 2).numpy()
    scale = np.abs(x_d).max()
    for name in ("solve_block_tridiag_thomas",
                 "solve_block_tridiag_thomas_scan",
                 "solve_block_tridiag_cr"):
        x_ref = np.asarray(jax.vmap(getattr(jm, name))(*ref_blocks[:4]))
        x = getattr(tm, name)(D, L, U, rhs).numpy()
        np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-9 * scale,
                                   err_msg=name)
        np.testing.assert_allclose(x, x_d, rtol=0, atol=1e-9 * scale,
                                   err_msg=name)


def test_block_cyclic_reduction_random_systems():
    """Cyclic reduction against numpy's dense solve on random
    well-conditioned block-tridiagonal systems of any m (1e-12, the JAX
    test's tolerance)."""
    rng = np.random.default_rng(1)
    for m in (1, 2, 3, 5, 8, 16, 31):
        D = rng.normal(size=(m, 2, 2)) + 4 * np.eye(2)
        L = rng.normal(size=(m, 2, 2)) * 0.3
        U = rng.normal(size=(m, 2, 2)) * 0.3
        L[0] = 0.0
        U[-1] = 0.0
        b = rng.normal(size=(m, 2, 2))
        A = np.zeros((2 * m, 2 * m))
        for j in range(m):
            A[2 * j:2 * j + 2, 2 * j:2 * j + 2] = D[j]
            if j > 0:
                A[2 * j:2 * j + 2, 2 * j - 2:2 * j] = L[j]
            if j < m - 1:
                A[2 * j:2 * j + 2, 2 * j + 2:2 * j + 4] = U[j]
        ref = np.linalg.solve(A, b.reshape(2 * m, 2)).reshape(m, 2, 2)
        for fn in (tm.solve_block_tridiag_cr, tm.solve_block_tridiag_thomas):
            x = fn(*[torch.as_tensor(z)[None] for z in (D, L, U, b)])
            np.testing.assert_allclose(x[0].numpy(), ref, atol=1e-12)


def test_set_small_n_solver_profiles():
    """Every small-N profile gives the same spline (rtol 1e-7, the JAX
    test's tolerance); the switch returns the previous mode and refuses
    an unknown one."""
    assert tm.SMALL_N_SOLVER == jm.SMALL_N_SOLVER == "lu"
    assert tm.CR_MIN_JOINTS == jm.CR_MIN_JOINTS
    for n in (3, 6, 12):
        args = _t(_problem(n, seed=11))
        ref = tm.minco_coeffs(*args)
        for mode in ("thomas_scan", "cr"):
            prev = tm.set_small_n_solver(mode)
            assert prev == "lu"
            try:
                out = tm.minco_coeffs(*args)
            finally:
                assert tm.set_small_n_solver(prev) == mode
            np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-7,
                                       atol=1e-9)
    with pytest.raises(ValueError):
        tm.set_small_n_solver("nope")
    assert tm.SMALL_N_SOLVER == "lu"


@pytest.mark.parametrize("n", [6, 17])
def test_gradient_through_solve_matches_jax(n):
    """d(sum c^2)/d(times, inner, tail) through the dense reduced solve
    (n = 6) and through cyclic reduction (n = 17) against jax.grad:
    1e-8 relative to the largest gradient entry."""
    head, tail, inner, times = _problem(n, seed=7)

    def obj_j(tt, ii, tl, hd):
        return jnp.sum(jm.minco_coeffs(hd, tl, ii, tt) ** 2)

    g_ref = jax.vmap(jax.grad(obj_j, argnums=(0, 1, 2)))(
        *_j((times, inner, tail, head)))
    tt, ii, tl = (torch.as_tensor(a).requires_grad_(True)
                  for a in (times, inner, tail))
    (tm.minco_coeffs(torch.as_tensor(head), tl, ii, tt) ** 2).sum().backward()
    for g, r in zip((tt.grad, ii.grad, tl.grad), g_ref):
        r = np.asarray(r)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-8 * np.abs(r).max())


def test_minco_problem_fields():
    assert tm.MincoProblem._fields == jm.MincoProblem._fields
    assert tm.NCOEF == jm.NCOEF == 6
