"""The port's flat solvers (ring / compact / dense) and the nested
`lbfgs_minimize` against the JAX package, on the CPU in f64.

The same numpy inputs go through both sides.  Iterates are held to 1e-9
(the two sides sum in different orders, so last-bit differences are
expected; the problems are chosen so that no line-search decision sits
on such a bit), statuses and accepted-iteration counts must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.solvers import bfgs as jbfgs
from alore_legged_manipulator_tpu.solvers import lbfgs as jlbfgs
from alore_legged_manipulator_tpu_torch.solvers import bfgs as tbfgs
from alore_legged_manipulator_tpu_torch.solvers import lbfgs as tlbfgs

TOL_X = 1e-9      # iterates, f64


def _quad(B=6, n=7, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    scales = np.asarray([1.0, 10.0, 100.0, 0.1, 5.0, 50.0, 2.0, 1.0])[:B]
    Q = (np.einsum("bij,bkj->bik", A, A) + 0.1 * np.eye(n)) \
        * scales[:, None, None]
    b = rng.normal(size=(B, n))
    return Q, b


def _quad_funs(Q, b):
    def jfun(Qi, bi):
        return lambda x: (0.5 * x @ Qi @ x - bi @ x, Qi @ x - bi)
    Qt, bt = torch.as_tensor(Q), torch.as_tensor(b)

    def tfun(x):
        Qx = torch.einsum("bij,bj->bi", Qt, x)
        return 0.5 * (x * Qx).sum(-1) - (bt * x).sum(-1), Qx - bt
    return jfun, tfun


def _l1_data(B=5, n=9, seed=1):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-2, 2, size=(B, n))
    tgt = rng.uniform(-0.5, 0.8, size=(B, 1))
    w = np.asarray([0.5, 1.0, 3.0, 0.2, 8.0])[:B, None]
    return x0, tgt, w


def _l1_funs(tgt, w, mu=0.01):
    from alore_legged_manipulator_tpu.core.smoothing import \
        positive_smoothed_l1 as jl1
    from alore_legged_manipulator_tpu_torch.core.smoothing import \
        positive_smoothed_l1 as tl1

    def jfun(ti, wi):
        def c(z):
            return jnp.sum(jl1(z, mu)) + 0.5 * jnp.sum(wi * (z - ti) ** 2)
        return lambda x: (c(x), jax.grad(c)(x))

    tt, wt = torch.as_tensor(tgt), torch.as_tensor(w)

    def tfun(x):
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            f = tl1(z, mu).sum(-1) + 0.5 * (wt * (z - tt) ** 2).sum(-1)
            g, = torch.autograd.grad(f.sum(), z)
        return f.detach(), g
    return jfun, tfun


def _np(t):
    return np.asarray(t.detach().cpu()) if torch.is_tensor(t) else np.asarray(t)


def _same(out_t, out_j, tol=TOL_X):
    xt, ft, st, kt = out_t
    xj, fj, sj, kj = out_j
    np.testing.assert_array_equal(_np(st), _np(sj))
    np.testing.assert_array_equal(_np(kt), _np(kj))
    np.testing.assert_allclose(_np(xt), _np(xj), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(ft), _np(fj), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("direction", ["ring", "compact", "dense"])
def test_quadratic_iterates_match_jax(direction):
    """Heterogeneous lanes (conditioning spread over 1000x), stopped after
    a fixed number of accepted iterations so iterates, not only the
    minimiser, are compared."""
    Q, b = _quad()
    jfun, tfun = _quad_funs(Q, b)
    for k_max in (3, 12):
        pj = jlbfgs.LbfgsParams(g_epsilon=1e-10, delta=0, past=0,
                                max_iterations=k_max, mem_size=4)
        pt = tlbfgs.LbfgsParams(**pj._asdict())
        out_j = jax.vmap(lambda Qi, bi: jbfgs.bfgs_minimize(
            jfun(Qi, bi), jnp.zeros_like(bi), pj, direction))(
                jnp.asarray(Q), jnp.asarray(b))
        out_t = tbfgs.bfgs_minimize(tfun, torch.zeros(b.shape,
                                                      dtype=torch.float64),
                                    pt, direction)
        _same(out_t, out_j)


@pytest.mark.parametrize("direction", ["ring", "compact", "dense"])
def test_quadratic_converges_to_solution(direction):
    Q, b = _quad()
    _, tfun = _quad_funs(Q, b)
    pt = tlbfgs.LbfgsParams(g_epsilon=1e-9, delta=0, past=0,
                            hard_iter_cap=500)
    x, f, st, k = tbfgs.bfgs_minimize(
        tfun, torch.zeros(b.shape, dtype=torch.float64), pt, direction)
    sol = np.linalg.solve(Q, b[..., None])[..., 0]
    np.testing.assert_allclose(_np(x), sol, atol=1e-5)


@pytest.mark.parametrize("direction", ["ring", "compact"])
def test_smoothed_l1_iterates_match_jax(direction):
    """Nonsmooth-ish cost, lanes of different weight: different lanes take
    different numbers of line-search trips and finish at different times."""
    x0, tgt, w = _l1_data()
    jfun, tfun = _l1_funs(tgt, w)
    pj = jlbfgs.LbfgsParams(g_epsilon=0.0, delta=1e-9, past=3,
                            max_iterations=10, mem_size=4)
    pt = tlbfgs.LbfgsParams(**pj._asdict())
    out_j = jax.vmap(lambda xi, ti, wi: jbfgs.flat_lbfgs_minimize(
        jfun(ti, wi), xi, pj, direction))(
            jnp.asarray(x0), jnp.asarray(tgt), jnp.asarray(w))
    out_t = tbfgs.flat_lbfgs_minimize(tfun, torch.as_tensor(x0), pt,
                                      direction)
    _same(out_t, out_j)


def test_smoothed_l1_same_optimum_all_directions():
    x0, tgt, w = _l1_data()
    _, tfun = _l1_funs(tgt, w)
    pt = tlbfgs.LbfgsParams(g_epsilon=0.0, delta=1e-9, past=3,
                            hard_iter_cap=500, mem_size=64)
    fr = tbfgs.flat_lbfgs_minimize(tfun, torch.as_tensor(x0), pt, "ring")[1]
    fc = tbfgs.flat_lbfgs_minimize(tfun, torch.as_tensor(x0), pt,
                                   "compact")[1]
    fn = tlbfgs.lbfgs_minimize(tfun, torch.as_tensor(x0), pt)[1]
    # tolerance of tests/test_bfgs.py::test_compact_converges_on_nonsmooth...
    scale = np.maximum(1.0, np.abs(_np(fr)))
    assert (np.abs(_np(fc) - _np(fr)) < 1e-8 * scale).all()
    assert (np.abs(_np(fn) - _np(fr)) < 1e-6 * scale).all()


def _rosen_t(x):
    with torch.enable_grad():
        z = x.detach().requires_grad_(True)
        f = (100 * (z[:, 1:] - z[:, :-1] ** 2) ** 2
             + (1 - z[:, :-1]) ** 2).sum(-1)
        g, = torch.autograd.grad(f.sum(), z)
    return f.detach(), g


def _rosen_j(x):
    def c(z):
        return jnp.sum(100 * (z[1:] - z[:-1] ** 2) ** 2 + (1 - z[:-1]) ** 2)
    return c(x), jax.grad(c)(x)


@pytest.mark.parametrize("k_max", [3, 6, 10, 14])
def test_compact_direction_matches_two_loop_operator(k_max):
    """The compact inverse form is the same operator as the two-loop
    recursion: early iterates agree to f64 round-off (1e-7, the JAX
    test's tolerance), also past the window overflow (mem_size 4, more
    accepted pairs than slots)."""
    x0 = torch.as_tensor(np.linspace(-1.2, 0.7, 11))[None]
    p = tlbfgs.LbfgsParams(mem_size=4, g_epsilon=0.0, delta=0.0, past=0,
                           max_iterations=k_max, hard_iter_cap=400)
    xr, fr, _, kr = tbfgs.bfgs_minimize(_rosen_t, x0, p, direction="ring")
    xc, fc, _, kc = tbfgs.bfgs_minimize(_rosen_t, x0, p, direction="compact")
    assert int(kr) == int(kc) == k_max + 1     # the counter starts at 1
    np.testing.assert_allclose(_np(xr), _np(xc), rtol=0, atol=1e-7)


@pytest.mark.parametrize("direction", ["ring", "compact", "dense"])
def test_window_overflow_matches_jax(direction):
    """14 accepted pairs through a 4-slot window on Rosenbrock, against
    JAX: the per-lane shift of the compact store is on this path."""
    x0 = np.stack([np.linspace(-1.2, 0.7, 11), np.linspace(0.5, -0.9, 11)])
    pj = jlbfgs.LbfgsParams(mem_size=4, g_epsilon=0.0, delta=0.0, past=0,
                            max_iterations=14, hard_iter_cap=400)
    pt = tlbfgs.LbfgsParams(**pj._asdict())
    out_j = jax.vmap(lambda x: jbfgs.bfgs_minimize(_rosen_j, x, pj,
                                                   direction))(
        jnp.asarray(x0))
    out_t = tbfgs.bfgs_minimize(_rosen_t, torch.as_tensor(x0), pt, direction)
    _same(out_t, out_j, tol=1e-7)


def test_compact_state_invariants():
    """After the run: rows >= bound of S, Y are zero, R^{-1} is upper
    triangular with zero rows and columns >= bound, and R^{-1} and Y^T Y
    equal what the stored pairs give."""
    x0 = torch.as_tensor(np.stack([np.linspace(-1.2, 0.7, 11),
                                   np.linspace(0.5, -0.9, 11)]))
    for k_max, m in ((3, 4), (9, 4)):
        p = tlbfgs.LbfgsParams(mem_size=m, g_epsilon=0.0, delta=0.0, past=0,
                               max_iterations=k_max + 1, hard_iter_cap=400)
        s = tbfgs._flat_minimize(
            lambda x, _: (*_rosen_t(x), ()), x0, p, "compact", (),
            lambda o, x, a: (o, torch.ones(x.shape[0], dtype=torch.bool)), 1)
        for lane in range(2):
            nb = int(s["bound"][lane])
            assert nb == min(k_max, m)
            S, Y = _np(s["lm_s"][lane]), _np(s["lm_y"][lane])
            assert not S[nb:].any() and not Y[nb:].any()
            R = np.triu(S[:nb] @ Y[:nb].T)
            Rinv = _np(s["cRinv"][lane])
            np.testing.assert_allclose(Rinv[:nb, :nb], np.linalg.inv(R),
                                       rtol=1e-8, atol=1e-8)
            assert not Rinv[nb:].any() and not Rinv[:, nb:].any()
            np.testing.assert_allclose(_np(s["cYtY"][lane])[:nb, :nb],
                                       Y[:nb] @ Y[:nb].T, rtol=1e-10,
                                       atol=1e-12)
            np.testing.assert_allclose(_np(s["lm_ys"][lane])[:nb],
                                       np.sum(S[:nb] * Y[:nb], -1),
                                       rtol=1e-10)


def _alm_problem():
    """min 0.5 |x - c|^2  s.t.  a.x = 1, as an ALM; lane 0 starts feasible
    (its outer loop ends after one inner solve), lane 1 must restart."""
    rng = np.random.default_rng(3)
    n = 6
    a = rng.normal(size=(2, n))
    c = rng.normal(size=(2, n))
    c[0] = c[0] + a[0] * (1.0 - a[0] @ c[0]) / (a[0] @ a[0])   # feasible
    return a, c


@pytest.mark.parametrize("direction", ["ring", "compact", "dense"])
def test_alm_restart_lane_matches_jax(direction):
    a, c = _alm_problem()
    tol = 1e-7

    def jrun(ai, ci):
        def fun(x, o):
            lam, rho = o
            h = ai @ x - 1.0
            f = 0.5 * jnp.sum((x - ci) ** 2) + lam * h + 0.5 * rho * h * h
            g = (x - ci) + (lam + rho * h) * ai
            return f, g, (h,)

        def upd(o, x, aux):
            lam, rho = o
            h = aux[0]
            return (lam + rho * h, rho * 2.0), jnp.abs(h) < tol
        pj = jlbfgs.LbfgsParams(g_epsilon=1e-9, delta=1e-12, past=3)
        return jbfgs.alm_minimize(fun, jnp.zeros_like(ci),
                                  (jnp.zeros(()), jnp.ones(())), upd, pj,
                                  max_outer=8, direction=direction)

    xj, fj, auxj, sj, kj, oj = jax.vmap(jrun)(jnp.asarray(a), jnp.asarray(c))

    at, ct = torch.as_tensor(a), torch.as_tensor(c)

    def tfun(x, o):
        lam, rho = o
        h = (at * x).sum(-1) - 1.0
        f = 0.5 * ((x - ct) ** 2).sum(-1) + lam * h + 0.5 * rho * h * h
        g = (x - ct) + (lam + rho * h)[:, None] * at
        return f, g, (h,)

    def tupd(o, x, aux):
        lam, rho = o
        h = aux[0]
        return (lam + rho * h, rho * 2.0), h.abs() < tol

    pt = tlbfgs.LbfgsParams(g_epsilon=1e-9, delta=1e-12, past=3)
    z = torch.zeros(2, dtype=torch.float64)
    xt, ft, auxt, st, kt, ot = tbfgs.alm_minimize(
        tfun, torch.zeros_like(ct), (z, z + 1.0), tupd, pt, max_outer=8,
        direction=direction)
    assert int(ot[0]) == 1 and int(ot[1]) > 1     # one lane restarts
    np.testing.assert_array_equal(_np(ot), _np(oj))
    np.testing.assert_array_equal(_np(kt), _np(kj))
    np.testing.assert_array_equal(_np(st), _np(sj))
    np.testing.assert_allclose(_np(xt), _np(xj), rtol=0, atol=TOL_X)
    np.testing.assert_allclose(_np(auxt[0]), _np(auxj[0]), rtol=0, atol=TOL_X)


def test_lbfgs_minimize_matches_jax():
    """Nested line search against JAX on Rosenbrock (two lanes whose line
    searches differ in length) and the smoothed-L1 batch."""
    x0 = np.stack([np.linspace(-1.2, 0.7, 11), np.linspace(0.5, -0.9, 11)])
    pj = jlbfgs.LbfgsParams(g_epsilon=1e-9, delta=1e-8, past=3,
                            hard_iter_cap=400, mem_size=16,
                            max_iterations=25)
    pt = tlbfgs.LbfgsParams(**pj._asdict())
    out_j = jax.vmap(lambda x: jlbfgs.lbfgs_minimize(_rosen_j, x, pj))(
        jnp.asarray(x0))
    out_t = tlbfgs.lbfgs_minimize(_rosen_t, torch.as_tensor(x0), pt)
    _same(out_t, out_j, tol=1e-7)

    x0, tgt, w = _l1_data()
    jfun, tfun = _l1_funs(tgt, w)
    pj = jlbfgs.LbfgsParams(g_epsilon=0.0, delta=1e-9, past=3,
                            max_iterations=8, mem_size=4)
    pt = tlbfgs.LbfgsParams(**pj._asdict())
    out_j = jax.vmap(lambda xi, ti, wi: jlbfgs.lbfgs_minimize(
        jfun(ti, wi), xi, pj))(jnp.asarray(x0), jnp.asarray(tgt),
                               jnp.asarray(w))
    out_t = tlbfgs.lbfgs_minimize(tfun, torch.as_tensor(x0), pt)
    _same(out_t, out_j)


def test_ring_matches_nested_lbfgs_iterates():
    """Same memory algebra, only the evaluation schedule is flattened:
    same accepted points on a nonconvex path (1e-12 as the JAX test)."""
    x0 = torch.as_tensor(np.linspace(-1.2, 0.7, 11))[None]
    p = tlbfgs.LbfgsParams(g_epsilon=1e-9, delta=1e-8, past=3,
                           hard_iter_cap=400, mem_size=16)
    xa, fa, sta, ka = tlbfgs.lbfgs_minimize(_rosen_t, x0, p)
    xb, fb, stb, kb = tbfgs.flat_lbfgs_minimize(_rosen_t, x0, p)
    assert int(ka) == int(kb) and int(sta) == int(stb)
    np.testing.assert_allclose(_np(xa), _np(xb), rtol=0, atol=1e-12)


@pytest.mark.parametrize("solver", ["ring", "compact", "dense", "nested"])
def test_lanes_independent_bitwise(solver):
    """A lane alone gives bit for bit what it gives inside a batch (the
    cost is written with products and sums over one axis, so it is itself
    independent of the batch)."""
    Q, b = _quad(B=4, n=6, seed=5)
    p = tlbfgs.LbfgsParams(g_epsilon=1e-9, delta=0, past=0,
                           hard_iter_cap=300, mem_size=4)

    def run(sl):
        Qt, bt = torch.as_tensor(Q[sl]), torch.as_tensor(b[sl])

        def fun(x):
            Qx = (Qt * x[:, None, :]).sum(-1)
            return 0.5 * (x * Qx).sum(-1) - (bt * x).sum(-1), Qx - bt
        x0 = torch.zeros(bt.shape, dtype=torch.float64)
        if solver == "nested":
            return tlbfgs.lbfgs_minimize(fun, x0, p)
        return tbfgs.bfgs_minimize(fun, x0, p, solver)

    full = run(slice(None))
    for lane in (1, 3):
        alone = run(slice(lane, lane + 1))
        for u, v in zip(alone, full):
            assert torch.equal(u[0], v[lane])


def test_compact_trip_reads_nothing_back(monkeypatch):
    """With direction='compact' the only host read of a trip is the loop
    condition: `Tensor.__bool__` once per trip and no int()/item()."""
    Q, b = _quad(B=3, n=5, seed=2)
    _, tfun = _quad_funs(Q, b)
    p = tlbfgs.LbfgsParams(g_epsilon=1e-9, delta=0, past=0, mem_size=4,
                           max_iterations=8)
    calls = {"bool": 0, "other": 0}
    real_bool = torch.Tensor.__bool__

    def counting_bool(self):
        calls["bool"] += 1
        return real_bool(self)

    def forbidden(self, *a, **k):
        calls["other"] += 1
        raise AssertionError("host read inside a compact trip")

    monkeypatch.setattr(torch.Tensor, "__bool__", counting_bool)
    for name in ("__int__", "__float__", "item", "tolist", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    out = tbfgs._flat_minimize(
        lambda x, _: (*tfun(x), ()), torch.zeros(b.shape,
                                                 dtype=torch.float64),
        p, "compact", (),
        lambda o, x, a: (o, torch.ones(x.shape[0], dtype=torch.bool)), 1)
    monkeypatch.undo()
    trips = int(out["evals"].max())
    assert calls["other"] == 0
    assert calls["bool"] == trips + 1       # one per trip plus the exit


def test_unknown_direction_raises():
    with pytest.raises(ValueError):
        tbfgs.bfgs_minimize(lambda x: (x.sum(-1), torch.ones_like(x)),
                            torch.zeros(1, 3), tlbfgs.LbfgsParams(),
                            direction="danse")


def test_bfgs_minimize_default_is_dense():
    import inspect
    assert inspect.signature(tbfgs.bfgs_minimize).parameters[
        "direction"].default == "dense"
    assert inspect.signature(tbfgs.flat_lbfgs_minimize).parameters[
        "direction"].default == "ring"
    assert inspect.signature(tbfgs.alm_minimize).parameters[
        "direction"].default == "ring"
