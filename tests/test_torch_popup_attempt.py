"""The `popup` golden's replan attempts around the block drop, JAX
against the port on the same inputs (ROADMAP.md section 3, fault 1).

On the whole `popup` golden the port's planner simulation misses the
golden's plans at 4.208 s and 4.288 s where JAX's does not.  This file
settles whether the port's back end rejects plans that JAX's accepts.
`tests/popup_capture.py` ran the JAX simulation (the configurations of
tests/test_torch_planner_sim.py::run_both, LTV-MPC, float64) and stored
what the plan manager was given at each attempt in 4.0-4.3 s
(`alore_legged_manipulator_tpu_torch/data/popup_attempts.npz`: start
state and its derivatives, the stitched start path, goal, ESDF).  Each
attempt goes through both front ends and both back ends at float64:

* the front ends agree bit for bit;
* both back ends accept (no collision after the anneal), with the same
  number of anneal rounds, and each plan ends on its goal within the
  ALM tolerance;
* the plans differ as the chaotic float64 back end makes them differ
  (ROADMAP.md section 3): inner points up to 0.21 m and piece times up
  to 0.11 s apart (seen: 0.208 / 0.090 / 0.057 / 0.073 m and 0.111 /
  0.041 / 0.039 / 0.018 s at the four attempts); held to 0.5 m and
  0.25 s.  Their costs (`stage2_cost_breakdown` at each side's own plan,
  multipliers zero) agree within 2% (seen: 0.72, 0.01, 0.74 and
  0.73%);
* the port's `stage2_cost_breakdown` evaluated at JAX's plan equals
  JAX's to 1e-9, term by term.

So the port accepts where JAX accepts: the popup divergence is the
chaotic back end, not a rejection in the port.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.ops.esdf import ESDF as JESDF
from alore_legged_manipulator_tpu.planner import backend as jb
from alore_legged_manipulator_tpu.planner.frontend import (
    plan_frontend as j_frontend)
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.ops.esdf import ESDF as TESDF
from alore_legged_manipulator_tpu_torch.planner import backend as tb
from alore_legged_manipulator_tpu_torch.planner.frontend import (
    plan_frontend as t_frontend)
from tests.popup_capture import OUT, scenario_and_config

torch.set_num_threads(1)

_Z = np.load(OUT)
N_ATTEMPTS = len({k.split("/")[0] for k in _Z.files})
_CFG = scenario_and_config()[2]
_JIT = {}


def attempt(i):
    return {k.split("/")[1]: _Z[k] for k in _Z.files
            if k.startswith(f"{i}/")}


def _jax_backend(flat, esdf):
    n = flat.num_pieces
    if n not in _JIT:
        _JIT[n] = jax.jit(lambda f, e: jb.plan_backend(f, e, _CFG.backend))
    return _JIT[n](flat, esdf)


def _x_of(mod, res, xp):
    """Packed solver variables of a plan (inner yaw/s, tail s, tau)."""
    tau = mod.real_to_virtual_time(res.times)
    return mod.pack_vars(res.inner, res.tail_state[..., 1, 0], tau)


def _jax_terms(x, flat, esdf):
    cfg = _CFG.backend
    return jb.stage2_cost_breakdown(
        x, flat, esdf, cfg.safe_dis, jnp.zeros(2), jnp.ones(2) * 1e4, cfg)


def _port_terms(x, flat, esdf):
    cfg = _CFG.backend
    B = x.shape[0]
    return tb.stage2_cost_breakdown(
        x, flat, esdf, torch.full((B,), cfg.safe_dis, dtype=x.dtype),
        torch.zeros(B, 2, dtype=x.dtype),
        torch.full((B, 2), 1e4, dtype=x.dtype), from_jax_numpy(cfg))


@pytest.fixture(scope="module", params=range(N_ATTEMPTS),
                ids=lambda i: f"t{float(attempt(i)['t']):.3f}")
def both(request):
    a = attempt(request.param)
    sp = [p for p in a["start_path"]] or None
    jesdf = JESDF(dist=jnp.asarray(a["esdf_dist"]),
                  lower=jnp.asarray(a["esdf_lower"]),
                  res=jnp.asarray(a["esdf_res"]))
    tesdf = TESDF(dist=torch.as_tensor(a["esdf_dist"]),
                  lower=torch.as_tensor(a["esdf_lower"]),
                  res=torch.as_tensor(a["esdf_res"]))
    kw = dict(start_path=sp)
    fj = j_frontend(a["esdf_dist"], tuple(a["lower"]), float(a["res"]),
                    a["start_xyt"], a["goal"], _CFG.frontend, a["start_vaj"],
                    a["start_oaj"], jnp.float64, **kw)
    ft = t_frontend(a["esdf_dist"], tuple(a["lower"]), float(a["res"]),
                    a["start_xyt"], a["goal"], from_jax_numpy(_CFG.frontend),
                    a["start_vaj"], a["start_oaj"], torch.float64,
                    device="cpu", **kw)
    rj = jax.tree.map(np.asarray, _jax_backend(fj, jesdf))
    with torch.no_grad():
        rt = tb.plan_backend(ft, tesdf, from_jax_numpy(_CFG.backend))
    return dict(a=a, fj=fj, ft=ft, rj=rj, rt=rt, jesdf=jesdf, tesdf=tesdf)


def test_front_ends_agree_bit_for_bit(both):
    fj, ft = both["fj"], both["ft"]
    assert ft.num_pieces == fj.num_pieces
    for f in fj._fields:
        a = np.asarray(getattr(fj, f))
        b = getattr(ft, f)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b[0].numpy(), a, err_msg=f)


def test_both_back_ends_accept(both):
    rj, rt = both["rj"], both["rt"]
    assert not bool(rj.collision)
    assert bool(rt.collision[0]) == bool(rj.collision)
    assert int(rt.replans[0]) == int(rj.replans)
    tol = _CFG.backend.alm.tolerance
    assert np.linalg.norm(rj.final_xy_err) < 3 * tol
    assert float(torch.linalg.norm(rt.final_xy_err[0])) < 3 * tol


def test_plans_within_the_chaotic_band(both):
    rj, rt = both["rj"], both["rt"]
    np.testing.assert_allclose(rt.inner[0].numpy(), rj.inner, rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(rt.times[0].numpy(), rj.times, rtol=0,
                               atol=0.25)
    xj = _x_of(jb, jax.tree.map(jnp.asarray, rj), jnp)
    tj = _jax_terms(xj, both["fj"], both["jesdf"])
    xt = _x_of(tb, rt, torch)
    tt = _port_terms(xt, both["ft"], both["tesdf"])
    cj, ct = float(tj["total"]), float(tt["total"][0])
    assert abs(ct - cj) <= 0.02 * abs(cj), (ct, cj)


def test_cost_breakdown_matches_jax_at_jax_plan(both):
    rj = both["rj"]
    xj = _x_of(jb, jax.tree.map(jnp.asarray, rj), jnp)
    tj = _jax_terms(xj, both["fj"], both["jesdf"])
    tt = _port_terms(torch.as_tensor(np.array(xj))[None], both["ft"],
                     both["tesdf"])
    assert set(tt) == set(tj)
    for k in tj:
        np.testing.assert_allclose(tt[k][0].numpy(), np.asarray(tj[k]),
                                   rtol=1e-9, atol=1e-9, err_msg=k)


# --- stage2_cost_breakdown on the JAX back-end test's scene -------------

@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32],
                         ids=["f64", "f32"])
def test_cost_breakdown_sums_to_total(dtype):
    """tests/test_backend.py::test_cost_breakdown_sums_to_total on the
    port: the terms sum to `stage2_cost` (1e-10 relative at float64,
    1e-5 at float32), the collision term is not negative, and every term
    equals JAX's (1e-10 / 1e-5 relative)."""
    from tests.test_backend import CFG, _map_with_block, _straight_flat_traj

    flat = _straight_flat_traj([1.0, 4.0], [6.0, 4.0], 4, dtype=dtype)
    esdf = _map_with_block(block=(30, 40, 30, 37))
    esdf = esdf._replace(dist=esdf.dist.astype(dtype))
    n = flat.num_pieces
    tau0 = jb.real_to_virtual_time(jnp.full((n,), flat.init_piece_time,
                                            dtype))
    x0 = jb.pack_vars(flat.inner_yaw_s, flat.final_state[1, 0], tau0)
    lam = jnp.asarray([0.3, -0.2], dtype)
    rho = jnp.full((2,), 1e4, dtype)
    ref = jb.stage2_cost_breakdown(x0, flat, esdf, 0.6, lam, rho, CFG)

    tflat = from_jax_numpy(jax.tree.map(lambda a: np.array(a)[None], flat))
    tflat = tflat._replace(init_piece_time=tflat.init_piece_time[0])
    tesdf = from_jax_numpy(jax.tree.map(np.array, esdf))
    tcfg = from_jax_numpy(CFG)
    x = torch.as_tensor(np.array(x0))[None]
    tdt = x.dtype
    args = (torch.full((1,), 0.6, dtype=tdt),
            torch.as_tensor(np.array(lam))[None],
            torch.as_tensor(np.array(rho))[None], tcfg)
    terms = tb.stage2_cost_breakdown(x, tflat, tesdf, *args)
    total = tb.stage2_cost(x, tflat, tesdf, *args)
    rtol = 1e-10 if dtype == jnp.float64 else 1e-5
    np.testing.assert_allclose(terms["total"].numpy(), total.numpy(),
                               rtol=rtol)
    assert float(terms["collision"][0]) >= 0.0
    assert float(terms["collision"][0]) > 0.0 or float(ref["collision"]) == 0
    for k in ref:
        np.testing.assert_allclose(terms[k][0].numpy(), np.asarray(ref[k]),
                                   rtol=rtol, atol=rtol, err_msg=k)
