"""The port's back end held to the compiled reference optimizer's goldens
(tests/golden/backend), port only, on the CPU, with
tests/test_backend_parity.py's tolerances.

* Layer 1, MINCO (`minco_s0_n7`, `minco_s1_n3`, `minco_s2_n12`) through
  every spline solve of `solvers/minco.py`: `minco_coeffs` under
  `set_small_n_solver` "lu", "thomas_scan" and "cr", and the reference
  layout `minco_coeffs_dense`.  Float64: coefficients within rtol 1e-9
  / atol 1e-11, the energy within 1e-8 relative, its gradients by inner
  points, times and tail position (autograd through the solve) within
  rtol 1e-8 / atol 1e-9.  Float32: each piece's positions on 21 points
  within 5e-3 of the oracle's spline.
* Layer 2, `stage1_cost` / `stage2_cost` (`straight`, `turn`, `cut`) at
  the oracle's decision vectors.  Float64: both costs within 1e-9 of
  max(1, |cost|), each gradient the derivative of its cost (central
  differences along a random direction and along its gap to the
  oracle's hand-written gradient), within 6% of the oracle's at the
  operating point (the stage-1 time gradient corrected for the
  reference's 20 / 50 time-weight quirk), `final_xy_error` within rtol
  1e-8 / atol 1e-10.  Float32: the stage-2 cost within 3e-4 relative.
* Layer 3, `plan_backend` (eager, B=1, float64): no collision, the
  end-point residual under 1.5x the ALM tolerance, the duration within
  20% of the reference solve's, the flow sweep within a 0.25 m Hausdorff
  tube of the reference's, the end within 0.05 m.
"""
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.core.flow import flow_state_sequence
from alore_legged_manipulator_tpu_torch.core.poly import PolyTraj
from alore_legged_manipulator_tpu_torch.ops.esdf import ESDF
from alore_legged_manipulator_tpu_torch.planner import backend as tb
from alore_legged_manipulator_tpu_torch.planner.flat_traj import FlatTraj
from alore_legged_manipulator_tpu_torch.solvers import minco as tm
from tests import torch_golden_io as gio

torch.set_num_threads(1)

SOLVERS = ("lu", "thomas_scan", "cr", "dense")


@pytest.fixture(autouse=True)
def restore_small_n_solver():
    prev = tm.SMALL_N_SOLVER
    yield
    tm.set_small_n_solver(prev)


# ---------------------------------------------------------------------------
# layer 1: MINCO
# ---------------------------------------------------------------------------

def minco_coeffs_by(solver):
    """The spline solve `solver` names; sets the small-N mode for the
    three reduced-system paths (the caller restores it)."""
    if solver == "dense":
        return tm.minco_coeffs_dense
    tm.set_small_n_solver(solver)
    return tm.minco_coeffs


def minco_checks(case, solver, dtype, device="cpu"):
    head, tail, inner, times, ew, ref = gio.minco_case(case)
    n = len(times)
    ref_c = gio.minco_ref_coeffs(ref, n)
    coeffs_fn = minco_coeffs_by(solver)

    def t(a):
        return torch.tensor(np.asarray(a)[None], dtype=dtype, device=device)
    lbl = f"{case} {solver} {str(dtype)[6:]}"
    if dtype == torch.float32:
        c = coeffs_fn(t(head), t(tail), t(inner), t(times))[0]
        c = c.to(torch.float64).cpu().numpy()
        pos, pos_ref = [], []
        for i in range(n):
            ts = np.linspace(0, times[i], 21)
            V = np.stack([ts ** k for k in range(6)], 1)
            pos.append(V @ c[i])
            pos_ref.append(V @ ref_c[i])
        return [gio.deviation(lbl + " positions", pos, pos_ref, 5e-3)]

    tail_pos, inner_t, times_t = (t(a).requires_grad_(True)
                                  for a in (tail[:, 0], inner, times))
    with torch.enable_grad():
        tail_t = torch.cat([tail_pos[..., None], t(tail)[..., 1:]], -1)
        c = coeffs_fn(t(head), tail_t, inner_t, times_t)
        e = tm.minco_energy(c, times_t, t(ew)[0])
        g_tail, g_inner, g_times = torch.autograd.grad(
            e.sum(), (tail_pos, inner_t, times_t))

    def np_(x):
        return x[0].detach().cpu().numpy()
    e_ref = ref["energy"]
    return [
        gio.deviation(lbl + " coeffs", np_(c), ref_c, 1e-11, 1e-9),
        gio.bound(lbl + " energy", abs(float(e[0].detach()) - e_ref),
                  1e-8 * max(1.0, abs(e_ref))),
        gio.deviation(lbl + " dE/dinner", np_(g_inner),
                      ref["gradByPoints"].reshape(n - 1, 2).T, 1e-9, 1e-8),
        gio.deviation(lbl + " dE/dtimes", np_(g_times), ref["gradByTimes"],
                      1e-9, 1e-8),
        gio.deviation(lbl + " dE/dtail", np_(g_tail),
                      ref["gradByTailStateS"], 1e-9, 1e-8)]


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("case", gio.MINCO_CASES)
def test_minco_parity_f64(case, solver):
    gio.assert_checks(minco_checks(case, solver, torch.float64))


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("case", gio.MINCO_CASES)
def test_minco_parity_f32(case, solver):
    gio.assert_checks(minco_checks(case, solver, torch.float32))


# ---------------------------------------------------------------------------
# layer 2: stage-1 / stage-2 costs and gradients
# ---------------------------------------------------------------------------

def scenario(name, dtype, device="cpu"):
    """(FlatTraj, ESDF, BackendConfig, scenario dict), one lane."""
    sc = gio.backend_scenario(name)

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a)[None], dtype=dt, device=device)
    flat = FlatTraj(**{k: t(sc[k], torch.bool if k == "if_cut" else dtype)
                       for k in gio.FLAT_FIELDS})
    esdf = ESDF(dist=torch.tensor(sc["dist"], dtype=dtype, device=device),
                lower=torch.tensor(sc["lower"], dtype=dtype, device=device),
                res=torch.tensor(sc["res"], dtype=dtype, device=device))
    cfg = tb.BackendConfig(standard_diff=sc["standard_diff"],
                           icr_xv=sc["icr_xv"], checkpoints=sc["checkpoints"],
                           safe_dis=sc["safe_dis"])
    return flat, esdf, cfg, sc


def _alm_args(cfg, sc, ref, dtype, device):
    alm = cfg.cut_alm if sc["if_cut"] else cfg.alm
    lam = torch.tensor([alm.lambda0], dtype=dtype, device=device)
    rho = torch.tensor([alm.rho0], dtype=dtype, device=device)
    safe = torch.tensor([float(ref["safeDis"])], dtype=dtype, device=device)
    return safe, lam, rho


def stage_cost_checks(name, device="cpu"):
    """Float64 costs, gradients and end-point residuals at every decision
    vector of the golden."""
    dtype = torch.float64
    flat, esdf, cfg, sc = scenario(name, dtype, device)
    ref = gio.backend_cost(name)
    xs = gio.backend_xs(name)
    n_pieces = flat.num_pieces
    safe, lam, rho = _alm_args(cfg, sc, ref, dtype, device)
    ref_pc, ref_pg, ref_fc, ref_fg, ref_xy = (
        gio.as_list(ref[k]) for k in ("path_cost", "path_grad",
                                      "formal_cost", "formal_grad",
                                      "final_xy_err"))
    # the reference's stage-1 time gradient uses 50, its cost 20
    tw_delta = cfg.weights.time_weight - cfg.path_weights.time_weight

    def s1(z):
        return tb._value_and_grad(lambda q: tb.stage1_cost(q, flat, cfg),
                                  z[None])[:2]

    def s2(z):
        return tb._value_and_grad(
            lambda q: tb.stage2_cost(q, flat, esdf, safe, lam, rho, cfg),
            z[None])[:2]

    def fd_dir(fun, x, d, eps=1e-6):
        d = d / np.linalg.norm(d)
        up = float(fun(torch.tensor(x + eps * d, device=device))[0][0])
        dn = float(fun(torch.tensor(x - eps * d, device=device))[0][0])
        return (up - dn) / (2 * eps), d

    rng = np.random.default_rng(7)
    checks = []
    for k, x in enumerate(xs):
        lbl = f"{name} x[{k}]"
        xt = torch.tensor(x, device=device)
        tau = xt[2 * (n_pieces - 1) + 1:].clone().requires_grad_(True)
        with torch.enable_grad():
            (dT_dtau,) = torch.autograd.grad(
                tb.virtual_to_real_time(tau).sum(), tau)

        c1, g1raw = s1(xt)
        checks.append(gio.bound(lbl + " stage-1 cost",
                                abs(float(c1[0]) - ref_pc[k]),
                                1e-9 * max(1.0, abs(ref_pc[k]))))
        g1raw = g1raw[0].cpu().numpy()
        g1 = g1raw.copy()
        g1[2 * (n_pieces - 1) + 1:] += tw_delta * dT_dtau.cpu().numpy()

        c2, g2 = s2(xt)
        checks.append(gio.bound(lbl + " stage-2 cost",
                                abs(float(c2[0]) - ref_fc[k]),
                                1e-9 * max(1.0, abs(ref_fc[k]))))
        g2 = g2[0].cpu().numpy()

        for stage, graw, gcmp, gref, fun in (
                (1, g1raw, g1, np.asarray(ref_pg[k]), s1),
                (2, g2, g2, np.asarray(ref_fg[k]), s2)):
            dis = gcmp - gref
            dirs = [rng.normal(size=x.shape)]
            if np.linalg.norm(dis) > 1e-9 * np.linalg.norm(gref):
                dirs.append(dis)
            for j, d in enumerate(dirs):
                fd, dn = fd_dir(fun, x, d)
                tol = max(1e-5 * abs(fd), 1e-4 * np.linalg.norm(graw), 1e-3)
                checks.append(gio.bound(
                    f"{lbl} stage-{stage} gradient vs differences [{j}]",
                    abs(graw @ dn - fd), tol))
            if k <= 1:
                rel = np.linalg.norm(dis) / max(np.linalg.norm(gref), 1.0)
                checks.append(gio.bound(
                    f"{lbl} stage-{stage} gradient vs the oracle's", rel,
                    0.06))

        h = tb.final_xy_error(xt[None], flat, cfg)[0].cpu().numpy()
        checks.append(gio.deviation(lbl + " final xy error", h, ref_xy[k],
                                    1e-10, 1e-8))
    return checks


def stage2_f32_checks(name, device="cpu"):
    dtype = torch.float32
    flat, esdf, cfg, sc = scenario(name, dtype, device)
    ref = gio.backend_cost(name)
    safe, lam, rho = _alm_args(cfg, sc, ref, dtype, device)
    checks = []
    for k, x in enumerate(gio.backend_xs(name)):
        fc = gio.as_list(ref["formal_cost"])[k]
        c2 = tb.stage2_cost(torch.tensor(x[None], dtype=dtype, device=device),
                            flat, esdf, safe, lam, rho, cfg)
        checks.append(gio.bound(f"{name} x[{k}] f32 stage-2 cost",
                                abs(float(c2[0]) - fc),
                                3e-4 * max(1.0, abs(fc))))
    return checks


@pytest.mark.parametrize("name", gio.BACKEND_SCENARIOS)
def test_stage_cost_parity_f64(name):
    checks = stage_cost_checks(name)
    assert len(checks) >= 5 * len(gio.backend_xs(name))
    gio.assert_checks(checks)


@pytest.mark.parametrize("name", gio.BACKEND_SCENARIOS)
def test_stage2_cost_parity_f32(name):
    gio.assert_checks(stage2_f32_checks(name))


# ---------------------------------------------------------------------------
# layer 3: full solves (behavioral)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", gio.BACKEND_SCENARIOS)
def test_full_solve_parity(name):
    flat, esdf, cfg, sc = scenario(name, torch.float64)
    ref = gio.backend_solve(name)
    assert ref["ok"] == 1
    res = tb.plan_backend(flat, esdf, cfg)
    assert not bool(res.collision[0])
    tol = cfg.cut_alm.tolerance if sc["if_cut"] else cfg.alm.tolerance
    assert float(torch.linalg.norm(res.final_xy_err[0])) < tol * 1.5
    T_ref = float(ref["times"].sum())
    T_my = float(res.times[0].sum())
    assert abs(T_my - T_ref) < 0.2 * T_ref, (T_my, T_ref)
    seq, _ = flow_state_sequence(
        PolyTraj(coeffs=res.coeffs, times=res.times), flat.start_xytheta,
        0.0 if cfg.standard_diff else cfg.icr_xv, 256)
    mine = seq[0, :, :2].numpy()
    ref_pts = np.stack([ref["sweep_x"], ref["sweep_y"]], 1)
    d = np.linalg.norm(mine[None, :, :] - ref_pts[:, None, :], axis=-1)
    hausdorff = max(d.min(axis=1).max(), d.min(axis=0).max())
    assert hausdorff < 0.25, hausdorff
    np.testing.assert_allclose(mine[-1], ref_pts[-1], atol=0.05)
