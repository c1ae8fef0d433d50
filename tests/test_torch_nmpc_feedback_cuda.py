"""The NMPC feedback kernel (`csrc/nmpc_feedback.cu`, wrapped by
`ops/nmpc_feedback_cuda.py`) against its plain version
`control/nmpc.py::_feedback_matfree`.

On the CPU: the shared nvcc build keys each source's library by a hash
of the source and the flags; the wrapper imports without nvcc or a card;
the kernel's stage weights (a plain twin of its formula) equal
`stage_weights`; a torch model of the kernel's warp layout (thread t
holds stages t*K .. t*K + K-1; scans as thread sums, a Hillis-Steele
scan of the thread totals and a pass over the thread's stages) equals
the plain feedback in float64 at K = 1..4 with the box active.

On the card (marked `cuda`, skipped without one): the kernel against the
plain feedback on the same CUDA inputs at B in {1, 7, 4096}, N in {8,
30, 50, 100}, float64 within 1e-10 and float32 within 2e-4 (u in m/s
of O(1) commands, x in m) on every lane but the rare one where one of
the QP's discrete choices flips, held there to the float64 solution's
QP objective (`_assert_close`); the cold-start tick; 200 ticks of `batched_tracking_step` on
both paths within the benchmark's `u_cmd_gap` limit (3e-3); one launch
and one `nmpc.feedback_kernel` count a tick; a CUDA graph's replay bit
for bit the eager launch; the raises.  Run there with `python -m pytest
--noconftest -m cuda tests/test_torch_nmpc_feedback_cuda.py` (the
conftest imports JAX; this file does not).
"""
import inspect

import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.control import nmpc as tn
from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
from alore_legged_manipulator_tpu_torch.ops import cuda_build
from alore_legged_manipulator_tpu_torch.ops import nmpc_feedback_cuda as nfc
from alore_legged_manipulator_tpu_torch.ops.qp import (
    PNCG_REG, _safe, box_qp_pncg_op)
from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
from alore_legged_manipulator_tpu_torch.parallel.scaling import (
    _tiny_traj, make_fleet)
from alore_legged_manipulator_tpu_torch.utils import profiling as tp

torch.set_num_threads(1)

ICR = ICRParams(-0.3, 0.3, 0.2)
SCALED = dict(state_cost_scaling=0.7, input_cost_scaling=1.3)


def _inputs(B, n, dtype, device="cpu", seed=0):
    """(carry, prep, x_est, ref_x, ref_u) of a lane batch whose references
    ask for 1-6 m/s forward and wheels of +-4 m/s, beyond the +-3 m/s box,
    so that the QP's bounds are active."""
    rng = np.random.default_rng(seed)
    x_traj = rng.standard_normal((B, n + 1, 3)) * 0.1
    u_traj = rng.standard_normal((B, n, 2)) * 0.5
    x_est = rng.standard_normal((B, 3)) * 0.1
    ts = 0.01 * np.arange(1, n + 2)
    speed = rng.uniform(1.0, 6.0, (B, 1))
    ref_x = np.stack([speed * ts, 0.2 * np.sin(3 * ts) + 0 * speed,
                      0.5 * ts + 0 * speed], axis=1)
    ref_u = np.stack([np.full((B, n + 1), 4.0), np.full((B, n + 1), -4.0)],
                     axis=1) * np.sign(rng.standard_normal((B, 1, 1)))
    t = [torch.as_tensor(a, dtype=dtype, device=device)
         for a in (x_traj, u_traj, x_est, ref_x, ref_u)]
    carry = tn.NmpcCarry(t[0], t[1])
    cfg = tn.NmpcConfig(horizon=n)
    return carry, tn.prepare_tri(carry, ICR, cfg), t[2], t[3], t[4]


def _scalars(cfg):
    """The kernel's scalar arguments under cfg, as `feedback` passes them."""
    return dict(q_diag=cfg.q_diag, r_diag=cfg.r_diag,
                state_cost_scaling=cfg.state_cost_scaling,
                input_cost_scaling=cfg.input_cost_scaling, u_min=cfg.u_min,
                u_max=cfg.u_max, qp_iters=cfg.qp_iters, cg_iters=cfg.cg_iters,
                reg=PNCG_REG)


# -- on the CPU --------------------------------------------------------------

def test_nvcc_build_keys_each_source_and_flags_apart(tmp_path):
    wf = cuda_build.CSRC / "wavefront.cu"
    fb = cuda_build.CSRC / "nmpc_feedback.cu"
    a, b = cuda_build.library_path(wf), cuda_build.library_path(fb)
    assert a.parent.parent == b.parent.parent == cuda_build.BUILD_ROOT
    assert a.parent.name.startswith("wavefront-") and a.name == \
        "libwavefront.so"
    assert b.parent.name.startswith("nmpc_feedback-") and b.name == \
        "libnmpc_feedback.so"
    assert cuda_build.library_path(fb, ("-DX",)) != b
    # one library for each (dtype, stages a thread) the feedback launches
    libs = {nfc.library_path(dt, n) for dt in (torch.float32, torch.float64)
            for n in (8, 50, 100, 127)}
    assert len(libs) == 6 and b not in libs
    assert nfc.library_path() == nfc.library_path(torch.float32, 40) == \
        cuda_build.library_path(fb, ("-DFEEDBACK_SCALAR=float",
                                     "-DFEEDBACK_K=2"))
    # the hash is over the source's bytes: an edited copy moves
    edited = tmp_path / "nmpc_feedback.cu"
    edited.write_bytes(fb.read_bytes() + b"\n")
    assert cuda_build.library_path(edited).parent.name != b.parent.name
    same = tmp_path / "copy" / "nmpc_feedback.cu"
    same.parent.mkdir()
    same.write_bytes(fb.read_bytes())
    assert cuda_build.library_path(same) == b


def test_wrapper_needs_no_library_off_the_card(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(nfc, "_load", forbidden)
    monkeypatch.setattr(nfc, "build", forbidden)
    carry, prep, x_est, ref_x, ref_u = _inputs(3, 8, torch.float64)
    cfg = tn.NmpcConfig(horizon=8)
    before = nfc.LAUNCHES["nmpc_feedback"]
    tn.feedback(carry, prep, x_est, ref_x, ref_u, ICR, cfg)
    assert nfc.LAUNCHES["nmpc_feedback"] == before
    with pytest.raises(ValueError, match="CUDA"):
        nfc.nmpc_feedback_cuda(carry.x_traj, carry.u_traj, prep, x_est,
                               ref_x, ref_u, **_scalars(cfg))


def _kernel_stage_weights(cfg, dtype):
    """The kernel's stage weights as a plain twin of its formula: q
    (N+1, 3) zero at stage 0, q_diag * exp((-i / N) * s_x) at stage i,
    stage N taking stage N-1's decay; r (N, 2) = r_diag * exp((-j / N) *
    s_u).  The decays over the same arange as `stage_weights`, so that
    the vectorised exp rounds alike."""
    n = cfg.horizon
    i = torch.arange(n, dtype=dtype)
    ex = torch.exp(-i / n * cfg.state_cost_scaling)
    eu = torch.exp(-i / n * cfg.input_cost_scaling)
    s = torch.arange(n + 1)
    q = torch.tensor(cfg.q_diag, dtype=dtype) * ex[s.clamp(max=n - 1), None]
    q = torch.where((s >= 1)[:, None], q, torch.zeros((), dtype=dtype))
    return q, torch.tensor(cfg.r_diag, dtype=dtype) * eu[:, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scaling", [{}, SCALED])
def test_kernel_stage_weights_equal_stage_weights(dtype, scaling):
    cfg = tn.NmpcConfig(**scaling)
    qs, rs, qn = tn.stage_weights(cfg, dtype)
    q, r = _kernel_stage_weights(cfg, dtype)
    # _feedback_matfree's q: stage 0 unweighted, stage N the terminal qn
    want = torch.cat([torch.zeros((1, 3), dtype=dtype), qs[1:], qn[None]])
    assert torch.equal(q, want) and torch.equal(r, rs)
    if scaling:
        assert float(qs[-1, 0]) < float(qs[1, 0])


def test_reg_is_the_plain_qps():
    assert PNCG_REG == inspect.signature(
        box_qp_pncg_op).parameters["reg"].default


def test_stages_per_thread_and_packed_rows():
    assert [nfc.stages_per_thread(n) for n in (8, 30, 31, 50, 100, 127)] \
        == [1, 1, 1, 2, 4, 4]
    t = torch.zeros((4, 6))
    assert nfc._packed_rows(t[:, :3]).data_ptr() == t.data_ptr()
    assert nfc._packed_rows(t[:, :3]).stride() == (6, 1)
    col = nfc._packed_rows(t[:, ::2])
    assert col.is_contiguous() and col.data_ptr() != t.data_ptr()
    e = torch.zeros((1, 3, 5)).expand(4, 3, 5)
    assert nfc._packed_rows(e).stride() == (0, 5, 1)


def _model_scan(c, K, reverse=False):
    """The kernel's exclusive scan of the columns of c (B, 32K, M) in its
    order; reverse: the suffix scan, the prefix scan of the flipped lane."""
    if reverse:
        return _model_scan(c.flip(1), K).flip(1)
    B, S, M = c.shape
    c = c.view(B, 32, K, M)
    lane = torch.arange(32)[None, :, None]
    run = c[:, :, 0]
    for k in range(1, K):
        run = run + c[:, :, k]
    for d in (1, 2, 4, 8, 16):
        o = torch.zeros_like(run)
        o[:, d:] = run[:, :-d]
        run = torch.where(lane >= d, run + o, run)
    o = torch.zeros_like(run)
    o[:, 1:] = run[:, :-1]
    run, out = o, torch.empty_like(c)
    for k in range(K):
        out[:, :, k] = run
        run = run + c[:, :, k]
    return out.view(B, S, M)


def _kernel_model(carry, prep, x_est, ref_x, ref_u, cfg):
    """csrc/nmpc_feedback.cu's arithmetic as torch over (lane, 32K stages)."""
    x_int, a02, a12, B0, B1, B2 = prep
    nb, n, dt = carry.x_traj.shape[0], cfg.horizon, carry.x_traj.dtype
    K = nfc.stages_per_thread(n)
    S = 32 * K
    s = torch.arange(S)

    def pad(t):
        out = t.new_zeros((nb, S) + tuple(t.shape[2:]))
        out[:, :t.shape[1]] = t
        return out

    def scan(cols, reverse=False):
        return _model_scan(torch.stack(cols, -1), K, reverse).unbind(-1)

    x0, u0 = pad(carry.x_traj), pad(carry.u_traj)
    xr, ur = pad(ref_x.transpose(1, 2)), pad(ref_u.transpose(1, 2)[:, :n])
    d = pad(x_int - carry.x_traj[:, 1:])
    a02, a12, b0, b1, b2 = (pad(t) for t in (a02, a12, B0, B1, B2))
    dx0 = x_est - carry.x_traj[:, 0]
    al, be, pd2 = scan([a02, a12, d[..., 2]])
    ac = torch.cat([al[:, 1:], al[:, -1:]], 1)
    bc = torch.cat([be[:, 1:], be[:, -1:]], 1)
    epsi = dx0[:, 2:3] + pd2
    e0, e1 = scan([d[..., 0] + a02 * epsi, d[..., 1] + a12 * epsi])
    aoff = torch.stack([dx0[:, 0:1] + e0, dx0[:, 1:2] + e1, epsi], -1)

    q, r = (pad(w[None])[0] for w in _kernel_stage_weights(cfg, dt))

    def cmat(p):
        u, v, w = ((bb * p).sum(-1) for bb in (b0, b1, b2))
        pu, pv, pw, paw, pbw = scan([u, v, w, ac * w, bc * w])
        return torch.stack([pu + al * pw - paw, pv + be * pw - pbw, pw], -1)

    def ctmat(y):
        s0, s1, s2, sa0, sb1 = scan([y[..., 0], y[..., 1], y[..., 2],
                                     al * y[..., 0], be * y[..., 1]], True)
        t = sa0 + sb1 + s2 - ac * s0 - bc * s1
        return b0 * s0[..., None] + b1 * s1[..., None] + b2 * t[..., None]

    def hess(p):
        return ctmat(q * cmat(p)) + r * p

    def dot(a, b):
        return (a * b).sum((1, 2))[:, None, None]

    g = ctmat(q * (x0 + aoff - xr)) + r * (u0 - ur)
    s0, s0a, s0a2, s1, s1b, s1b2, s2 = scan(
        [q[:, 0] * torch.ones_like(al), q[:, 0] * al, q[:, 0] * al * al,
         q[:, 1] * torch.ones_like(be), q[:, 1] * be, q[:, 1] * be * be,
         q[:, 2] * torch.ones_like(al)], True)
    c0x, c1x = s0a - ac * s0, s1b - bc * s1
    c0xx = s0a2 - 2 * ac * s0a + ac * ac * s0
    c1xx = s1b2 - 2 * bc * s1b + bc * bc * s1
    dd = (b0 * b0 * s0[..., None] + 2 * b0 * b2 * c0x[..., None]
          + b1 * b1 * s1[..., None] + 2 * b1 * b2 * c1x[..., None]
          + b2 * b2 * (c0xx + c1xx + s2)[..., None])
    dH = dd + r + PNCG_REG

    inp = (s < n)[None, :, None]
    lb = torch.where(inp, cfg.u_min - u0, 0.0)
    ub = torch.where(inp, cfg.u_max - u0, 0.0)
    z = torch.minimum(torch.maximum(torch.zeros_like(lb), lb), ub)
    for _ in range(cfg.qp_iters):
        grad = hess(z) + g
        fr = ~(((z <= lb) & (grad > 0)) | ((z >= ub) & (grad < 0)))
        res = torch.where(fr, -grad, 0.0)
        mi = torch.where(inp, torch.where(fr, 1.0 / dH, 1.0), 0.0)
        x, hx, pd = torch.zeros_like(z), torch.zeros_like(z), mi * res
        rz = dot(res, pd)
        for _ in range(cfg.cg_iters):
            ap = hess(torch.where(fr, pd, 0.0))
            ap = torch.where(fr, ap, pd) + PNCG_REG * pd
            alpha = rz / _safe(dot(pd, ap))
            x, hx, res = x + alpha * pd, hx + alpha * ap, res - alpha * ap
            zn = mi * res
            rz_new = dot(res, zn)
            pd = zn + rz_new / _safe(rz) * pd
            rz = rz_new
        a_star = torch.clamp(-dot(grad, x) / _safe(dot(x, hx)), 0.0, 1.0)
        best, zb = None, None
        for a in (torch.ones_like(a_star), a_star, 0.5 + 0 * a_star,
                  0.125 + 0 * a_star):
            zt = torch.minimum(torch.maximum(z + a * x, lb), ub)
            dv = zt - z
            dfs = dot(grad, dv) + 0.5 * dot(dv, hess(dv))
            if best is None:
                best, zb = dfs, zt
            else:
                take = dfs < best
                best, zb = torch.where(take, dfs, best), torch.where(
                    take, zt, zb)
        z = torch.where(best < 0, zb, z)
    x_new = (x0 + cmat(z) + aoff)[:, :n + 1]
    return x_new, (u0 + z)[:, :n]


@pytest.mark.parametrize("n", [8, 30, 50, 100])
@pytest.mark.parametrize("scaling", [{}, SCALED])
def test_warp_layout_model_matches_plain(n, scaling):
    carry, prep, x_est, ref_x, ref_u = _inputs(5, n, torch.float64, seed=n)
    cfg = tn.NmpcConfig(horizon=n, **scaling)
    _, x_p, u_p = tn._feedback_matfree(carry, prep, x_est, ref_x, ref_u, cfg)
    x_m, u_m = _kernel_model(carry, prep, x_est, ref_x, ref_u, cfg)
    assert float((x_m - x_p).abs().max()) < 1e-10
    assert float((u_m - u_p).abs().max()) < 1e-10
    # the box is active: some wheel sits on a bound
    assert bool(((u_p.abs() - 3.0).abs() < 1e-9).any())


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.init()
    return torch.device("cuda")


TOL = {torch.float64: 1e-10, torch.float32: 2e-4}
# the share of lanes whose float32 result may leave TOL when one of the
# QP's discrete choices flips, and the objective those lanes must reach
FLIP_SHARE = 1e-3
OBJ_REL = 1e-6


def _gap(a, b):
    return float((a - b).abs().max())


def _lane_gap(a, b):
    return (a - b).abs().flatten(1).amax(1)


def _qp_objective(du, carry, prep, x_est, ref_x, ref_u, cfg):
    """0.5 du'H du + g'du of each lane's QP, through the plain operators."""
    n, nb = cfg.horizon, du.shape[0]
    ops = tn._tri_ops_factors(carry.x_traj, *prep, x_est - carry.x_traj[:, 0])
    qs, rs, qn = tn.stage_weights(cfg, du.dtype, du.device)
    q = torch.cat([torch.zeros_like(qn)[None], qs[1:], qn[None]])
    p2 = du.reshape(nb, n, 2)
    hp = tn._tri_ctmat(ops, q * tn._tri_cmat(ops, p2)) + rs * p2
    g = (tn._tri_ctmat(ops, q * (carry.x_traj + ops.a_off
                                 - ref_x.transpose(1, 2)))
         + rs * (carry.u_traj - ref_u.transpose(1, 2)[:, :n]))
    return (p2 * (0.5 * hp + g)).sum((1, 2))


def _assert_close(kernel, plain, args, cfg, dtype):
    """float64: every lane within 1e-10 of the plain version.  float32:
    every lane within 2e-4 (u in m/s, x in m; the two versions sum in
    other orders), except where one of the QP's discrete choices (the
    free set, the line search's candidate) flips between the two float32
    runs: at N = 100 about one lane in 4096 then moves by ~3e-3, and the
    plain float32 version flips against the float64 solution as often.
    At most FLIP_SHARE of the lanes may flip, and every lane's kernel
    result must reach the float64 solution's QP objective within OBJ_REL
    (relative; both float32 versions come within ~2e-9)."""
    gap = torch.maximum(_lane_gap(kernel[0], plain[0]),
                        _lane_gap(kernel[1], plain[1]))
    if dtype == torch.float64:
        assert float(gap.max()) < TOL[dtype], float(gap.max())
        return
    flips = int((gap >= TOL[dtype]).sum())
    assert flips <= FLIP_SHARE * gap.numel(), (flips, float(gap.max()))
    c64 = tn.NmpcCarry(*(t.double() for t in args[0]))
    rest = (tuple(t.double() for t in args[1]),
            *(t.double() for t in args[2:]))
    _, _, u64 = tn._feedback_matfree(c64, *rest, cfg)
    j64 = _qp_objective(u64 - c64.u_traj, c64, *rest, cfg)
    jk = _qp_objective(kernel[1].double() - c64.u_traj, c64, *rest, cfg)
    excess = float(((jk - j64) / j64.abs().clamp(min=1e-12)).max())
    assert excess < OBJ_REL, excess


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [8, 30, 50, 100])
@pytest.mark.parametrize("B", [1, 7, 4096])
def test_kernel_matches_plain_on_card(cuda_device, B, n, dtype):
    for seed, scaling in ((B + n, {}), (B + n + 1, SCALED)):
        carry, prep, x_est, ref_x, ref_u = _inputs(B, n, dtype, cuda_device,
                                                   seed)
        cfg = tn.NmpcConfig(horizon=n, **scaling)
        _, x_p, u_p = tn._feedback_matfree(carry, prep, x_est, ref_x, ref_u,
                                           cfg)
        before = nfc.LAUNCHES["nmpc_feedback"]
        c_k, x_k, u_k = tn.feedback(carry, prep, x_est, ref_x, ref_u, ICR,
                                    cfg)
        torch.cuda.synchronize()
        assert nfc.LAUNCHES["nmpc_feedback"] == before + 1
        assert x_k.shape == x_p.shape and u_k.shape == u_p.shape
        assert c_k.x_traj is x_k and c_k.u_traj is u_k
        _assert_close((x_k, u_k), (x_p, u_p),
                      (carry, prep, x_est, ref_x, ref_u), cfg, dtype)
        assert bool(((u_p.abs() - 3.0).abs() < 1e-6).any())


def _plain_feedback(x_traj, u_traj, prep, x_est, ref_x, ref_u, *, reg,
                    **scalars):
    """The kernel's signature over the plain feedback, its config rebuilt
    from the scalars the kernel is given."""
    assert reg == PNCG_REG
    cfg = tn.NmpcConfig(horizon=x_traj.shape[1] - 1, **scalars)
    _, x_new, u_new = tn._feedback_matfree(tn.NmpcCarry(x_traj, u_traj),
                                           prep, x_est, ref_x, ref_u, cfg)
    return x_new, u_new


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cold_start_matches_plain_on_card(cuda_device, monkeypatch, dtype):
    _, _, x_est, ref_x, ref_u = _inputs(64, 50, dtype, cuda_device)
    cfg = tn.NmpcConfig()
    got = tn.nmpc_cold_start_step(x_est, ref_x, ref_u, cfg, dtype)
    monkeypatch.setattr(tn, "nmpc_feedback_cuda", _plain_feedback)
    want = tn.nmpc_cold_start_step(x_est, ref_x, ref_u, cfg, dtype)
    for a, b in zip((got[0].x_traj, got[0].u_traj, got[1]),
                    (want[0].x_traj, want[0].u_traj, want[1])):
        assert _gap(a, b) < TOL[dtype]


def _loop(device, lanes, ticks, horizon=50):
    cfg = tn.NmpcConfig(horizon=horizon)
    tt, icr = _tiny_traj()
    tt = pm.tree_map(lambda x: x.to(device), tt)
    step = pm.batched_tracking_step(tt, icr, nmpc_cfg=cfg)
    state = make_fleet(lanes, cfg, device=device)[:4]
    noise = torch.zeros((lanes, 5, 2), device=device)
    cmds = []
    for k in range(ticks):
        out = step(*state, noise, k * cfg.dt)
        state = out[:4]
        cmds.append(out[3])
    return torch.stack(cmds)


@pytest.mark.cuda
def test_closed_loop_200_ticks_on_both_paths(cuda_device, monkeypatch):
    got = _loop(cuda_device, 64, 200)
    monkeypatch.setattr(tn, "nmpc_feedback_cuda", _plain_feedback)
    want = _loop(cuda_device, 64, 200)
    assert bool(torch.isfinite(got).all())
    assert _gap(got, want) < 3e-3


@pytest.mark.cuda
def test_one_launch_and_one_count_a_tick(cuda_device):
    cfg = tn.NmpcConfig()
    tt, icr = _tiny_traj()
    tt = pm.tree_map(lambda x: x.to(cuda_device), tt)
    step = pm.batched_tracking_step(tt, icr, nmpc_cfg=cfg)
    state = make_fleet(1, cfg, device=cuda_device)[:4]
    noise = torch.zeros((1, 5, 2), device=cuda_device)
    state = step(*state, noise, 0.0)[:4]
    torch.cuda.synchronize()
    tp.disable()
    tp.reset()
    before = nfc.LAUNCHES["nmpc_feedback"]
    tp.enable()
    try:
        step(*state, noise, 0.01)
    finally:
        tp.disable()
    assert nfc.LAUNCHES["nmpc_feedback"] == before + 1
    (q,) = tp.snapshot()["requests"]
    tp.reset()
    assert q["spans"]["nmpc.feedback"]["counts"].get(
        "nmpc.feedback_kernel") == 1
    assert q["counts"]["nmpc.feedback_kernel"] == 1
    assert "host_syncs" not in q["spans"]["nmpc.feedback"]["counts"]


@pytest.mark.cuda
def test_graph_replay_equals_eager_launch(cuda_device):
    carry, prep, x_est, ref_x, ref_u = _inputs(16, 50, torch.float32,
                                               cuda_device)
    cfg = tn.NmpcConfig()
    eager = nfc.nmpc_feedback_cuda(carry.x_traj, carry.u_traj, prep, x_est,
                                   ref_x, ref_u, **_scalars(cfg))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nfc.nmpc_feedback_cuda(carry.x_traj, carry.u_traj, prep, x_est,
                               ref_x, ref_u, **_scalars(cfg))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = nfc.nmpc_feedback_cuda(carry.x_traj, carry.u_traj, prep,
                                          x_est, ref_x, ref_u,
                                          **_scalars(cfg))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], eager[0])
    assert torch.equal(captured[1], eager[1])


@pytest.mark.cuda
def test_inputs_the_kernel_does_not_take_raise(cuda_device):
    carry, prep, x_est, ref_x, ref_u = _inputs(2, 128, torch.float32,
                                               cuda_device)
    with pytest.raises(ValueError, match="horizons"):
        tn.feedback(carry, prep, x_est, ref_x, ref_u, ICR,
                    tn.NmpcConfig(horizon=128))
    carry, prep, x_est, ref_x, ref_u = _inputs(2, 8, torch.float32,
                                               cuda_device)
    cfg = tn.NmpcConfig(horizon=8)
    as_int = [t.to(torch.int32) for t in (carry.x_traj, carry.u_traj)]
    with pytest.raises(ValueError, match="float32 or float64"):
        nfc.nmpc_feedback_cuda(*as_int, prep, x_est, ref_x, ref_u,
                               **_scalars(cfg))
    with pytest.raises(ValueError, match="every tensor on"):
        tn.feedback(carry, prep, x_est.cpu(), ref_x, ref_u, ICR, cfg)
