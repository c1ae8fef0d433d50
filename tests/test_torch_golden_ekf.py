"""The port's ICR-EKF held to the compiled reference filter's goldens
(tests/golden/ekf: `sweep`, `slow_turn`), port only, on the CPU, with
tests/test_ekf_parity.py's tolerances.

* Float64, replayed op by op from P = 0 through
  `estimator/icr_ekf.py::ekf_predict` / `ekf_update` at the reference
  constructor's Q and R: after every op the state within 1e-10 and the
  covariance within 1e-12 of the oracle's.
* Float32 (the shipped precision) over the whole `sweep`: the final pose
  within 2e-3 and the final ICR within 5e-4.
* The covariance order: propagating with the port's own Jacobian
  (`_dynamics_and_jacobian`) as J' P J, the naive reading of
  icrekf.cpp:205, must leave the oracle's covariance by more than 1e-9
  within 80 ops.
"""
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.estimator.icr_ekf import (
    EkfConfig, EkfState, _dynamics_and_jacobian, ekf_predict, ekf_update)
from tests import torch_golden_io as gio

torch.set_num_threads(1)

CFG = EkfConfig(q_diag=gio.EKF_Q_DIAG, r_diag=gio.EKF_R_DIAG)


def replay(name, dtype, device="cpu"):
    """Yield (op index, state) after each op of the golden's script."""
    x0, ops, _, _ = gio.ekf_case(name)
    st = EkfState(x=torch.tensor(x0[None], dtype=dtype, device=device),
                  P=torch.zeros((1, 6, 6), dtype=dtype, device=device))
    for k, (op, args) in enumerate(ops):
        a = torch.tensor(args[None], dtype=dtype, device=device)
        if op == "F":
            # the oracle's op is (vl, vr, dt); the port's u is (vl, vr)
            st = ekf_predict(st, a[:, :2], float(args[2]), CFG)
        else:
            st = ekf_update(st, a, CFG)
        yield k, st


def ekf_checks(name, device="cpu"):
    """Float64: every op's state and covariance against the oracle's."""
    _, _, gold_x, gold_p = gio.ekf_case(name)
    xs, ps = [], []
    for _, st in replay(name, torch.float64, device):
        xs.append(st.x[0].cpu().numpy())
        ps.append(st.P[0].cpu().numpy())
    return [gio.deviation(f"{name} states", xs, gold_x, 1e-10),
            gio.deviation(f"{name} covariances", ps, gold_p, 1e-12)]


def ekf_f32_checks(device="cpu"):
    """Float32 over the whole `sweep`: the final pose and ICR."""
    _, _, gold_x, _ = gio.ekf_case("sweep")
    for _, st in replay("sweep", torch.float32, device):
        pass
    final = st.x[0].to(torch.float64).cpu().numpy()
    return [gio.deviation("sweep f32 final pose", final[:3], gold_x[-1][:3],
                          2e-3),
            gio.deviation("sweep f32 final ICR", final[3:], gold_x[-1][3:],
                          5e-4)]


@pytest.mark.parametrize("name", gio.EKF_CASES)
def test_ekf_matches_reference_oracle_f64(name):
    gio.assert_checks(ekf_checks(name))


def test_ekf_f32_shipped_precision_tracks_oracle():
    gio.assert_checks(ekf_f32_checks())


def test_covariance_order_matters():
    x0, ops, _, gold_p = gio.ekf_case("sweep")
    x = torch.tensor(x0[None], dtype=torch.float64)
    P = torch.zeros((1, 6, 6), dtype=torch.float64)
    Q = torch.diag(torch.tensor(CFG.q_diag, dtype=torch.float64))
    worst = 0.0
    for k, (op, args) in enumerate(ops[:80]):
        a = torch.tensor(args[None], dtype=torch.float64)
        if op == "F":
            dt = float(args[2])
            x, J = _dynamics_and_jacobian(x, a[:, :2], dt)
            P = J.transpose(1, 2) @ P @ J + dt * dt * Q   # the wrong order
        else:
            st = ekf_update(EkfState(x=x, P=P), a, CFG)
            x, P = st.x, st.P
        worst = max(worst, float(np.abs(P[0].numpy() - gold_p[k]).max()))
    assert worst > 1e-9, "wrong-order propagation unexpectedly matched"
