"""The work of the LTV-MPC's ADMM iterations, from a configuration
alone (`configs/ltv-mpc-3ms.json`), whatever implements them: the
least time an H100 could take for them, for `admm_roofline_pct`.

The QP of one pass has n = 5 (T - delay_num) variables and m = 2 n / 5
+ 3 n / 5 + 2 (T - delay_num - 1) rows (box, dynamics, rates).  Its
structure is sparse: of A's m x n entries only the box, dynamics and
rate entries are nonzero, and the KKT matrix K = H + sigma I + A' rho A
is banded.  The least work of one ADMM step of one lane is two
triangular solves with a factor of K (each a multiply and an add per
nonzero of the factor, which has at least the nonzeros of K's lower
triangle) and a product with A and one with A' (a multiply and an add
per nonzero each): 4 (nnz(tril K) + nnz(A)) operations.  A pass reads
those nonzeros once, in the configuration's dtype.  A dense solver does
far more (2 n^2 + 4 m n a step); its share of this bound is small by
design, so that no implementation can read above 100%.  The structure
is taken from the plain reference's assembly (`reference/ltv_tick.py`)
at a generic linearisation point.  Peaks: NVIDIA's data sheet for the
H100 SXM, float32 outside the tensor cores and HBM3.
"""
import functools
import json

import numpy as np
import torch

from .reference import ltv_tick

PEAK_FLOPS = 67e12      # float32, operations/s
PEAK_BYTES = 3.35e12    # HBM3, bytes/s


def qp_shape(config):
    """(n, m): variables and constraint rows of one pass's QP."""
    ltv = config["ltv"]
    stages = ltv["horizon"] - ltv["delay_num"]
    return 5 * stages, 2 * stages + 3 * stages + 2 * (stages - 1)


@functools.lru_cache(maxsize=8)
def _nonzeros(ltv_json):
    """(nnz(tril K), nnz(A)) of the QP that the reference assembles for
    the configuration's `ltv` block (as JSON), at a point where every
    linearisation entry is nonzero (heading 0.3 rad, speed 0.5 m/s)."""
    ltv = json.loads(ltv_json)
    T = ltv["horizon"]
    f64 = torch.float64
    xbar = torch.tensor([0.0, 0.0, 0.3, 0.5], dtype=f64).repeat(1, T + 1, 1)
    H, _, A, _, _ = ltv_tick.assemble_qp(
        xbar, torch.zeros((1, 4, T), dtype=f64),
        torch.zeros((1, 2, T), dtype=f64), ltv)
    Ha, Aa = H[0].abs(), A[0].abs()
    K = Ha + torch.eye(Ha.shape[0], dtype=f64) + Aa.T @ Aa
    return int((torch.tril(K) != 0).sum()), int((Aa != 0).sum())


def nonzeros(config):
    """(nnz(tril K), nnz(A)) of one pass's QP."""
    return _nonzeros(json.dumps(config["ltv"], sort_keys=True))


def step_flops(config):
    """Least operations of one ADMM step of one lane."""
    return 4 * sum(nonzeros(config))


def pass_bytes(config):
    """Least bytes of the factor and the constraint matrix of one lane."""
    return np.dtype(config["dtype"]).itemsize * sum(nonzeros(config))


def admm_bound_ms(config, lanes, steps):
    """The least time, in ms, for `steps` ADMM steps a lane over `lanes`
    lanes, the passes of the configuration reading their matrices once:
    the larger of operations over the peak rate and bytes over the
    peak bandwidth."""
    ops = lanes * steps * step_flops(config)
    moved = lanes * config["ltv"]["sqp_iters"] * pass_bytes(config)
    return 1e3 * max(ops / PEAK_FLOPS, moved / PEAK_BYTES)
