"""L-BFGS parameters and status codes (port of solvers/lbfgs.py, the
part the flat solvers in solvers/bfgs.py use; the nested-line-search
`lbfgs_minimize` itself is not ported yet)."""
from __future__ import annotations

from typing import NamedTuple


class LbfgsParams(NamedTuple):
    mem_size: int = 8
    g_epsilon: float = 1.0e-5
    past: int = 3
    delta: float = 1.0e-6
    max_iterations: int = 0          # 0 => a hard cap is applied
    max_linesearch: int = 64
    min_step: float = 1.0e-20
    max_step: float = 1.0e20
    f_dec_coeff: float = 1.0e-4
    s_curv_coeff: float = 0.9
    cautious_factor: float = 1.0e-6
    machine_prec: float = 1.0e-16
    hard_iter_cap: int = 2000
    two_loop_unroll: int = 1         # XLA unroll knob; no effect here


STATUS_CONVERGED = 0
STATUS_STOP = 1
STATUS_MAXITER = 2
STATUS_LS_FAIL = -1
