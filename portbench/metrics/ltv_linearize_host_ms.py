"""Host self time of the LTV-MPC's rollouts and QP assemblies (span
`ltv.linearize`, three passes, `control/ltv_mpc.py::ltv_mpc_tick`),
median ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("self_ms", "ltv.linearize")
