"""Stream time of the LTV-MPC's rollouts and QP assemblies (span
`ltv.linearize`, three passes), median ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("stream_ms", "ltv.linearize")
