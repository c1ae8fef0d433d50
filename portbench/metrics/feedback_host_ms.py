"""Host self time of the NMPC feedback: condensing, the box QP
(`ops/qp.py::box_qp_pncg_op`) and the expansion (span `nmpc.feedback`),
median ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("self_ms", "nmpc.feedback")
