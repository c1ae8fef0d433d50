"""Host self time of the ADMM's steps (span `admm.iterate`,
`ops/qp.py::qp_admm_general`, a pass's steps each), median ms per
traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("self_ms", "admm.iterate")
