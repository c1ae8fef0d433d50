"""Host self time of the ADMM's KKT product and Cholesky (span
`admm.factor`, `ops/qp.py::qp_admm_general`, once a pass), median ms
per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("self_ms", "admm.factor")
