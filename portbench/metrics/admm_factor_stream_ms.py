"""Stream time of the ADMM's KKT product and Cholesky (span
`admm.factor`, once a pass), median ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("stream_ms", "admm.factor")
