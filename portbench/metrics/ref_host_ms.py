"""Host self time of the tick's reference sampling (span `ref`,
`control/tracked_traj.py::ref_points`), median ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("self_ms", "ref")
