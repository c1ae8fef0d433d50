"""Host duration of the `tick` span
(`parallel/mesh.py::batched_tracking_step`, from its call to its return,
the waits at host syncs included), median ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("host_ms", "tick")
