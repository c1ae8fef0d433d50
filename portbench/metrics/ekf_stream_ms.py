"""Stream time of the ICR-EKF, predict and update together (spans
`ekf.predict`, `ekf.update`), median ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("stream_ms", "ekf.predict", "ekf.update")
