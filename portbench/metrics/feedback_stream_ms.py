"""Stream time of the NMPC feedback (span `nmpc.feedback`: condensing,
box QP, expansion), median ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("stream_ms", "nmpc.feedback")
