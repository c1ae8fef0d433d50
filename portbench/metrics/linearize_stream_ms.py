"""Stream time of the NMPC linearisation (span `nmpc.linearize`), median
ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("stream_ms", "nmpc.linearize")
