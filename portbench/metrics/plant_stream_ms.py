"""Stream time of the plant's substeps (span `plant`), median ms per
traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("stream_ms", "plant")
