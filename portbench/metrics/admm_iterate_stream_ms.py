"""Stream time of the ADMM's steps (span `admm.iterate`), median ms per
traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("stream_ms", "admm.iterate")
