"""Stream time of the tick's reference sampling (span `ref`): CUDA
events at the span's start and end, idle included; median ms per traced
tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("stream_ms", "ref")
