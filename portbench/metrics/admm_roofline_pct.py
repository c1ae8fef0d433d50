"""The ADMM steps' share of their roofline, in %: the least time an H100
could take for the steps the tick counted (counter `admm.iters`) over
the stream time of span `admm.iterate`, medians per traced tick; the
least time from the configuration alone (`portbench/ltv_work.py`)."""
from portbench import ltv_work, spans


def read(rec):
    ms = spans.span_ms("stream_ms", "admm.iterate")
    steps = spans.counter("admm.iters")
    config = rec.get("config")
    if ms is None or steps is None or config is None or ms <= 0:
        return None
    return 100.0 * ltv_work.admm_bound_ms(config, rec["lanes"], steps) / ms
