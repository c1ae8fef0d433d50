"""Host self time of the NMPC linearisation (span `nmpc.linearize`,
`control/nmpc.py::_linearize`), median ms per traced tick."""
from portbench import spans


def read(rec):
    return spans.span_ms("self_ms", "nmpc.linearize")
