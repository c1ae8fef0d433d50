"""The host-speed witness: the `tick` span's host duration over the
device operations launched per tick of the traced stretch, in us per
launch (median tick over `launches_per_tick`)."""
from portbench import spans


def read(rec):
    t, tick = rec.get("trace"), spans.span_ms("host_ms", "tick")
    if t is None or t.device_ops == 0 or tick is None:
        return None
    return 1e3 * tick * rec["traced_requests"] / t.device_ops
