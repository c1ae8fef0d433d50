"""Device-busy time (the union of kernels, copies and sets) per request
of the traced stretch, in ms: per tick, or per plan call.  Read for
`device_ms_per_tick.<cells>` and `device_ms_per_plan` too."""


def read(rec):
    t = rec.get("trace")
    if t is None or t.device_ops == 0:
        return None
    return 1e3 * t.busy_s / rec["traced_requests"]
