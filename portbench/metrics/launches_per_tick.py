"""Device operations (kernels, copies, sets) the host launched per
request of the traced stretch: per tick, or per plan call.  Read for
`launches_per_tick.<cells>` and `launches_per_plan` too."""


def read(rec):
    t = rec.get("trace")
    if t is None or t.device_ops == 0:
        return None
    return t.device_ops / rec["traced_requests"]
