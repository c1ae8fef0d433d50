"""Share of the traced stretch's window in which no kernel, copy or set
ran on the card, in %: busy time and window from the same traced pass
(`portbench/trace.py`).  Read for `device_idle_pct.<cells>` too."""


def read(rec):
    t = rec.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
