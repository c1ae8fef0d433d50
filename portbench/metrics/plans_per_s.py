"""Requests completed over the whole window, each ended by its result on
the host: plans, or lane-ticks for `scenario_ticks_per_s` (a fleet call
completes one a lane)."""


def read(rec):
    return rec["lanes"] * rec["requests"] / rec["elapsed_s"]
