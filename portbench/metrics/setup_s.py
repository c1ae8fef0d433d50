"""Seconds from the process's start to the first timed request: imports,
the card, building the cell's inputs and state, warm-up."""


def read(rec):
    return rec["setup_s"]
