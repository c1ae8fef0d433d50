"""95th percentile of every tick of the window, each timed on the host
from its call until its command is on the host, in ms."""
import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec["latencies_s"]), 95) * 1e3)
