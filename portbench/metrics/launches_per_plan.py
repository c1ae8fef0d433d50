"""Device operations launched per plan call of the traced stretch."""
from portbench.metrics.launches_per_tick import read  # noqa: F401
