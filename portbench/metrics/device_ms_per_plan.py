"""Device-busy time per plan call of the traced stretch, in ms."""
from portbench.metrics.device_ms_per_tick import read  # noqa: F401
