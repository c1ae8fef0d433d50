"""Lane-ticks completed over the whole window, the card's work included."""
from portbench.metrics.plans_per_s import read  # noqa: F401
