from .closed_loop import (LoopConfig, simulate_tracking,  # noqa: F401
                          TrackingResult)
