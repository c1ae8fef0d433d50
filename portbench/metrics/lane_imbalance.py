"""The lanes' imbalance of a fleet's plan calls: each call's most stage-2
L-BFGS iterations of a lane over the lanes' mean, averaged over the
calls that the rate counts (counter `lane_imbalance` of
`drivers/replan.py`; 1 where every lane works alike).  The slowest lane
sets a call's time, so this is what lane compaction would move."""


def read(rec):
    return rec.get("lane_imbalance")
