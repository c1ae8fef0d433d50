"""Mean over every plan of the window of the stage-2 L-BFGS iterations
(`BackendResult.stage2_iters`: the last collision attempt's, over its
ALM outer loops)."""


def read(rec):
    return rec.get("stage2_iters")
