from .flat_traj import FlatTraj  # noqa: F401
from .backend import (BackendConfig, BackendWeights, PathWeights,  # noqa: F401
                      AlmConfig, plan_backend, stage2_cost, stage1_cost,
                      virtual_to_real_time, real_to_virtual_time)
