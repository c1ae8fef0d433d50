"""Scenario-fleet data parallelism on `torch.distributed` (port of
`parallel/`): the mesh and its collectives (`mesh`), the scaling harness
(`scaling`) and the multi-device dry run (`dryrun`)."""
from .mesh import (Mesh, batched_tracking_step, fleet_reduce,  # noqa: F401
                   gather_scenarios, make_mesh, shard_scenarios)
