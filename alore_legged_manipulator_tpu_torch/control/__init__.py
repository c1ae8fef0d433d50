from .nmpc import NmpcConfig, NmpcCarry, nmpc_init, nmpc_rti_step  # noqa: F401
from .tracked_traj import TrackedTraj, build_tracked_traj, ref_points  # noqa: F401
