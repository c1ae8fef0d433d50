from .poly import PolyTraj, eval_piece, eval_traj  # noqa: F401
from .dynamics import icr_dynamics, wheel_speeds_from_flat, body_vel_from_wheels  # noqa: F401
from .flow import simpson_flow_positions, flow_velocity  # noqa: F401
from .smoothing import positive_smoothed_l1  # noqa: F401
