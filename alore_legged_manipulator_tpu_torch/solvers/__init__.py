from .minco import MincoProblem, minco_coeffs, minco_energy, minco_traj  # noqa: F401
from .lbfgs import LbfgsParams, lbfgs_minimize  # noqa: F401
