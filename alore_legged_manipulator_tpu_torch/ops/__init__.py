from .esdf import esdf_from_occupancy, sample_dist_grad_bilinear  # noqa: F401
from .qp import (box_qp_admm, box_qp_projected_newton,  # noqa: F401
                 box_qp_pncg, box_qp_kkt_residual,
                 qp_admm_general)
