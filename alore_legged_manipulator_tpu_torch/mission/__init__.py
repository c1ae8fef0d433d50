from .ordering import (greedy_order, branch_and_bound_order,  # noqa: F401
                       hungarian, pairwise_path_costs)
