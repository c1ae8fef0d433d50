"""The high-level pushing policy and the frozen low-level WBC, as
`torch.nn` modules (port of `models/`)."""
from .nets import MLP  # noqa: F401
from .gnn import InteractiveGNN, build_interaction_graph, GraphBatch  # noqa: F401
from .estimator import PhysicEstimator  # noqa: F401
from .actor_critic import PhysicActorCritic, Critic  # noqa: F401
from .low_level import StateHistoryEncoder, ActorCriticLow  # noqa: F401
