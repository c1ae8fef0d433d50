"""The push environments, their training and the served policy's
evaluation (port of `rl/`): `obs_layout`, `env` (surrogate),
`env_physics` (contact plant), `hierarchy` (frozen low-level WBC in the
loop), `ppo`, `runner` (the training loop), `registry` (task ids) and
`eval`.  Every state carries a leading lane axis where the JAX package
vmaps one env."""
from .env import PushEnvConfig, PushEnvState, env_reset, env_step  # noqa: F401
from .ppo import PpoConfig, PpoState, ppo_init, ppo_update  # noqa: F401
from .runner import train as ppo_train  # noqa: F401
