"""The push environments and the served policy's evaluation (port of
`rl/`): `obs_layout`, `env` (surrogate), `env_physics` (contact plant),
`hierarchy` (frozen low-level WBC in the loop) and `eval`.  Every state
carries a leading lane axis where the JAX package vmaps one env."""
