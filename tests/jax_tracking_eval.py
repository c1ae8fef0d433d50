"""The JAX package's fixed-command tracking eval of the trained
contact-plant policy (examples/train_and_deploy_highlevel.py:124-156
with `--physics --load-ckpt examples/artifacts/ckpt_physics_6000 --iters
6000`), on the CPU: 256 lanes from `jax.random.split(PRNGKey(123), 256)`,
128 at command (0.5, 0, 0) and 128 at (0.3, 0, 0.8), 100 steps, the mean
|realized - commanded| object velocity per axis over the last 50.

    JAX_PLATFORMS=cpu python tests/jax_tracking_eval.py

prints the three numbers; `chip_smoke.py` holds the port's eval on the
card to them (+0.05 per axis).
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def commands(n):
    import numpy as np
    h = n // 2
    return np.concatenate([np.tile([[0.5, 0.0, 0.0]], (h, 1)),
                           np.tile([[0.3, 0.0, 0.8]], (n - h, 1))]
                          ).astype(np.float32)


def jax_eval(actor_params, n=256, n_steps=100, settle=50, seed=123):
    """(err (3,), initial states) of the example's eval at `n` lanes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from alore_legged_manipulator_tpu.models.actor_critic import (
        PhysicActorCritic)
    from alore_legged_manipulator_tpu.models.gnn import (
        build_interaction_graph)
    from alore_legged_manipulator_tpu.rl import env_physics as ep
    from alore_legged_manipulator_tpu.rl.env import graph_features

    pcfg = ep.PhysicsEnvConfig()
    actor = PhysicActorCritic()
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    states = jax.vmap(lambda k: ep.env_reset(k, pcfg))(keys)
    cmds = jnp.asarray(commands(n))
    states = states._replace(cmd=cmds)

    @jax.jit
    def rollout(states):
        def step(states, _):
            views = jax.vmap(ep.as_surrogate_view)(states)
            graphs = jax.vmap(
                lambda s: build_interaction_graph(*graph_features(s)))(views)
            mean, _, _ = actor.apply(actor_params, views.obs_hist, graphs)
            states = jax.vmap(lambda s, a: ep.env_step(s, a, pcfg)[0])(
                states, mean)
            return states, jax.vmap(ep.as_surrogate_view)(states).obj_vel
        _, vels = jax.lax.scan(step, states, None, length=n_steps)
        return jnp.abs(vels[settle:] - cmds[None]).mean(axis=(0, 1))

    return np.asarray(rollout(states)), states


def main():
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tests.export_highlevel_weights import restore_params

    err, _ = jax_eval(restore_params()["actor"])
    print("steady-state |vel err| per axis: vx %.6f vy %.6f wz %.6f"
          % tuple(err))


if __name__ == "__main__":
    main()
