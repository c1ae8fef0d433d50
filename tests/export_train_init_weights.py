"""Export the JAX package's seed-0 initial training parameters to the
port's `.npz`.

`examples/artifacts/train_physics_6000.csv` is the JAX package's
contact-plant training run from `rl/runner.py::init_models(TrainConfig(
physics_env=True))` (seed 0).  This script builds those parameters on
the CPU and writes the `{"actor", "critic"}` flax tree, float32, to
`alore_legged_manipulator_tpu_torch/models/weights/train_init_physics_seed0.npz`
(keys: '/'-joined flax paths), from which the port's trainer starts the
same run without JAX (`rl/runner.py::load_models`):

    JAX_PLATFORMS=cpu python tests/export_train_init_weights.py
"""
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_seed0_params():
    """{'actor': ..., 'critic': ...} flax trees with numpy leaves."""
    import jax
    import numpy as np
    from alore_legged_manipulator_tpu.rl.runner import (TrainConfig,
                                                        init_models)

    _, params = init_models(TrainConfig(physics_env=True))
    return jax.tree.map(np.asarray, params)


def main():
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        TRAIN_INIT_PHYSICS_SEED0, save_flax_npz)

    save_flax_npz(TRAIN_INIT_PHYSICS_SEED0, jax_seed0_params())
    print("->", TRAIN_INIT_PHYSICS_SEED0,
          os.path.getsize(TRAIN_INIT_PHYSICS_SEED0), "bytes")


if __name__ == "__main__":
    main()
