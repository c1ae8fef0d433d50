"""Export the trained contact-plant policy's actor parameters from the
JAX package's orbax checkpoint to the port's `.npz`.

`examples/artifacts/ckpt_physics_6000/step_6000` holds the parameters
after 6000 PPO iterations on the contact-plant env
(`examples/train_and_deploy_highlevel.py --physics`).  This script
restores it as numpy on the CPU (its arrays were saved with a TPU
sharding, so the restore asks for numpy arrays explicitly) and writes
the actor's flax tree, float32, to
`alore_legged_manipulator_tpu_torch/models/weights/highlevel_physics_6000.npz`
(keys: '/'-joined flax paths), which the port reads without JAX:

    JAX_PLATFORMS=cpu python tests/export_highlevel_weights.py
"""
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "examples" / "artifacts" / "ckpt_physics_6000" / "step_6000"


def restore_params(path=CKPT):
    """{'actor': ..., 'critic': ...} flax trees with numpy leaves."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    ck = ocp.PyTreeCheckpointer()
    meta = ck.metadata(os.fspath(path))
    tree = meta.item_metadata.tree if hasattr(meta, "item_metadata") \
        else meta
    args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray),
                        tree)
    return ck.restore(os.fspath(path),
                      args=ocp.args.PyTreeRestore(restore_args=args))


def main():
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        HIGHLEVEL_PHYSICS_6000, save_flax_npz)

    params = restore_params()
    save_flax_npz(HIGHLEVEL_PHYSICS_6000, params["actor"])
    print("->", HIGHLEVEL_PHYSICS_6000,
          os.path.getsize(HIGHLEVEL_PHYSICS_6000), "bytes")


if __name__ == "__main__":
    main()
