"""Export a trained contact-plant policy's actor parameters from the JAX
package's orbax checkpoint to the port's `.npz`.

`examples/artifacts/ckpt_physics_<step>/step_<step>` holds the
parameters after `step` PPO iterations on the contact-plant env
(`examples/train_and_deploy_highlevel.py --physics`; the artifacts are
at 6000 and 1500).  This script restores one as numpy on the CPU (its
arrays were saved with a TPU sharding, so the restore asks for numpy
arrays explicitly) and writes the actor's flax tree, float32, to
`alore_legged_manipulator_tpu_torch/models/weights/highlevel_physics_<step>.npz`
(keys: '/'-joined flax paths), which the port reads without JAX:

    JAX_PLATFORMS=cpu python tests/export_highlevel_weights.py [--step 1500]
"""
import argparse
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARTIFACTS = ROOT / "examples" / "artifacts"
CKPT = ARTIFACTS / "ckpt_physics_6000" / "step_6000"


def checkpoint_path(step: int) -> pathlib.Path:
    """The orbax checkpoint of the JAX example's run after `step`
    iterations."""
    return ARTIFACTS / f"ckpt_physics_{step}" / f"step_{step}"


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--step", type=int, default=6000, choices=(6000, 1500))
    step = ap.parse_args(argv).step
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from alore_legged_manipulator_tpu_torch.models.torch_convert import (
        HIGHLEVEL_PHYSICS, save_flax_npz)

    out = HIGHLEVEL_PHYSICS[step]
    params = restore_params(checkpoint_path(step))
    save_flax_npz(out, params["actor"])
    print("->", out, os.path.getsize(out), "bytes")


if __name__ == "__main__":
    main()
