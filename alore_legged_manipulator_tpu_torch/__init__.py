"""PyTorch + CUDA port of the ALORE planning / control engine.

The JAX package `alore_legged_manipulator_tpu` is the reference; this
package mirrors its subpackages and module names so that each ported
function sits at its counterpart's path.  Tensors carry a leading batch
dimension where the JAX code used `vmap`.  The two TPU kernels of the
octile wavefront front end are hand-written CUDA C++ for Hopper
(`csrc/wavefront.cu`, bound in `ops/wavefront_cuda.py`), and so is the
NMPC feedback (`csrc/nmpc_feedback.cu`, bound in
`ops/nmpc_feedback_cuda.py`).

Importing the package needs neither `nvcc` nor a card: kernels are built
at first use.
"""

__version__ = "0.1.0"
