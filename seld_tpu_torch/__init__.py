"""seld_tpu_torch — the SELD-TCN serving path in PyTorch with hand-written
Hopper kernels.

A port of ``seld_tpu`` (JAX/Flax/Pallas on a TPU, kept as the reference) to
PyTorch and CUDA for an NVIDIA H100. It imports no JAX; from the JAX package
it takes only the JAX-free config parser ``seld_tpu.config``. Layout mirrors
``seld_tpu``:

- ``ops``              — Hamilton assembly, quaternion / dual-quaternion ops, inits
- ``ops.kernels``      — the CUDA kernels (``csrc/*.cu``) with their plain versions
- ``models``           — eval-mode SELDModel and its blocks; ``fused_infer`` serving
- ``utils.jax_bridge`` — JAX variables tree -> port state_dict
- ``serve``            — flagship serving entry: audio -> (sed, doa)

Parameters keep the JAX package's names and layouts, so weights move between
the two packages by a tree walk.
"""

import torch

__version__ = "0.1.0"


def disable_tf32() -> None:
    """Run float32 matmuls and convolutions in full float32 on the GPU (the
    counterpart of the JAX package's 'highest' precision pin); cuDNN's
    default is TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
