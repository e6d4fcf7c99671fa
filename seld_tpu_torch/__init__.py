"""seld_tpu_torch — the SELD-TCN serving and training paths and the training
and inference entry points in PyTorch with hand-written Hopper kernels.

A port of ``seld_tpu`` (JAX/Flax/Pallas on a TPU, kept as the reference) to
PyTorch and CUDA for an NVIDIA H100. It imports neither JAX nor anything of
the JAX package (``tests/test_torch_isolation.py``). Layout mirrors
``seld_tpu``:

- ``config``           — the port's own copy of the text-config parser
- ``ops``              — Hamilton assembly, quaternion / dual-quaternion ops, inits
- ``ops.kernels``      — the CUDA kernels (``csrc/*.cu``) with their plain versions
- ``models``           — SELDModel and its blocks (eval and train mode);
  ``fused_infer`` serving
- ``training``         — loss, StepLR, train / eval / infer steps, checkpoints;
  ``training.trainer`` the epoch loop
- ``data``             — seeded synthetic Task-2 sets, the pickle and
  ``.seldpak`` loaders (``data.native``: the C++ reader), normalization
- ``parallel``         — data parallelism, one process a device: multihost,
  the data mesh, the cross-rank batch statistics, the per-rank-BN step
- ``metrics``          — the L3DAS21 and DCASE21 metrics and the decode
- ``utils``            — JAX variables tree <-> port state_dict, CSV rows,
  step timing, model summary
- ``serve``            — flagship serving entry: audio -> (sed, doa)
- ``train``            — the training CLI (``python -m seld_tpu_torch.train``)
- ``predict``          — the inference CLI (``python -m seld_tpu_torch.predict``)

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
