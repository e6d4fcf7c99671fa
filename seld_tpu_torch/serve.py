"""Flagship serving entry: raw audio -> STFT-magnitude kernel -> fused forward.

Counterpart of ``bench.py``'s fused serving pipeline and of
``__graft_entry__.py::_flagship_model``: the DualQSELD-TCN of
``config/DQSELD-TCN-S1-PHI_8ch.txt`` on 8-channel 32 kHz audio, featurized
with nperseg 512 / hop 400 (256 bins, 4800 frames per 60 s clip).

    gen = torch.Generator().manual_seed(0)
    model = build_flagship("config/DQSELD-TCN-S1-PHI_8ch.txt", torch.bfloat16, "cuda", gen)
    sed, doa = serve(model, audio)   # audio (B, 8, n) float32 -> (B, 600, 42), (B, 600, 126)

On a CUDA device every kernel of the path launches (K1 here, K2-K4 inside
``fused_infer``); on the CPU each kernel's plain version runs instead.
"""

from __future__ import annotations

import torch

from seld_tpu_torch import disable_tf32
from seld_tpu_torch.models.layers import BatchNorm
from seld_tpu_torch.models.seld import SELDModel, model_from_config
from seld_tpu_torch.models.fused_infer import fused_infer
from seld_tpu_torch.ops.kernels.stft import stft_mag

NPERSEG, NOVERLAP = 512, 112
BN_PERTURBATION = 0.1
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def perturb_bn(model: SELDModel, generator: torch.Generator) -> None:
    """Move every BatchNorm off the identity, so that BN folding changes the
    weights as trained statistics would: with a = BN_PERTURBATION, running
    mean ~ N(0, a^2), running var ~ U(1 - a, 1 + a), scale ~ 1 + N(0, a^2),
    bias ~ N(0, a^2), drawn from ``generator``."""
    amount = BN_PERTURBATION
    with torch.no_grad():
        for bn in model.modules():
            if not isinstance(bn, BatchNorm):
                continue
            n = bn.mean.numel()

            def draw(uniform=False):
                t = (torch.rand(n, generator=generator, device=generator.device) * 2 - 1
                     if uniform else
                     torch.randn(n, generator=generator, device=generator.device))
                return (amount * t).to(bn.mean.device)

            bn.mean.copy_(draw())
            bn.var.copy_(1.0 + draw(uniform=True))
            bn.scale.copy_(1.0 + draw())
            bn.bias.copy_(draw())


def build_flagship(cfg_path, dtype: torch.dtype, device,
                   generator: torch.Generator) -> SELDModel:
    """The model of ``cfg_path`` (the flagship's is
    config/DQSELD-TCN-S1-PHI_8ch.txt) at full width, with random weights
    drawn from ``generator`` (a CPU generator) and perturbed BN statistics;
    serving runs in ``dtype`` (float32 or bfloat16). Turns TF32 off, so that
    float32 serving computes in full float32 (``disable_tf32``)."""
    from seld_tpu.config import load_config   # JAX-free: the config parser only

    if dtype not in _DTYPE_NAMES:
        raise ValueError(f"dtype {dtype} not in {list(_DTYPE_NAMES)}")
    cfg = load_config(str(cfg_path)).replace(compute_dtype=_DTYPE_NAMES[dtype])
    model = model_from_config(cfg, device=device, generator=generator)
    perturb_bn(model, generator)
    disable_tf32()
    return model.eval()


def serve(model: SELDModel, audio: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """audio (B, C, n) -> (sed (B, T', classes * overlaps), doa (B, T', 3 * ...)).

    The grouped (B, C, G, 3200) form of the audio is only a reshape of the
    flat one: pass ``audio.reshape(B, C, -1)``."""
    if audio.ndim != 3:
        raise ValueError(f"audio must be (B, C, n), got {tuple(audio.shape)}")
    out_dtype = torch.bfloat16 if model.compute_dtype == "bfloat16" else torch.float32
    featurize = lambda a: stft_mag(a.contiguous(), NPERSEG, NOVERLAP, out_dtype=out_dtype)
    return fused_infer(model, audio, input_layout="BCTF", featurize=featurize)
