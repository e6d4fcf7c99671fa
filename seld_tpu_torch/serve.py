"""Serving entry: raw audio -> features -> fused forward.

Counterpart of ``bench.py``'s fused serving pipeline, of
``__graft_entry__.py::_flagship_model`` and of the root ``predict.py``'s
fused route: a model of any shipped config (the flagship is the
DualQSELD-TCN of ``config/DQSELD-TCN-S1-PHI_8ch.txt``) on 8-channel 32 kHz
audio, featurized with nperseg 512 / hop 400 (256 bins, 4800 frames per 60 s
clip).

    gen = torch.Generator().manual_seed(0)
    model = build_flagship("config/DQSELD-TCN-S1-PHI_8ch.txt", torch.bfloat16, "cuda", gen)
    sed, doa = serve(model, audio)   # audio (B, 8, n) float32 -> (B, 600, 42), (B, 600, 126)

    model = build_flagship("config/DQSELD-TCN-S1-PHI_micAMagPhaseParallelmicBMagPhase.txt",
                           torch.bfloat16, "cuda", gen)
    sed, doa = serve(model, audio, phase=True)   # 16 feature channels, two trunks

Magnitude configs featurize with K1 (the STFT-magnitude kernel); magnitude +
phase configs (``phase=True``) with ``data/features.py::spectrum_fast_batch``
in float32, plain torch, as the JAX package does: its fused route keeps its
Pallas STFT for magnitude-only configs and featurizes phase configs with
XLA's ``spectrum_fast`` (root ``predict.py:112-124``), so the phase
featurizer has no TPU kernel to port. On a CUDA device every kernel of the
path launches (K1 for magnitude configs; K2, or K2w with
``smallcin_impl='wide'``, K3 and K4 inside ``fused_infer``, per trunk); on
the CPU each kernel's plain version runs instead.
"""

from __future__ import annotations

import torch

from seld_tpu_torch import disable_tf32
from seld_tpu_torch.config import load_config
from seld_tpu_torch.data.features import spectrum_fast_batch
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
                   generator: torch.Generator, **overrides) -> SELDModel:
    """The model of any config at ``cfg_path`` (the flagship's is
    config/DQSELD-TCN-S1-PHI_8ch.txt; the phase configs and 2Parallel trunks
    build alike) at full width, with random weights
    drawn from ``generator`` (a CPU generator) and perturbed BN statistics;
    serving runs in ``dtype`` (float32 or bfloat16). ``overrides`` replace
    config keys (e.g. ``use_se_block=True``, ``frontend_impl='pallas-ct'``).
    Turns TF32 off, so that float32 serving computes in full float32
    (``disable_tf32``)."""
    if dtype not in _DTYPE_NAMES:
        raise ValueError(f"dtype {dtype} not in {list(_DTYPE_NAMES)}")
    cfg = load_config(str(cfg_path)).replace(compute_dtype=_DTYPE_NAMES[dtype], **overrides)
    model = model_from_config(cfg, device=device, generator=generator)
    perturb_bn(model, generator)
    disable_tf32()
    return model.eval()


def serve(model: SELDModel, audio: torch.Tensor, smallcin_impl: str = "thin",
          phase: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """audio (B, C, n) -> (sed (B, T', classes * overlaps), doa (B, T', 3 * ...)).

    The grouped (B, C, G, 3200) form of the audio is only a reshape of the
    flat one: pass ``audio.reshape(B, C, -1)``. ``smallcin_impl`` goes to
    :func:`fused_infer`: 'thin' runs stage 1 on K2, 'wide' on K2w (``bench.py
    --smallcin wide``). Without ``phase`` K1 featurizes the magnitude in the
    model's compute dtype; with it (a config's ``--phase``)
    ``spectrum_fast_batch`` featurizes magnitude + phase in float32, and
    ``fused_infer`` casts the features to the compute dtype. Raises where the
    featurized channels are not ``model.input_channels``."""
    if audio.ndim != 3:
        raise ValueError(f"audio must be (B, C, n), got {tuple(audio.shape)}")
    channels = audio.shape[1] * (2 if phase else 1)
    if channels != model.input_channels:
        raise ValueError(f"{audio.shape[1]}-channel audio{' with phase' if phase else ''} gives "
                         f"{channels} feature channels; the model takes {model.input_channels}")
    if phase:
        featurize = lambda a: spectrum_fast_batch(a, nperseg=NPERSEG, noverlap=NOVERLAP,
                                                  output_phase=True, return_layout="CTF")
    else:
        out_dtype = torch.bfloat16 if model.compute_dtype == "bfloat16" else torch.float32
        featurize = lambda a: stft_mag(a.contiguous(), NPERSEG, NOVERLAP, out_dtype=out_dtype)
    return fused_infer(model, audio, input_layout="BCTF", featurize=featurize,
                       smallcin_impl=smallcin_impl)
