"""The SELD model, eval mode: single trunk + SED/DOA heads.

Counterpart of ``seld_tpu/models/seld.py`` and of
``seld_tpu/models/__init__.py::model_from_config``. Takes the reference
layout (B, C, F, T) and returns ``(sed (B, T_out, classes * overlaps), doa
(B, T_out, 3 * classes * overlaps))``. Domains R / Q / DQ and a separately
typed classifier (``domain_classifier``) are supported; the 2Parallel /
``parallel_magphase`` topologies and the SE block are not ported yet and
raise.

``forward`` is the unfused oracle: it computes in the input's dtype with
plain torch ops and no kernel. ``compute_dtype`` is the dtype the fused
serving path (``models/fused_infer.py``) runs in.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from seld_tpu_torch.models.blocks import ConvTCBlock, receptive_field
from seld_tpu_torch.models.layers import Dense, make_linear

PARALLEL_2 = {"2Parallel", "2BParallel", "2ParallelBranches", "2PB"}
_RELU = {"relu", "ReLU", "RELU"}


class SELDModel(nn.Module):
    def __init__(self, *, freq_dim: int = 256, input_channels: int = 4,
                 output_classes: int = 14, domain: str = "DQ", domain_classifier: str = "same",
                 cnn_filters: Sequence[int] = (64, 64, 64), kernel_size_cnn_blocks: int = 3,
                 pool_size=((8, 2), (8, 2), (2, 2)), pool_time: str = "TCN", D=(10,),
                 dilation_mode: str = "fibonacci", G: int = 128, U: int = 128,
                 kernel_size_dilated_conv: int = 3, V: Sequence[int] = (128, 128),
                 V_kernel_size: int = 3, fc_layers: Sequence[int] = (128,),
                 fc_activations: str = "Linear", class_overlaps: float = 3.0,
                 use_bias_conv: bool = False, use_bias_linear: bool = True,
                 batch_norm: str = "BN", parallel_ConvTC_block: str = "False",
                 parallel_magphase: bool = False, use_se_block: bool = False,
                 attention_impl: str = "auto", compute_dtype: str = "float32",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if parallel_ConvTC_block in PARALLEL_2:
            raise NotImplementedError("2Parallel / parallel_magphase trunks are not ported yet")
        if use_se_block:
            raise NotImplementedError("the SE block is not ported yet")
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        self.freq_dim, self.input_channels = freq_dim, input_channels
        self.output_classes, self.class_overlaps = output_classes, class_overlaps
        self.domain, self.domain_classifier = domain, domain_classifier
        self.cnn_filters, self.kernel_size_cnn_blocks = tuple(cnn_filters), kernel_size_cnn_blocks
        self.pool_size = tuple(tuple(int(v) for v in p) for p in pool_size)
        self.pool_time, self.D, self.dilation_mode = pool_time, tuple(D), dilation_mode
        self.G, self.U, self.V = G, U, tuple(V)
        self.kernel_size_dilated_conv, self.V_kernel_size = kernel_size_dilated_conv, V_kernel_size
        self.fc_layers, self.fc_activations = tuple(fc_layers), fc_activations
        self.use_bias_conv, self.use_bias_linear = use_bias_conv, use_bias_linear
        self.batch_norm, self.attention_impl = batch_norm, attention_impl
        self.compute_dtype = compute_dtype

        self.seld_block = ConvTCBlock(
            domain, input_channels, freq_dim, cnn_filters, kernel_size_cnn_blocks,
            self.pool_size, pool_time, D, dilation_mode, G, U, kernel_size_dilated_conv, V,
            V_kernel_size, use_bias_conv, batch_norm, attention_impl,
            device=device, generator=generator)
        sed_out = int(output_classes * class_overlaps)
        kw = dict(device=device, generator=generator)
        for prefix, out_size in (("sed", sed_out), ("doa", 3 * sed_out)):
            width = self.V[-1]
            for li, fc in enumerate(self.fc_layers):
                setattr(self, f"{prefix}_fc{li}", make_linear(
                    self.classifier_domain, width, fc, use_bias_linear, **kw))
                width = fc
            setattr(self, f"{prefix}_out", Dense(width, out_size, use_bias_linear, **kw))

    @property
    def classifier_domain(self) -> str:
        return self.domain if self.domain_classifier == "same" else self.domain_classifier

    def receptive_field(self):
        return receptive_field(self.D, self.kernel_size_dilated_conv, self.dilation_mode)

    def head(self, h: torch.Tensor, prefix: str) -> torch.Tensor:
        """FC stack and output layer of one head, before its activation."""
        y = h
        for li in range(len(self.fc_layers)):
            y = getattr(self, f"{prefix}_fc{li}")(y)
            if self.fc_activations in _RELU:
                y = torch.relu(y)
        return getattr(self, f"{prefix}_out")(y)

    def forward(self, x):
        """x (B, C, F, T) -> (sed, doa), eval mode, in x's dtype (>= float32)."""
        h = self.seld_block(x.permute(0, 2, 3, 1))
        dt = torch.promote_types(h.dtype, torch.float32)
        sed = torch.sigmoid(self.head(h, "sed").to(dt))
        doa = torch.tanh(self.head(h, "doa").to(dt))
        return sed, doa


def model_from_config(cfg, *, device=None,
                      generator: Optional[torch.Generator] = None) -> SELDModel:
    """SELDModel from a ``seld_tpu.config.SELDConfig``."""
    return SELDModel(
        freq_dim=cfg.freq_dim, input_channels=cfg.input_channels,
        output_classes=cfg.output_classes, domain=cfg.domain,
        domain_classifier=cfg.domain_classifier, cnn_filters=tuple(cfg.cnn_filters),
        kernel_size_cnn_blocks=cfg.kernel_size_cnn_blocks,
        pool_size=tuple(tuple(p) for p in cfg.pool_size), pool_time=cfg.pool_time,
        D=tuple(cfg.D), dilation_mode=cfg.dilation_mode, G=cfg.G, U=cfg.U,
        kernel_size_dilated_conv=cfg.kernel_size_dilated_conv, V=tuple(cfg.V),
        V_kernel_size=cfg.V_kernel_size, fc_layers=tuple(cfg.fc_layers),
        fc_activations=cfg.fc_activations, class_overlaps=cfg.class_overlaps,
        use_bias_conv=cfg.use_bias_conv, use_bias_linear=cfg.use_bias_linear,
        batch_norm=cfg.batch_norm, parallel_ConvTC_block=cfg.parallel_ConvTC_block,
        parallel_magphase=cfg.parallel_magphase, use_se_block=cfg.use_se_block,
        attention_impl=cfg.attention_impl if cfg.attention_impl in ("full", "chunked") else "auto",
        compute_dtype=cfg.compute_dtype, device=device, generator=generator,
    )
