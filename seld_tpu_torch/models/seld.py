"""The SELD model: one or two ConvTC trunks + SED/DOA heads.

Counterpart of ``seld_tpu/models/seld.py`` and of
``seld_tpu/models/__init__.py::model_from_config``. Takes the reference
layout (B, C, F, T) and returns ``(sed (B, T_out, classes * overlaps), doa
(B, T_out, 3 * classes * overlaps))``. Domains R / Q / DQ and a separately
typed classifier (``domain_classifier``) are supported, and so are the
topologies of the JAX package: one trunk (``seld_block``), or, under the
2Parallel spellings of ``parallel_ConvTC_block`` (``PARALLEL_2``), two
(``branch_A`` and ``branch_B``) on the two halves of the channels or, with
``parallel_magphase``, on each microphone's magnitude + phase channels, their
outputs concatenated on the feature axis before the heads; and the SE block
after every CNN stage (``use_se_block``, ``models/blocks.py``).

``forward(x, train=False, generator=None)`` computes in the input's dtype.
In eval mode with ``qconv_impl='xla'`` it is the unfused oracle of the fused
serving path (``models/fused_infer.py``): plain torch ops and no kernel;
``'pallas'`` and ``'int8'`` put the pointwise convs and the FC heads on K7 or
K8 (the predict CLI's ``apply`` path, ``seld_tpu_torch/predict.py``). In
train mode
(``training/steps.py``) BN uses batch statistics, the dropouts draw from
``generator``, and the kernels of the training path run where their
conditions hold (K5 in CNN stage 0, K4 + K6 in the attention), in each trunk.
``compute_dtype`` is the dtype the serving path and the train step run in.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from seld_tpu_torch.models.blocks import ConvTCBlock, receptive_field
from seld_tpu_torch.models.layers import Dense, Dropout, make_linear

PARALLEL_2 = {"2Parallel", "2BParallel", "2ParallelBranches", "2PB"}
_Q_NAMES = {"q", "Q", "quaternion", "Quaternion"}
_DQ_NAMES = {"dq", "dQ", "DQ", "dual_quaternion", "Dual_Quaternion"}
_OFF = {"False", "false", "None", "none"}
_RELU = {"relu", "ReLU", "RELU"}
_FC_DROPOUT_ALL = {"all", "ALL", "True"}
_FC_DROPOUT_LAST = {"last", "Last", "LAST"}


def synthesize_model_name(domain: str, dilation_mode: str, D: Sequence,
                          parallel_ConvTC_block: str, batch_norm: str, pool_time: str, rf: int,
                          n_resblocks: int, extra_name: str = "") -> str:
    """The model name of ``seld_tpu/models/seld.py::synthesize_model_name``
    (reference model.py:347-372): it names the trainer's result directories,
    so it must match exactly."""
    name = "Q" if domain in _Q_NAMES else ("DualQ" if domain in _DQ_NAMES else "")
    name += "SELD-TCN"
    if dilation_mode == "fibonacci":
        name += "-PHI"
    name += "-"
    if len(D) > 1 and D[0] < D[1]:
        name += "I"
    name += f"S{len(D)}"
    if parallel_ConvTC_block not in _OFF:
        name += "_" + parallel_ConvTC_block
    name += "_" + batch_norm
    if pool_time == "CNN":
        name += "_pooltCNN"
    name += f"_RF{rf}_{n_resblocks}RB"
    return name + extra_name


class SELDModel(nn.Module):
    def __init__(self, *, freq_dim: int = 256, input_channels: int = 4,
                 output_classes: int = 14, domain: str = "DQ", domain_classifier: str = "same",
                 cnn_filters: Sequence[int] = (64, 64, 64), kernel_size_cnn_blocks: int = 3,
                 pool_size=((8, 2), (8, 2), (2, 2)), pool_time: str = "TCN", D=(10,),
                 dilation_mode: str = "fibonacci", G: int = 128, U: int = 128,
                 kernel_size_dilated_conv: int = 3, V: Sequence[int] = (128, 128),
                 V_kernel_size: int = 3, fc_layers: Sequence[int] = (128,),
                 fc_activations: str = "Linear", fc_dropout: str = "all",
                 dropout_perc: float = 0.3, spatial_dropout_rate: float = 0.5,
                 class_overlaps: float = 3.0,
                 use_bias_conv: bool = False, use_bias_linear: bool = True,
                 batch_norm: str = "BN", parallel_ConvTC_block: str = "False",
                 parallel_magphase: bool = False, use_se_block: bool = False,
                 attention_impl: str = "auto", compute_dtype: str = "float32",
                 frontend_impl: str = "auto", qconv_impl: str = "xla", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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
        self.fc_dropout = fc_dropout
        self.dropout = Dropout(dropout_perc)
        self.use_bias_conv, self.use_bias_linear = use_bias_conv, use_bias_linear
        self.batch_norm, self.attention_impl = batch_norm, attention_impl
        self.parallel_ConvTC_block = parallel_ConvTC_block
        self.parallel = parallel_ConvTC_block in PARALLEL_2
        self.parallel_magphase, self.use_se_block = parallel_magphase, use_se_block
        self.compute_dtype, self.qconv_impl = compute_dtype, qconv_impl

        self.trunk_names = ("branch_A", "branch_B") if self.parallel else ("seld_block",)
        probe = torch.empty(1, input_channels, 0)
        for name, part in zip(self.trunk_names, self.split_channels(probe)):
            setattr(self, name, ConvTCBlock(
                domain, part.shape[1], freq_dim, cnn_filters, kernel_size_cnn_blocks,
                self.pool_size, pool_time, D, dilation_mode, G, U, kernel_size_dilated_conv,
                V, V_kernel_size, use_bias_conv, batch_norm, attention_impl,
                spatial_dropout_rate, dropout_perc, frontend_impl, use_se_block,
                qconv_impl=qconv_impl, device=device, generator=generator))
        sed_out = int(output_classes * class_overlaps)
        kw = dict(device=device, generator=generator)
        for prefix, out_size in (("sed", sed_out), ("doa", 3 * sed_out)):
            width = self.V[-1] * len(self.trunk_names)
            for li, fc in enumerate(self.fc_layers):
                setattr(self, f"{prefix}_fc{li}", make_linear(
                    self.classifier_domain, width, fc, use_bias_linear, impl=qconv_impl, **kw))
                width = fc
            setattr(self, f"{prefix}_out", Dense(width, out_size, use_bias_linear, **kw))

    @property
    def trunks(self) -> list:
        """The ConvTCBlock of each trunk, in the order of :meth:`split_channels`."""
        return [getattr(self, name) for name in self.trunk_names]

    def split_channels(self, x: torch.Tensor) -> tuple:
        """x (B, C, ...) -> one input per trunk, split on axis 1 as
        ``seld_tpu/models/seld.py:132-142`` splits the channel axis: the whole
        of x for one trunk; under 2Parallel the two halves, or with
        ``parallel_magphase`` microphone A's magnitude + phase channels [0:4]
        + [8:12] and microphone B's [4:8] + [12:]."""
        if not self.parallel:
            return (x,)
        if self.parallel_magphase:
            return (torch.cat([x[:, 0:4], x[:, 8:12]], 1), torch.cat([x[:, 4:8], x[:, 12:]], 1))
        half = self.input_channels // 2
        return x[:, :half], x[:, half:]

    @property
    def classifier_domain(self) -> str:
        return self.domain if self.domain_classifier == "same" else self.domain_classifier

    def receptive_field(self):
        return receptive_field(self.D, self.kernel_size_dilated_conv, self.dilation_mode)

    @property
    def model_name(self) -> str:
        rf, n_rb = self.receptive_field()
        return synthesize_model_name(self.domain, self.dilation_mode, self.D,
                                     self.parallel_ConvTC_block, self.batch_norm,
                                     self.pool_time, rf, n_rb)

    def head(self, h: torch.Tensor, prefix: str, train: bool = False,
             generator: Optional[torch.Generator] = None,
             qconv_impl: Optional[str] = None, cross_rank=None) -> torch.Tensor:
        """FC stack and output layer of one head, before its activation; in
        train mode dropout after every FC layer (``fc_dropout`` 'all') or
        after the stack ('last'). ``qconv_impl`` overrides the FC layers'
        (``fused_infer`` runs them plain, as the JAX package's does)."""
        y = h
        for li in range(len(self.fc_layers)):
            y = getattr(self, f"{prefix}_fc{li}")(y, impl=qconv_impl)
            if self.fc_activations in _RELU:
                y = torch.relu(y)
            if self.fc_dropout in _FC_DROPOUT_ALL:
                y = self.dropout(y, train, generator, cross_rank)
        if self.fc_dropout in _FC_DROPOUT_LAST:
            y = self.dropout(y, train, generator, cross_rank)
        return getattr(self, f"{prefix}_out")(y)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None,
                cross_rank=None):
        """x (B, C, F, T) -> (sed, doa) in x's dtype promoted to >= float32.
        ``cross_rank`` (train mode under data parallelism,
        ``parallel/cross_rank.py``): x is this rank's rows of a global batch,
        and every batch statistic and dropout mask is the global batch's."""
        h = torch.cat([trunk(part.permute(0, 2, 3, 1), train, generator, cross_rank)
                       for trunk, part in zip(self.trunks, self.split_channels(x))], dim=-1)
        dt = torch.promote_types(h.dtype, torch.float32)
        sed = torch.sigmoid(self.head(h, "sed", train, generator,
                                      cross_rank=cross_rank).to(dt))
        doa = torch.tanh(self.head(h, "doa", train, generator, cross_rank=cross_rank).to(dt))
        return sed, doa


_ATTENTION_IMPLS = {"full": "full", "chunked": "chunked", "pallas": "flash", "flash": "flash"}


def _frontend_impl(name: str) -> str:
    """The config's ``frontend_impl`` in the port's terms: 'pallas-ct' and
    'pallas-ct-interpret' ask for the K5 + K9 chain ('ct'); 'pallas',
    'pallas-thin' and 'pallas-interpret*' for the K5 op ('fused')."""
    if name in ("pallas-ct", "pallas-ct-interpret"):
        return "ct"
    if name.startswith("pallas"):
        return "fused"
    return name


def model_from_config(cfg, *, device=None,
                      generator: Optional[torch.Generator] = None) -> SELDModel:
    """SELDModel from a ``seld_tpu_torch.config.SELDConfig``. The JAX knobs
    map as: attention_impl 'pallas' -> 'flash', other values but 'full' /
    'chunked' -> 'auto'; frontend_impl as :func:`_frontend_impl` says;
    qconv_impl 'pallas' (K7) and 'int8' (K8) as they are, anything else 'xla'
    (``seld_tpu/models/__init__.py::model_from_config``)."""
    return SELDModel(
        freq_dim=cfg.freq_dim, input_channels=cfg.input_channels,
        output_classes=cfg.output_classes, domain=cfg.domain,
        domain_classifier=cfg.domain_classifier, cnn_filters=tuple(cfg.cnn_filters),
        kernel_size_cnn_blocks=cfg.kernel_size_cnn_blocks,
        pool_size=tuple(tuple(p) for p in cfg.pool_size), pool_time=cfg.pool_time,
        D=tuple(cfg.D), dilation_mode=cfg.dilation_mode, G=cfg.G, U=cfg.U,
        kernel_size_dilated_conv=cfg.kernel_size_dilated_conv, V=tuple(cfg.V),
        V_kernel_size=cfg.V_kernel_size, fc_layers=tuple(cfg.fc_layers),
        fc_activations=cfg.fc_activations, fc_dropout=cfg.fc_dropout,
        dropout_perc=cfg.dropout_perc, spatial_dropout_rate=cfg.spatial_dropout_rate,
        class_overlaps=cfg.class_overlaps,
        use_bias_conv=cfg.use_bias_conv, use_bias_linear=cfg.use_bias_linear,
        batch_norm=cfg.batch_norm, parallel_ConvTC_block=cfg.parallel_ConvTC_block,
        parallel_magphase=cfg.parallel_magphase, use_se_block=cfg.use_se_block,
        attention_impl=_ATTENTION_IMPLS.get(cfg.attention_impl, "auto"),
        compute_dtype=cfg.compute_dtype, frontend_impl=_frontend_impl(cfg.frontend_impl),
        qconv_impl=cfg.qconv_impl if cfg.qconv_impl in ("pallas", "int8") else "xla",
        device=device, generator=generator,
    )
