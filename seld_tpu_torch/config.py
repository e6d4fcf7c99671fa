"""Config system: typed dataclass + parser for the reference's text-config CLI.

The port's own copy of ``seld_tpu/config.py`` (``SELDConfig``,
``parse_text_args``, ``tokens_to_config``, ``load_config``): the port imports
nothing of the JAX package, so it keeps this module as its own. The same
``--key=value`` text files load unchanged, with the same reference quirks:

- ``readFile`` maps the literal tokens ``True -> '1'`` and ``False -> '0'``
  and drops empty tokens and any token containing '#'.
- list-valued flags (``pool_size``, ``cnn_filters``, ``D``, ``V``,
  ``fc_layers``) are parsed from Python-literal strings like
  ``[[8,2],[8,2],[2,2]]``.
- unknown keys (e.g. ``--phm_n`` in SERVER_QSELD-TCN-S1-PHI_parallel_8ch.txt)
  are tolerated with a warning.

The fields that name TPU knobs (``frontend_impl``, ``attention_impl``,
``use_remat``, ``frontend_bands``, ``mesh_*``) keep their names so that a
config file means the same in both packages; ``models/seld.py::
model_from_config`` says how the port reads them.
"""

from __future__ import annotations

import ast
import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, List, Optional

_TRUE_STRINGS = {"1", "True", "true"}
_FALSE_STRINGS = {"0", "False", "false"}


def parse_text_args(path: str) -> List[str]:
    """Tokenize a ``--key=value`` text config exactly like the reference.

    Mirrors ``readFile`` (reference ``utility_functions.py:77-91``): the file
    is split on ``=`` and newlines; ``True``/``False`` value tokens become
    ``'1'``/``'0'``; empty tokens and tokens containing ``#`` are dropped.
    """
    with open(path, "r") as f:
        raw = f.read()
    tokens = raw.replace("=", "+").replace("\n", "+").split("+")
    out: List[str] = []
    for tok in tokens:
        if tok == "True":
            out.append("1")
        elif tok == "False":
            out.append("0")
        elif tok != "" and "#" not in tok:
            out.append(tok)
    return out


def _as_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    if isinstance(v, str):
        if v in _TRUE_STRINGS:
            return True
        if v in _FALSE_STRINGS:
            return False
        # mirror the reference's eval() on string bools
        return bool(ast.literal_eval(v))
    raise TypeError(f"cannot coerce {v!r} to bool")


def _as_list(v: Any) -> list:
    if isinstance(v, str):
        return list(ast.literal_eval(v))
    return list(v)


@dataclass
class SELDConfig:
    """Typed equivalent of the reference's ~60 argparse flags.

    Field names and defaults mirror reference ``train.py:718-817`` one-to-one
    so the shipped ``SERVER_*.txt`` configs load unchanged.
    """

    # saving/loading (train.py:721-726)
    results_path: str = "RESULTS/Task2"
    checkpoint_dir: str = "RESULTS/Task2"
    load_model: Optional[str] = None
    # dataset paths (train.py:728-733)
    training_predictors_path: str = "/var/datasets/L3DAS21/processed/task2_predictors_train.pkl"
    training_target_path: str = "/var/datasets/L3DAS21/processed/task2_target_train.pkl"
    validation_predictors_path: str = "/var/datasets/L3DAS21/processed/task2_predictors_validation.pkl"
    validation_target_path: str = "/var/datasets/L3DAS21/processed/task2_target_validation.pkl"
    test_predictors_path: str = "/var/datasets/L3DAS21/processed/task2_predictors_test.pkl"
    test_target_path: str = "/var/datasets/L3DAS21/processed/task2_target_test.pkl"
    # training parameters (train.py:735-746)
    gpu_id: int = 0                       # kept for config compat; unused on TPU
    use_cuda: bool = True                 # interpreted as "use accelerator"
    early_stopping: bool = True
    fixed_seed: bool = True
    lr: float = 0.0001
    batch_size: int = 1
    sr: int = 32000
    patience: int = 250
    # model parameters (train.py:750-794)
    architecture: str = "DualQSELD-TCN"
    input_channels: int = 4
    n_mics: int = 1
    phase: bool = False
    class_overlaps: int = 3
    time_dim: int = 4800
    freq_dim: int = 256
    output_classes: int = 14
    pool_size: List[List[int]] = field(default_factory=lambda: [[8, 2], [8, 2], [2, 2], [1, 1]])
    cnn_filters: List[int] = field(default_factory=lambda: [64, 64, 64])
    pool_time: str = "True"
    dropout_perc: float = 0.3
    D: List[Any] = field(default_factory=lambda: [10])
    G: int = 128
    U: int = 128
    V: List[int] = field(default_factory=lambda: [128, 128])
    spatial_dropout_rate: float = 0.5
    batch_norm: str = "BN"
    dilation_mode: str = "fibonacci"
    model_extra_name: str = ""
    test_mode: str = "test_best"
    use_lr_scheduler: bool = True
    lr_scheduler_step_size: int = 150
    lr_scheduler_gamma: float = 0.5
    min_lr: float = 0.000005
    dataset_normalization: str = "True"
    kernel_size_cnn_blocks: int = 3
    kernel_size_dilated_conv: int = 3
    use_tcn: bool = True
    use_bias_conv: bool = True
    use_bias_linear: bool = True
    verbose: bool = False
    sed_loss_weight: float = 1.0
    doa_loss_weight: float = 5.0
    domain_classifier: str = "same"
    domain: str = "DQ"
    fc_activations: str = "Linear"
    fc_dropout: str = "Last"
    fc_layers: List[int] = field(default_factory=lambda: [128])
    V_kernel_size: int = 3
    use_time_distributed: bool = False
    parallel_ConvTC_block: str = "False"
    # test parameters (train.py:800-806)
    max_loc_value: float = 2.0
    num_frames: int = 600
    spatial_threshold: float = 2.0
    # checkpoint parameters (train.py:809-816)
    checkpoint_step: int = 100
    test_step: int = 10
    min_n_epochs: int = 1000
    Dcase21_metrics_DOA_threshold: int = 20
    parallel_magphase: bool = False
    # TPU-framework extensions (not in the reference)
    use_se_block: bool = False            # opt-in SE module (claimed in ref README, absent in ref code)
    attention_impl: str = "auto"          # 'xla' | 'pallas' | 'auto'
    qconv_impl: str = "auto"              # 'xla' | 'pallas' | 'int8' | 'auto'
    compute_dtype: str = "float32"        # 'float32' | 'bfloat16' (parity path stays f32)
    mesh_data: int = -1                   # data-parallel mesh axis size; -1 = all devices
    mesh_model: int = 1                   # model-parallel mesh axis size
    use_remat: Any = "auto"               # rematerialize activations in training:
                                          # 'auto' = on for f32 (unlocks b4/b8 parity training),
                                          # off for bf16 (BENCH.md: remat is a pure ~10% loss
                                          # once flash attention + the fused stage-1 kernel
                                          # removed the memory pressure); True/False force it
    frontend_bands: int = 0               # >1: banded eval-time CNN stage 1 (serving memory cap)
    frontend_impl: str = "auto"           # 'auto' | 'pallas' | 'pallas-interpret' | 'xla': fused train-mode stage 1
    grad_accum_steps: int = 1             # >1: split each batch into N sequential microbatches
                                          # (lax.scan) and average their grads before ONE Adam
                                          # update — trains any batch size in a microbatch's
                                          # activation footprint (BN normalizes per microbatch,
                                          # like torch grad accumulation)

    # ------------------------------------------------------------------
    _BOOL_FIELDS = frozenset({
        "use_cuda", "early_stopping", "fixed_seed", "phase", "use_lr_scheduler",
        "use_tcn", "use_bias_conv", "use_bias_linear", "verbose",
        "use_time_distributed", "parallel_magphase", "use_se_block",
    })
    # bool-or-'auto' fields: the literal token 'auto' passes through, anything
    # else coerces like a bool (so --use_remat=True/False/1/0 still work)
    _TRISTATE_FIELDS = frozenset({"use_remat"})
    _LIST_FIELDS = frozenset({"pool_size", "cnn_filters", "D", "V", "fc_layers"})

    def replace(self, **kwargs) -> "SELDConfig":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def field_names(cls) -> set:
        return {f.name for f in dataclasses.fields(cls)}

    @classmethod
    def coerce(cls, name: str, value: Any) -> Any:
        """Coerce a raw token (string) to the declared field type."""
        if name in cls._TRISTATE_FIELDS:
            if isinstance(value, str) and value.lower() in ("auto", "frontend"):
                return value.lower()
            return _as_bool(value)
        if name in cls._BOOL_FIELDS:
            return _as_bool(value)
        if name in cls._LIST_FIELDS:
            return _as_list(value)
        ftype = {f.name: f.type for f in dataclasses.fields(cls)}[name]
        if ftype in ("int", int):
            return int(value)
        if ftype in ("float", float):
            return float(value)
        # strings and Optional[str]
        return value


def tokens_to_config(tokens: List[str], base: Optional[SELDConfig] = None) -> SELDConfig:
    """Fold ``['--key', 'value', ...]`` or ``['--key=value', ...]`` tokens
    into a SELDConfig (both argparse spellings the reference CLI accepts)."""
    cfg = base if base is not None else SELDConfig()
    known = SELDConfig.field_names()
    updates = {}
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if not (isinstance(tok, str) and tok.startswith("--")):
            raise ValueError(f"expected a --key token, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(tokens):
                raise ValueError(f"flag {tok!r} has no value")
            value = tokens[i + 1]
            i += 2
        if key == "TextArgs":
            continue
        if key not in known:
            warnings.warn(f"ignoring unknown config key --{key}={value!r}", stacklevel=2)
            continue
        updates[key] = SELDConfig.coerce(key, value)
    return cfg.replace(**updates)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> SELDConfig:
    """Load a SELDConfig, optionally from a reference-style text config file."""
    cfg = SELDConfig()
    if path is not None:
        cfg = tokens_to_config(parse_text_args(path), base=cfg)
    if overrides:
        updates = {}
        for k, v in overrides.items():
            if k not in SELDConfig.field_names():
                warnings.warn(f"ignoring unknown override {k}={v!r}", stacklevel=2)
                continue
            updates[k] = SELDConfig.coerce(k, v) if isinstance(v, str) else v
        cfg = cfg.replace(**updates)
    return cfg
