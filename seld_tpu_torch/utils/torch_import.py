"""Import reference PyTorch SELD_Model state dicts as flax-named trees.

The port's copy of ``seld_tpu/utils/torch_import.py`` (numpy only, no
JAX). The reference saves ``model_state_dict`` inside its checkpoint files
(reference train.py:26-45). :func:`import_reference_state_dict` converts
that state dict (a ``name -> tensor or numpy array`` mapping) into the
``{'params': ..., 'batch_stats': ...}`` tree the JAX package's
``SELDModel`` takes, which is also what the port's modules carry (their
names and layouts are flax's), translating layouts:

- Conv2d ``(out, in, kh, kw)`` -> ``(kh, kw, in, out)``; Conv1d similarly.
- Quaternion/DQ component tensors ``r_weight``/... ``(out_c, in_c, *k)`` ->
  stacked ``(n, *k, in_c, out_c)``.
- Linear ``(out, in)`` -> Dense kernel ``(in, out)``; the reference's
  quaternion linear components are already ``(in_c, out_c)``.
- Attention Q/K/V 1x1 convs ``(E, E, 1)`` -> Dense kernels ``(E, E)``.
- BatchNorm weight/bias -> scale/bias; running stats -> batch_stats.

Key layout follows reference model.py: trunks ``seld_block``/``branch_A``/
``branch_B``; CNN blocks ``cnn.{i}.0`` (conv) and ``cnn.{i}.1`` (BN);
TCN ``tcn.ResBlocks.{j}.{conv1_filter,conv1_gate,batch_filter1,batch_filter2,
batch_gate2,conv2_skip,conv2_residual}``, ``tcn.conv1``, ``tcn.attention``,
``tcn.conv2``; heads ``sed.{idx}``/``doa.{idx}`` where the highest-indexed
parameterized module is the final real Linear. A port model takes the
result through ``utils/jax_bridge.py::from_jax_variables``:

    from_jax_variables(import_reference_state_dict(sd), model)
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

_Q_COMPONENTS = ["r_weight", "i_weight", "j_weight", "k_weight"]
_DQ_COMPONENTS = _Q_COMPONENTS + [c + "_2" for c in _Q_COMPONENTS]


def _to_np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _conv_weight(sub: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Convert one conv module's tensors to seld_tpu layout."""
    out = {}
    if "weight" in sub:  # real conv
        w = sub["weight"]
        axes = tuple(range(2, w.ndim)) + (1, 0)
        out["w"] = np.transpose(w, axes)
    else:  # quaternion / dual-quaternion components
        comps = _DQ_COMPONENTS if "r_weight_2" in sub else _Q_COMPONENTS
        stack = np.stack([sub[c] for c in comps])
        axes = (0,) + tuple(range(3, stack.ndim)) + (2, 1)
        out["w"] = np.transpose(stack, axes)
    if "bias" in sub:
        out["b"] = sub["bias"]
    return out


def _linear_weight(sub: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    if "weight" in sub:  # real Linear (out, in) -> kernel (in, out)
        out["kernel"] = sub["weight"].T
        if "bias" in sub:
            out["bias"] = sub["bias"]
    else:  # quaternion linear components already (in_c, out_c)
        comps = _DQ_COMPONENTS if "r_weight_2" in sub else _Q_COMPONENTS
        out["w"] = np.stack([sub[c] for c in comps])
        if "bias" in sub:
            out["b"] = sub["bias"]
    return out


def _bn(sub: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    params = {"scale": sub["weight"], "bias": sub["bias"]}
    stats = {"mean": sub["running_mean"], "var": sub["running_var"]}
    return params, stats


def _group(state: Dict[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    """Group flat keys by module path (everything up to the last dot)."""
    groups: Dict[str, Dict[str, np.ndarray]] = defaultdict(dict)
    for key, val in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        mod, leaf = key.rsplit(".", 1)
        groups[mod][leaf] = _to_np(val)
    return groups


def _convert_trunk(groups, prefix: str, params: dict, stats: dict) -> None:
    p_trunk = params.setdefault(prefix, {})
    s_trunk = stats.setdefault(prefix, {})
    tcn_p = p_trunk.setdefault("tcn", {})
    tcn_s = s_trunk.setdefault("tcn", {})
    res_name = {
        "conv1_filter": "conv_filter",
        "conv1_gate": "conv_gate",
        "conv2_skip": "conv_skip",
        "conv2_residual": "conv_res",
    }
    bn_name = {"batch_filter1": "bn_pre", "batch_filter2": "bn_filter", "batch_gate2": "bn_gate"}
    for mod, sub in groups.items():
        if not mod.startswith(prefix + "."):
            continue
        rel = mod[len(prefix) + 1 :]
        m = re.fullmatch(r"cnn\.(\d+)\.(\d+)", rel)
        if m:
            i, slot = int(m.group(1)), int(m.group(2))
            if slot == 0:
                p_trunk[f"cnn_{i}"] = _conv_weight(sub)
            else:
                p, s = _bn(sub)
                p_trunk[f"cnn_bn_{i}"] = p
                s_trunk[f"cnn_bn_{i}"] = s
            continue
        m = re.fullmatch(r"tcn\.ResBlocks\.(\d+)\.(\w+)", rel)
        if m:
            j, part = int(m.group(1)), m.group(2)
            blk_p = tcn_p.setdefault(f"resblock_{j}", {})
            blk_s = tcn_s.setdefault(f"resblock_{j}", {})
            if part in res_name:
                blk_p[res_name[part]] = _conv_weight(sub)
            elif part in bn_name:
                p, s = _bn(sub)
                blk_p[bn_name[part]] = p
                blk_s[bn_name[part]] = s
            continue
        if rel in ("tcn.conv1", "tcn.conv2"):
            tcn_p[rel.split(".")[1]] = _conv_weight(sub)
            continue
        m = re.fullmatch(r"tcn\.attention\.(\w+)", rel)
        if m:
            attn = tcn_p.setdefault("attention", {})
            name = m.group(1)
            w = sub["weight"]
            if w.ndim == 3:  # 1x1 conv (E, E, 1)
                attn[name] = {"kernel": w[:, :, 0].T}
            else:  # fc_out Linear
                attn[name] = {"kernel": w.T, "bias": sub["bias"]}
            continue


def _convert_head(groups, head: str, params: dict) -> None:
    idxs = sorted(
        int(m.group(1))
        for mod in groups
        if (m := re.fullmatch(head + r"\.(\d+)", mod))
    )
    if not idxs:
        return
    for li, idx in enumerate(idxs[:-1]):
        params[f"{head}_fc{li}"] = _linear_weight(groups[f"{head}.{idx}"])
    params[f"{head}_out"] = _linear_weight(groups[f"{head}.{idxs[-1]}"])


def import_reference_state_dict(state_dict) -> Dict[str, dict]:
    """Convert a reference ``model_state_dict`` into flax variables.

    Returns ``{'params': ..., 'batch_stats': ...}`` (batch_stats may be empty
    for batch_norm='noBN' models). Accepts torch tensors or numpy arrays;
    DataParallel ``module.`` prefixes are stripped like reference
    train.py:57-66.
    """
    state = {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in dict(state_dict).items()
    }
    groups = _group(state)
    params: dict = {}
    stats: dict = {}
    for trunk in ("seld_block", "branch_A", "branch_B"):
        if any(mod.startswith(trunk + ".") for mod in groups):
            _convert_trunk(groups, trunk, params, stats)
    _convert_head(groups, "sed", params)
    _convert_head(groups, "doa", params)

    def prune(d):
        if not isinstance(d, dict):
            return d
        return {k: prune(v) for k, v in d.items() if not (isinstance(v, dict) and not prune(v))}

    params = prune(params)
    stats = prune(stats)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
