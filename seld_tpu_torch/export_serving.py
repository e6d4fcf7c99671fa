"""Export the port's serving pipeline as a ``torch.export`` artifact.

Counterpart of ``tools/export_serving.py``: ``torch.export`` traces featurize
+ infer into one graph and ``torch.export.save`` writes it to a file. The
model's parameters and BN statistics are inputs of the graph (BN folding
and Hamilton assembly are ops in it), so the loaded module serves any
checkpoint of the same config: ``module.load_state_dict(sd)`` with the
pipeline's keys, ``model.<name>`` (:func:`build_pipeline` of a model gives
them). A serving host loads the artifact and calls it with torch and the
op library alone, without the config system or the model-building code:

    import torch
    import seld_tpu_torch.ops.kernels.library   # first: registers the seld:: ops
    module = torch.export.load("serving.pt2").module()
    sed, doa = module(audio)

Each kernel call is a ``seld::`` custom op in the graph
(``ops/kernels/library.py``); without that import the load fails with
"custom op is not registered". The import also turns TF32 off, so that the
artifact's float32 convolutions and matmuls outside the kernels run in full
float32, as eager serving's do.

Usage:
    python -m seld_tpu_torch.export_serving --TextArgs=config/DQSELD-TCN-S1-PHI_8ch.txt \\
        [--checkpoint CKPT] --batch 32 [--seconds 60] --out serving.pt2 \\
        [--impl auto|fused|apply] [--device cpu] [--key=value ...]
    # later / elsewhere:
    python -m seld_tpu_torch.export_serving --load serving.pt2 --selftest

The calling convention is audio (batch, channels, sr * seconds) float32 ->
(sed, doa) float32, at the shape traced. The artifact records its device:
one traced on the card (the default) runs on a CUDA card and launches the
kernels, one traced with ``--device cpu`` runs each kernel's plain version
on the CPU, as the JAX tool's artifacts record their platform.

Pipelines (``--impl``): ``fused`` is ``serve.serve`` (K1, or
``spectrum_fast_batch`` for ``--phase`` configs, then ``fused_infer``: K2 /
K3 per trunk, K4); ``apply`` is ``serve.serve_apply`` (K1 in float32, or
``spectrum_fast`` for phase configs, then the eval model in the config's
compute dtype: K7 under ``--qconv_impl=pallas``, K8 under ``int8``);
``auto`` is the JAX tool's rule: ``fused`` on a CUDA device for bfloat16 BN
configs that pool time in the TCN and have no ``parallel_ConvTC_block``,
else ``apply`` (so, unlike the predict CLI, 2Parallel configs stay on
``apply``). ``--checkpoint`` is read by
``training/checkpoint.py::load_model_weights`` (the port's files and
``seld_tpu`` files); without one the weights are a seeded random init.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from seld_tpu_torch.ops.kernels import library  # noqa: F401  (registers the seld:: ops)

IMPLS = ("auto", "fused", "apply")
_NO_PARALLEL = {"False", "false", "None", "none"}


class ServingPipeline(torch.nn.Module):
    """audio -> (sed, doa) through ``serve.serve`` (``fused``) or
    ``serve.serve_apply`` (``apply``); the model is the submodule ``model``."""

    def __init__(self, model: torch.nn.Module, impl: str, phase: bool):
        super().__init__()
        if impl not in ("fused", "apply"):
            raise ValueError(f"impl {impl!r} not in ('fused', 'apply')")
        self.model, self.impl, self.phase = model, impl, phase

    def forward(self, audio: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        from seld_tpu_torch.serve import serve, serve_apply   # not at the top: --load builds no model

        return (serve if self.impl == "fused" else serve_apply)(self.model, audio,
                                                                phase=self.phase)


def resolve_impl(cfg, impl: str, device: torch.device) -> str:
    """``impl``, with 'auto' resolved by ``tools/export_serving.py:113-122``'s
    rule, "not the CPU backend" read as "a CUDA device"."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl != "auto":
        return impl
    fused = (device.type == "cuda" and cfg.compute_dtype == "bfloat16"
             and cfg.parallel_ConvTC_block in _NO_PARALLEL and cfg.batch_norm == "BN"
             and cfg.pool_time == "TCN")
    return "fused" if fused else "apply"


def build_pipeline(cfg, model: torch.nn.Module, impl: str) -> ServingPipeline:
    """The serving pipeline of ``model`` (an eval-mode ``SELDModel`` of
    ``cfg``): ``forward(audio)`` gives (sed, doa); ``impl`` 'auto' is
    resolved on the model's device (:func:`resolve_impl`)."""
    device = next(model.parameters()).device
    return ServingPipeline(model, resolve_impl(cfg, impl, device), cfg.phase)


def load_artifact(path: str):
    """(module, (shape, dtype, device) of its audio input) of an artifact
    written by this tool: the loaded program's module and what it was traced
    at."""
    program = torch.export.load(path)
    (name,) = program.graph_signature.user_inputs
    val = next(n.meta["val"] for n in program.graph.nodes
               if n.op == "placeholder" and n.name == name)
    return program.module(), (tuple(val.shape), val.dtype, val.device)


def _selftest(module, shape, dtype, device) -> list:
    with torch.no_grad():
        outs = module(torch.zeros(shape, dtype=dtype, device=device))
    shapes = [tuple(o.shape) for o in outs]
    print("selftest ok:", shapes)
    return shapes


def main(argv=None) -> dict:
    """Run the CLI; returns what it did: for an export the impl, the audio
    shape, the artifact's path and bytes, the trace seconds and the
    exported program; for a load the input spec (and the selftest's output
    shapes)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--TextArgs", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="a checkpoint of the port's or the JAX package's Trainer "
                         "(default: seeded random init)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=int, default=60)
    ap.add_argument("--impl", type=str, default="auto", choices=IMPLS)
    ap.add_argument("--out", type=str, default="serving.pt2")
    ap.add_argument("--load", type=str, default=None,
                    help="load an artifact instead of exporting")
    ap.add_argument("--selftest", action="store_true",
                    help="after load/export, run the artifact on zeros")
    ap.add_argument("--device", type=str, default="cuda",
                    help="device to trace on (default cuda; cpu for the CPU)")
    args, extra = ap.parse_known_args(argv)

    if args.load:
        module, (shape, dtype, device) = load_artifact(args.load)
        print(f"loaded {args.load}: audio {shape} {str(dtype)[6:]} on {device}")
        done = {"audio_shape": shape, "dtype": dtype, "device": device}
        if args.selftest:
            done["selftest"] = _selftest(module, shape, dtype, device)
        return done

    from seld_tpu_torch.config import load_config, tokens_to_config
    from seld_tpu_torch.models.seld import model_from_config
    from seld_tpu_torch.training.checkpoint import CheckpointMismatch, load_model_weights

    cfg = load_config(args.TextArgs)
    if extra:
        cfg = tokens_to_config(extra, base=cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("export_serving: no CUDA device; pass --device=cpu to export "
                           "for the CPU")
    model = model_from_config(cfg, device=device, generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        try:
            load_model_weights(args.checkpoint, model)
        except CheckpointMismatch as e:
            raise SystemExit(
                f"checkpoint {args.checkpoint!r} does not match the model built from config "
                f"{args.TextArgs!r}:\n  " + "\n  ".join(e.diffs)) from None
    else:
        print("WARNING: no --checkpoint; exporting a random init (the artifact takes any "
              "state dict of the same config through load_state_dict)", file=sys.stderr)
    pipeline = build_pipeline(cfg, model.eval(), args.impl)
    # a --phase config featurizes two channels (magnitude, phase) from each audio channel
    shape = (args.batch, cfg.input_channels // (2 if cfg.phase else 1), cfg.sr * args.seconds)
    audio = torch.zeros(shape, device=device)
    t0 = time.perf_counter()
    program = torch.export.export(pipeline, (audio,), strict=False)
    trace_s = time.perf_counter() - t0
    program.example_inputs = None   # the zeros traced: 245 MB at the flagship's batch 4
    torch.export.save(program, args.out)
    size = os.path.getsize(args.out)
    print(f"exported impl={pipeline.impl} device={device} audio={shape} -> {args.out} "
          f"({size / 1e6:.1f} MB), traced in {trace_s:.1f} s")
    done = {"impl": pipeline.impl, "audio_shape": shape, "out": args.out, "bytes": size,
            "trace_seconds": trace_s, "program": program}
    if args.selftest:
        done["selftest"] = _selftest(program.module(), shape, torch.float32, device)
    return done


if __name__ == "__main__":
    main(sys.argv[1:])
