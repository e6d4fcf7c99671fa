"""Inference CLI of the port: raw multichannel audio -> L3DAS21 Task-2
submission CSVs, with the root ``predict.py``'s surface:

    python -m seld_tpu_torch.predict --TextArgs=config/DQSELD-TCN-S1-PHI_8ch.txt \
        --checkpoint RESULTS_Original/.../checkpoint_best_model \
        --inputs clip1.npy clip2.wav --out-dir submissions/ [--key=value ...] \
        [--impl auto|fused|apply] [--device=cpu]

Inputs are .npy arrays (channels, samples) or .wav files at the configured
sample rate; one CSV of ``[frame, class, x, y, z]`` rows per clip. The
checkpoint is one that the port's Trainer or the JAX package's Trainer
wrote, told apart by its first bytes (only its model state is read; a JAX
file through the port's restricted reader, without JAX); without one the
model keeps a seeded random init and a warning is printed.

Serving paths (``--impl``): ``fused`` is ``serve.serve`` (K1 featurizer,
or for a ``--phase=True`` config the magnitude + phase featurizer
``data/features.py::spectrum_fast_batch``, then ``fused_infer``: K2/K3 CNN
stages, K4 attention, per trunk); ``apply`` featurizes in float32, with K1
for magnitude configs and ``data/features.py::spectrum_fast`` for phase
configs (the root ``predict.py:126-129``), and runs the eval model in the
config's compute dtype, where ``--qconv_impl=pallas`` puts the pointwise
convs and the FC heads on K7 and ``--qconv_impl=int8`` on K8. ``auto`` picks
``fused`` on a CUDA device for bfloat16 BN configs that pool time in the
TCN, ``apply`` otherwise. It runs on the CUDA card unless ``--device=cpu``
asks for the CPU (each kernel's plain version).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def load_audio(path: str, sr: int):
    """(channels, samples) float32 from a .npy array or a .wav file at ``sr``;
    PCM integer WAVs are rescaled to +-1.0 before the float cast."""
    import numpy as np

    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".wav"):
        import scipy.io.wavfile as wavfile

        file_sr, data = wavfile.read(path)
        if file_sr != sr:
            raise ValueError(f"{path}: sample rate {file_sr} != configured {sr}")
        if data.ndim == 1:
            data = data[:, None]
        if data.dtype.kind == "i":
            scale = float(np.iinfo(data.dtype).max) + 1.0
            data = data.astype("float32") / scale
        return data.T.astype("float32")
    raise ValueError(f"unsupported audio format: {path}")


def main(argv=None):
    """Run the CLI; returns one dict per clip: its input, CSV, event count,
    (sed, doa) as float32 numpy arrays and the wall seconds from the loaded
    clip in host memory to (sed, doa) back on the host."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--TextArgs", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="a checkpoint of the port's or the JAX package's Trainer "
                         "(default: seeded random init)")
    ap.add_argument("--inputs", nargs="+", required=True)
    ap.add_argument("--out-dir", type=str, default="submissions")
    ap.add_argument("--impl", type=str, default="auto", choices=["auto", "fused", "apply"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="device to run on (default cuda; cpu for the CPU)")
    args, extra = ap.parse_known_args(argv)

    import numpy as np
    import torch

    from seld_tpu_torch import disable_tf32
    from seld_tpu_torch.config import load_config, tokens_to_config
    from seld_tpu_torch.metrics import gen_submission_list_task2
    from seld_tpu_torch.models.seld import model_from_config
    from seld_tpu_torch.serve import serve, serve_apply
    from seld_tpu_torch.training.checkpoint import CheckpointMismatch, load_model_weights
    from seld_tpu_torch.utils.io import write_submission_csv

    cfg = load_config(args.TextArgs)
    if extra:
        cfg = tokens_to_config(extra, base=cfg)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("predict: no CUDA device; pass --device=cpu to run on the CPU")
    disable_tf32()
    model = model_from_config(cfg, device=device, generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        try:
            load_model_weights(args.checkpoint, model)
        except CheckpointMismatch as e:
            raise SystemExit(
                f"checkpoint {args.checkpoint!r} does not match the model built from config "
                f"{args.TextArgs!r}:\n  " + "\n  ".join(e.diffs)) from None
    else:
        print("WARNING: no --checkpoint given; using random init", file=sys.stderr)
    model.eval()
    # the root predict.py's choice, its 'not the CPU backend' read as 'a CUDA device'
    fused = args.impl == "fused" or (
        args.impl == "auto" and device.type == "cuda" and cfg.compute_dtype == "bfloat16"
        and cfg.batch_norm == "BN" and cfg.pool_time == "TCN")

    os.makedirs(args.out_dir, exist_ok=True)
    results = []
    for path in args.inputs:
        clip = np.ascontiguousarray(load_audio(path, cfg.sr), dtype=np.float32)
        t0 = time.perf_counter()
        audio = torch.from_numpy(clip).to(device)
        with torch.no_grad():
            sed, doa = (serve if fused else serve_apply)(model, audio[None], phase=cfg.phase)
            sed, doa = sed[0].float().cpu().numpy(), doa[0].float().cpu().numpy()
        seconds = time.perf_counter() - t0
        events, _ = gen_submission_list_task2(
            sed, doa, max_loc_value=cfg.max_loc_value, num_classes=cfg.output_classes,
            max_overlaps=int(cfg.class_overlaps))
        out_csv = os.path.join(args.out_dir, os.path.splitext(os.path.basename(path))[0] + ".csv")
        write_submission_csv(out_csv, events)
        print(f"{path} -> {out_csv} ({len(events)} events)")
        results.append({"input": path, "csv": out_csv, "events": len(events), "sed": sed,
                        "doa": doa, "seconds": seconds})
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
