#!/usr/bin/env python3
"""Drive the PyTorch port's flagship serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
2. build: compiles ``seld_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernel vs plain: every kernel of the serving path against its plain
   PyTorch version on the card, at multi-tile shapes with ragged tails and at
   the flagship's shapes (batch 2), in float32 (TF32 off) and bfloat16, with
   the median time of each;
4. main path: builds the full-width flagship DualQSELD-TCN
   (config/DQSELD-TCN-S1-PHI_8ch.txt) with seeded random weights, serves 3
   requests of 4 one-minute 8-channel clips through ``seld_tpu_torch.serve``,
   checks the outputs and that every kernel launched, and holds one clip
   against the plain path on the same weights.

The line before the last is the card (``nvidia-smi``'s name and power limit);
the one before that is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero and prints no
result. Needs one CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP_CONFIG = ROOT / "config" / "DQSELD-TCN-S1-PHI_8ch.txt"
SR, CLIP_SECONDS, CHANNELS = 32000, 60, 8
REQUESTS, CLIPS_PER_REQUEST = 3, 4
F32_TOL = 2e-4    # x max|ref|: float32 sums in another order (TF32 off)
BF16_TOL = 2e-2   # x max|ref|: ~2.5 bf16 ulps (the plain versions round elsewhere)
MAIN_TOL = 0.05   # bf16 serving vs the float32 plain path, on sigmoid/tanh outputs

KERNELS = {  # launch-count name -> (source in the repo, TPU kernel it replaces)
    "stft_mag": ("seld_tpu_torch/csrc/stft_mag.cu",
                 "seld_tpu/ops/pallas/stft.py:322"),
    "conv3x3_smallcin": ("seld_tpu_torch/csrc/conv3x3_bn_relu_fpool.cu",
                         "seld_tpu/ops/pallas/conv2d_pool.py:619"),
    "conv3x3_widecin": ("seld_tpu_torch/csrc/conv3x3_bn_relu_fpool.cu",
                        "seld_tpu/ops/pallas/conv2d_pool.py:890"),
    "flash_attn_fwd": ("seld_tpu_torch/csrc/flash_attn_fwd.cu",
                       "seld_tpu/ops/pallas/attention.py:298"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_environment(torch) -> str:
    from seld_tpu_torch import _build

    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    card = card_line()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[env] nvcc {nvcc}: {ver[-1] if ver else '?'}")
    print(f"[env] card: {card}")
    return card


def phase_build() -> None:
    from seld_tpu_torch import _build

    path = _build.library_path(_build.find_nvcc())
    prebuilt = path.exists()
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] kernels {'loaded' if prebuilt else 'built with nvcc and loaded'} "
          f"in {time.perf_counter() - t0:.1f} s: {path.name}")
    log = path.with_suffix(".log")   # nvcc's command line and ptxas' report
    if not log.exists():
        return
    entry, spill = "?", ""
    for line in log.read_text().splitlines():   # ptxas -v: entry, spills, registers
        if "Compiling entry function" in line:   # keep "<kernel>I<template args>"
            mangled = line.split("'")[1]
            m = re.search(r"(stft_mag|conv3x3|flash_fwd)_kernelI\w+?EE", mangled)
            entry = m.group(0) if m else mangled
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            print(f"[build] {entry}: {line.split(':', 1)[1].strip()}; {spill}")


def time_ms(torch, fn, warmup: int = 2, iters: int = 10) -> float:
    """Median milliseconds of fn() over iters launches, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, name, shape_tag, got, want, dtype, card, timed=None):
    """Check got against want at the dtype's tolerance; returns max|d|."""
    torch.cuda.synchronize()
    got = got.float()
    want = want.float()
    require(got.shape == want.shape, f"{name} {shape_tag}: shape {tuple(got.shape)} "
            f"!= plain {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name} {shape_tag}: non-finite output")
    d = (got - want).abs().max().item()
    ref = want.abs().max().item()
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * max(ref, 1e-30)
    msg = (f"[kernel] {name:17s} {shape_tag:9s} {str(dtype)[6:]:8s} "
           f"shape {tuple(got.shape)} max|d| {d:.3e} max|ref| {ref:.3e} tol {tol:.3e}")
    if timed is not None:
        msg += f" | kernel {timed[0]:.3f} ms plain {timed[1]:.3f} ms ({card})"
    print(msg)
    require(d <= tol, f"{name} {shape_tag} {dtype}: max|d| {d:.3e} > tol {tol:.3e}")
    return d


def phase_kernels(torch, card: str) -> dict:
    """Every kernel against its plain version; returns the flagship bf16
    numbers per launch-count name."""
    from seld_tpu_torch.ops.kernels import launch_counts
    from seld_tpu_torch.ops.kernels.attention import flash_attention, flash_attention_plain
    from seld_tpu_torch.ops.kernels.conv2d_pool import (
        conv2d_bn_relu_fpool, conv2d_bn_relu_fpool_plain,
    )
    from seld_tpu_torch.ops.kernels.stft import stft_mag, stft_mag_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    summary = {}

    def record(name, d, ms, plain_ms):
        summary[name] = {"max_abs_err": d, "ms": ms, "plain_ms": plain_ms}

    # ---- K1: (rows, n) audio; ragged frames (100 = 64 + 36) and bins (240 = 3*64 + 48)
    stft_cases = [
        ("ragged", (3, 40_000), 512, 112),
        ("ragged", (2, 37_123), 480, 80),
        ("flagship", (2, CHANNELS, SR * CLIP_SECONDS), 512, 112),
    ]
    for tag, shape, nperseg, noverlap in stft_cases:
        x = randn(*shape)
        for dt in (torch.float32, torch.bfloat16):
            k = lambda: stft_mag(x, nperseg, noverlap, out_dtype=dt)
            p = lambda: stft_mag_plain(x, nperseg, noverlap, out_dtype=dt)
            timed = (time_ms(torch, k), time_ms(torch, p)) if tag == "flagship" else None
            d = compare(torch, "stft_mag", tag, k(), p(), dt, card, timed)
            if tag == "flagship" and dt == torch.bfloat16:
                record("stft_mag", d, *timed)

    # ---- K2 / K3: x (B, Cin, F, T), w (3, 3, Cin, Cout)
    conv_cases = [  # tag, B, Cin, F, T, Cout, pf
        ("ragged", 2, 5, 24, 300, 80, 8),       # smallcin: 3 T tiles, 2 Cout tiles
        ("ragged", 2, 8, 8, 130, 64, 2),
        ("ragged", 2, 24, 12, 300, 80, 4),      # widecin: 3 Cin chunks
        ("ragged", 1, 16, 4, 129, 200, 2),
        ("flagship", 2, CHANNELS, 256, 4800, 192, 8),   # stage 1
        ("flagship", 2, 192, 32, 4800, 192, 8),         # stage 2
        ("flagship", 2, 192, 4, 4800, 192, 2),          # stage 3
    ]
    for tag, b, cin, f, t, cout, pf in conv_cases:
        name = "conv3x3_smallcin" if cin <= 8 else "conv3x3_widecin"
        xf = randn(b, cin, f, t).abs()
        wf = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        scale = randn(cout, scale=0.2) + 1.0
        bias = randn(cout, scale=0.2)
        for dt in (torch.float32, torch.bfloat16):
            x, w = xf.to(dt), wf.to(dt)
            k = lambda: conv2d_bn_relu_fpool(x, w, scale, bias, pf)
            p = lambda: conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf)
            timed = (time_ms(torch, k), time_ms(torch, p)) if tag == "flagship" else None
            label = f"{tag}" if tag != "flagship" else f"stage{1 + (cin > 8) + (f == 4)}"
            d = compare(torch, name, label, k(), p(), dt, card, timed)
            # the summary line carries stage 1 (smallcin) and stage 2 (widecin)
            if tag == "flagship" and dt == torch.bfloat16 and f != 4:
                record(name, d, *timed)

    # ---- K4: q, k, v (B, T, H, D); ragged T = 200 = 3 * 64 + 8
    attn_cases = [
        ("ragged", 2, 200, 3, 48),
        ("ragged", 1, 130, 2, 32),
        ("flagship", 2, 2400, 8, 48),
    ]
    for tag, b, t, h, d_head in attn_cases:
        qf, kf, vf = (randn(b, t, h, d_head) for _ in range(3))
        scale = d_head ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            q, k_, v = qf.to(dt), kf.to(dt), vf.to(dt)
            kern = lambda: flash_attention(q, k_, v, scale)
            plain = lambda: flash_attention_plain(q, k_, v, scale)
            timed = (time_ms(torch, kern), time_ms(torch, plain)) if tag == "flagship" else None
            (o, lse), (o_ref, lse_ref) = kern(), plain()
            d = compare(torch, "flash_attn_fwd", tag, o, o_ref, dt, card, timed)
            compare(torch, "flash_attn_lse", tag, lse, lse_ref, torch.float32, card)
            if tag == "flagship" and dt == torch.bfloat16:
                record("flash_attn_fwd", d, *timed)
    require(all(launch_counts[n] > 0 for n in KERNELS), f"kernels not launched: {launch_counts}")
    return summary


def phase_main_path(torch, card: str) -> dict:
    """Serve REQUESTS requests of CLIPS_PER_REQUEST clips through the flagship;
    returns the launch counts of that run."""
    import numpy as np

    from seld_tpu_torch.models.seld import SELDModel
    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from seld_tpu_torch.ops.kernels.stft import stft_mag_plain
    from seld_tpu_torch.serve import build_flagship, serve

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    t0 = time.perf_counter()
    model = build_flagship(str(FLAGSHIP_CONFIG), dtype=torch.bfloat16, device=dev,
                           generator=gen)
    require(isinstance(model, SELDModel), "build_flagship must return a SELDModel")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] flagship built in {time.perf_counter() - t0:.1f} s: "
          f"{n_params} parameters, compute dtype {model.compute_dtype}")

    rng = np.random.default_rng(0)
    n = SR * CLIP_SECONDS
    requests = [
        rng.standard_normal((CLIPS_PER_REQUEST, CHANNELS, n), dtype=np.float32)
        for _ in range(REQUESTS)
    ]
    torch.cuda.synchronize()
    reset_launch_counts()
    outputs, latencies = [], []
    for audio in requests:
        t0 = time.perf_counter()
        sed, doa = serve(model, torch.from_numpy(audio).to(dev))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        outputs.append((sed, doa))
    counts = dict(launch_counts)
    print(f"[main] launches during the {REQUESTS} requests: {counts}")
    require(all(counts[k] > 0 for k in KERNELS), f"a kernel of the path never ran: {counts}")

    sed_w = int(model.output_classes * model.class_overlaps)
    for i, (sed, doa) in enumerate(outputs):
        require(tuple(sed.shape) == (CLIPS_PER_REQUEST, 600, sed_w),
                f"sed shape {tuple(sed.shape)}")
        require(tuple(doa.shape) == (CLIPS_PER_REQUEST, 600, 3 * sed_w),
                f"doa shape {tuple(doa.shape)}")
        require(bool(torch.isfinite(sed).all() and torch.isfinite(doa).all()),
                f"request {i}: non-finite output")
        require(bool(((sed >= 0) & (sed <= 1)).all()), f"request {i}: sed outside [0, 1]")
        require(bool(((doa >= -1) & (doa <= 1)).all()), f"request {i}: doa outside [-1, 1]")
    audio_h = CLIPS_PER_REQUEST * CLIP_SECONDS / 3600.0
    for i, lat in enumerate(latencies):
        print(f"[main] request {i}: {CLIPS_PER_REQUEST} clips in {lat * 1e3:.1f} ms "
              f"= {audio_h / lat:.4f} audio-hours/s ({card})")
    steady = statistics.median(latencies[1:])
    print(f"[main] steady (median of requests 1..{REQUESTS - 1}): {steady * 1e3:.1f} ms "
          f"per {CLIPS_PER_REQUEST} clips = {audio_h / steady:.4f} audio-hours/s ({card})")

    # one clip through the plain path on the same weights: plain STFT + the
    # unfused eval model (no kernels), float32 with TF32 off
    clip = torch.from_numpy(requests[0][:1]).to(dev)
    with torch.no_grad():
        feats = stft_mag_plain(clip, out_dtype=torch.float32).transpose(-1, -2)
        sed_ref, doa_ref = model(feats.contiguous())
    d_sed = (outputs[0][0][:1].float() - sed_ref.float()).abs().max().item()
    d_doa = (outputs[0][1][:1].float() - doa_ref.float()).abs().max().item()
    print(f"[main] clip 0, kernels bf16 vs plain f32: max|d sed| {d_sed:.3e} "
          f"max|d doa| {d_doa:.3e} (tol {MAIN_TOL})")
    require(max(d_sed, d_doa) <= MAIN_TOL, "served clip disagrees with the plain path")
    return counts



def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: torch is not importable: {e}")
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    if not (ROOT / "seld_tpu_torch" / "__init__.py").is_file() or not FLAGSHIP_CONFIG.is_file():
        print(f"FAIL: {ROOT} holds no seld_tpu_torch checkout")
        return 1
    sys.path.insert(0, str(ROOT))
    import seld_tpu_torch

    seld_tpu_torch.disable_tf32()
    try:
        card = phase_environment(torch)
        phase_build()
        summary = phase_kernels(torch, card)
        counts = phase_main_path(torch, card)
        require("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **summary[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
