#!/usr/bin/env python3
"""Drive the PyTorch port's flagship serving and training paths, its
training and predict entry points, its front-end variants and per-stage
profiler, the shipped magnitude + phase configs, checkpoints written by the
JAX package, and training from a ``.seldpak`` file and across processes,
once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
2. build: compiles ``seld_tpu_torch/csrc/*.cu`` with nvcc for sm_90a (one
   nvcc per source, all at once); prints ptxas' registers, shared memory and
   spills per kernel and the HMMA / HGMMA / IMMA count in the SASS of each
   tensor-core kernel (TC_KERNELS: K1's bf16 GEMM, K2's bf16 stage 1, the
   GEMM tile of K10a and K2w, K4 / K6 past head dim 128, K8's int8 GEMM and
   the split-TF32 float32 kernels of K4, K6 (past head dim 128 too), K7,
   the dW tile of K9 and K5, K2w and K10a, the conv block tile of K3,
   K10b and K9's F1 / F2, and the float smallcin tile of K2 and K5's F1 /
   F2 / g_z among them), failing if one has
   none or if a K4 / K6 kernel past
   head dim 128, a split-TF32 kernel or K9's B1 / g_z walker
   (ROUTE_KERNELS, its registers printed) spills;
3. kernel vs plain: every kernel of every path (K7, K8, K2w, K10a and
   K10b included, K8 within one ulp of its plain version at both row
   tiles, K1's float32 FFT at nperseg 64-2048 and within 1e-5 x
   max of float64) against its plain PyTorch version
   on the card, at multi-tile shapes with ragged tails and at the
   flagship's shapes (batch 2), in float32 (TF32 off) and bfloat16 (K1's
   and K2's tensor-core kernels also at STFT_TC_CASES and SMALLCIN_TC_CASES:
   ragged in every grid dimension, K1 at an nperseg ragged against its tap
   chunk and on bf16 audio, K2 at Cin 5 and 8 up to pf 256 in chunks), forward
   outputs and every gradient, with the median time of each kernel, of its
   plain version and of one PyTorch library call where there is one; the
   conv tile at ragged Cin, Cout, T and pf (TILE_CASES) as K3 and as K9's
   dh, and K3's pooled output against K9 F1's pre bit for bit on random
   bf16 inputs at the flagship's stage 2, and K2's float32 output against
   K10b's bit for bit at the flagship's stage 1 on random inputs; K5 in
   both dtypes (float32's F1, F2 and g_z pass on the float smallcin tile,
   F1's sums held to float64, and the split-TF32 dW tile, bfloat16's tensor-core
   passes: F1, F2, the g_z pass and the dW tile; B2 as g_z + dW beside
   cuDNN's weight gradient and, in float32, its bounds) and, at the
   flagship's stage 1 on random inputs in both
   dtypes, K5's F2 and g_z routing against the conv rows bit for bit, and
   K5's float32 g_z pass and dW tile keeping NaNs where their plain versions
   do; K6's, K9's and K5's dW and K5's g_z rerun bitwise equal; K7's and
   addmm's device time from the profiler; K8 by events, back to back and in
   device time beside torch._int_mm and bf16 addmm, and its two row tiles
   in turns at M 600-9600 (device time); K1's bf16 kernel, K1's float32 FFT
   and torch.stft,
   K2, K3 and cuDNN's conv, K4 and scaled_dot_product_attention timed back
   to back (stream_ms), with K4's floor of exponentials beside; K4 and K6
   at head dims 136-1280 (both dtypes in column groups of at most 256, the
   wide kernels; float32's in split TF32) with their kernels' registers and
   spills, and at D 48, 160, 192, 256, 320 and 640 beside SDPA and its
   backward back to back with each bound (at D 160 the wide kernels launched
   alone, no pad copy, in both dtypes); the
   float32 flagship instances of K2, K3, K4, K5 F1 / F2 / B1 / g_z / dW,
   K6, K7, K9 F1 / F2 / B1 / g_z / dW / dx (dx also at stage 3), K2w, K10a
   and K10b (and K4 / K6 at D 160) beside their library call in float32 with TF32 off, where
   there is one, and their float32 bound (the ``[f32]`` lines), the
   split-TF32 kernels (K4 and K6 at D 48 and 160, K7 at M 9600 with dx
   through the autograd Function, K9's dW at stage 2 and K5's at stage 1,
   on the grid's inputs and on real-valued ones; K2 and K5's F1 sums at
   stage 1, K2w at stage 1 and K10a
   at stages 1-3, K3 at stages 2-3, K10b at stages 1-3, K9's F1 / F2 at
   stage 2 and K9's dx at stages 2-3 on real-valued inputs, rerun bitwise)
   also held to float64: each within F64_FACTOR x the float32 plain
   version's distance from the plain version in float64 (the dW tiles and
   dx: the plain version with cuDNN off, whose float32 wgrad and dgrad
   are printed beside); K9's B1 and g_z at the flagship's stages 2 and 3,
   batches 2 and 8, both dtypes, by events, back to back and in device
   time, with the achieved TB/s and the share of the byte bound (stage 3
   after an L2 flush: ``k9_route_times``); K9's B1 and g_z routing nothing
   for a pool window that holds a NaN, in both dtypes, as the plain version
   (and JAX's _route_group); K2w's and K10a's operand builds
   in both dtypes
   (the torch pack, the patch kernel) and products alone, and both beside
   cuDNN back to back, at the flagship's stages;
4. serving path: builds the full-width flagship DualQSELD-TCN
   (config/DQSELD-TCN-S1-PHI_8ch.txt) with seeded random weights, serves 3
   requests of 4 one-minute 8-channel clips through ``seld_tpu_torch.serve``,
   checks the outputs and that every serving kernel launched, and holds one
   clip against the plain path on the same weights; then a window of
   HOST_WINDOW requests from host memory, and a window of CARD_WINDOW
   requests with the audio on the card at batches 4 and 16, each reported as
   its total audio over its total wall time with the spread of its requests,
   and one profiled request per batch with K1's, K2's, K3's and K4's device time
   read out (SERVING_WATCH);
5. training path: (a) one float32 ``make_train_step`` at batch 2, dropout
   off, on the kernel path (K5, K4 + K6), on the ``ct`` kernel path (K5,
   K9 at stages 2-3, K4 + K6), each with K5's g_z pass and dW tile launched
   once and one more of its steps profiled (K5's passes', K4's, K6's and K9's
   F1, F2, dW and dx device time read out, F32_STEP_WATCH), on the plain path (plain stage 0, full
   attention) and on the plain path in float64, from the same weights and
   batch: kernel and plain losses within 1e-4, and every gradient of the
   kernel path within 1e-3 (relative norm) of float64 or no further from it
   than twice the plain path with its batch statistics taken in float64, of
   the ``ct`` path within 1e-3 or no further than twice both the plain f32
   path and a control of the ``ct`` path with K9's dW taken in float64;
   a control with stage 0's BN bias one ulp up shows why 1e-3 between two
   float32 paths is out of reach, and stage 0 alone against float64 counts
   the pool windows that rounding routes apart (printed, not gated); (b)
   bfloat16 at batch 8 on seeded synthetic features: 2 warm-up and 5 timed
   steps, finite losses, changed parameters, every training kernel
   launched, ms per step and audio-hours trained per second;
6. training entry point: ``python -m seld_tpu_torch.train`` on the flagship
   config with ``--frontend_impl=pallas-ct`` (every CNN stage on a kernel:
   K5, then K9 for stages 2-3) in bfloat16 at batch 8, on a synthetic
   six-pickle dataset of one-minute clips: two epochs, then a resumed third;
   finite losses, the four checkpoint roles, the CSVs and
   ``results_dict.json``, and K5, K9 (every pass, both stages), K4 and K6
   launched in every step (the trainer's ``metrics.jsonl``); then the
   ``pallas-ct`` step beside the ``auto`` step at batch 8, in turns, with ms
   per step, audio-hours trained per second and peak device memory, and a
   profiled ``pallas-ct`` step with the PROFILE_WATCH kernels' device time
   in it (K6, K9 dW, K5 dW, K5 F1, K7), as in phase 5b's and phase 7's;
7. predict entry point: ``seld_tpu_torch.predict.main`` on the flagship with
   phase 6's best checkpoint over three one-minute clips (two .npy, one int16
   .wav): ``auto`` (the fused bf16 path, K1-K4), ``--impl apply
   --qconv_impl=pallas`` in float32 (K1, K7) and in bf16 (K1, K7, K4), and
   ``--qconv_impl=int8`` in bf16 (K1, K8, K4); each writes three valid CSVs
   with K7 / K8 at 22 launches per clip, and its clip 0 is held to the
   float32 ``xla`` apply path (K7 f32 at 2e-4 x max, bf16 at 0.05, int8 at
   the JAX package's PTQ bounds 0.08 / 0.15), the apply runs' K1 on the FFT
   kernel; one more int8 clip profiled (K1's and K8's device time a clip);
   then the bf16 batch-8 train
   step with ``qconv_impl='pallas'`` (K7 forward and dx) beside ``'xla'``,
   in turns, with ms per step and peak device memory, both profiled;
8. front-end variants: (a) ``serve(..., smallcin_impl='wide')`` (stage 1 on
   K2w, the wide pack) beside 'thin' on the flagship in bf16, in turns, 3
   requests of 4 one-minute clips each: K2w at one launch per 'wide' request
   and K2 at none, clip 0 against the float32 plain path; then a window of
   HOST_WINDOW requests of each, in turns, as audio-hours/s, and one
   profiled request of each with K2w's and K2's device time read out; (b)
   ``fused_infer`` on the full-width R-domain config
   (``config/SELD-TCN-S1-PHI_8ch.txt``) with 10 and 12 input channels (stage
   1 on K2w, then on K10b), float32 at batch 2, each against its plain
   ``model(x)``; (c) ``python -m seld_tpu_torch.profile_stages`` at
   PROF_BATCH=4 over every section: every row timed, K2w, K10a (its patch
   kernel and its product) and K10b launched;
9. shipped configurations: (a) ``config/DQSELD-TCN-S1-PHI_micAMagPhaseParallelmicBMagPhase.txt``
   (two DQ trunks on each microphone's magnitude + phase channels) at full
   width in bf16 through ``serve(..., phase=True)``: REQUESTS requests of
   CLIPS_PER_REQUEST one-minute 8-channel clips, K2 once and K3 twice a
   trunk, K4 once a trunk and no K1 a request, clip 0 against the float32
   plain ``model(x)`` on the same float32 features, the wall per request,
   the featurizer's device time and one profiled request; (b)
   ``config/DQSELD-TCN-S1-PHI_16chMagPhase.txt`` through ``fused_infer`` in
   float32 at batch 2 (against its plain ``model(x)`` within F32_TOL x max)
   and bf16 at batch 4, stage 1 on K3 (3 launches, K2 none), and K3 alone at
   that stage (Cin 16, F 256, pf 8) in both dtypes against its plain version
   beside cuDNN; (c) the flagship with ``use_se_block=True`` in bf16 through
   ``serve``, the same launches as without SE, clip 0 against float32 plain;
   (d) MagPhase-Parallel training in bf16 at batch 4 under pallas-ct: one
   warm-up and CONFIGS_STEPS timed steps, K5's passes twice, K9's four
   times, K4 and K6 twice a step, finite losses and both trunks' parameters
   moved, then one float32 batch-1 step on the ct and the plain path, losses
   within TRAIN_LOSS_TOL; (e) the predict CLI on MagPhase-Parallel (seeded
   random init) over one clip, ``auto`` (fused bf16: K2, K3 per trunk, no K1)
   and ``--impl apply`` (float32), valid CSVs within MAIN_TOL of each other;
   then K5's B1 at the flagship's stage 1, batches 2 and 8, both dtypes, in
   device time beside its byte bound (``k5_b1_device_times``);
10. checkpoints from outside the port, on the flagship at full width: phase
   6's model directory after two epochs and phase 7's served checkpoint
   rewritten in the JAX package's format (``write_seld_tpu_checkpoint``: a
   pickle naming the JAX classes, written without JAX; the latest read back
   through the port's restricted reader bit for bit); the predict CLI with
   the rewritten file over phase 7's clips on the fused bf16 path, its CSVs
   equal to phase 7's bit for bit; then three copies of the model directory
   (the port's files, the rewritten ones, and the rewritten ones with the
   latest checkpoint's Adam moments zeroed, a control) each resumed for a
   third epoch through the train CLI at once (pallas-ct, bf16, dropout
   off): "Resuming from" in each format, the step count and the schedule
   continued, the pallas-ct kernels in every step, and the rewritten file's
   train loss within RESUME_TOL of the port file's, the control's distance
   printed beside; the JSON's ``checkpoints`` path;
11. training from a ``.seldpak`` file and across processes: (a) phase 6's
   six pickles packed by the port's ``pack_dataset`` and every tensor read
   back bit for bit, the C++ gather against its numpy plain version on
   shuffled batches, both timed; (b) the train CLI one epoch from the file
   (pallas-ct, bf16, batch 8), its losses within PAK_LOSS_TOL of phase 6's
   first epoch from the pickles, its launches as phase 6's; (c) two ranks
   (``--dp-rank``, two processes on the one card over gloo: NCCL takes one
   rank a device; also over nccl where two cards are visible) of two float32
   pallas-ct steps at a global batch of 4, 2 a rank, with K5's and K9's F1 /
   B1 sums and the TCN's BN statistics all-reduced: both ranks' losses and
   averaged gradients bit for bit alike, each rank's K5 / K9 launches and
   all-reduces printed and checked, and the loss and every parameter's
   gradient at each step no further from the float64 plain path than
   max(TRAIN_GRAD_TOL, CONTROL_FACTOR x) one process's float32 step at
   batch 4 (phase 5a's measure); the JSON's ``training entry, .seldpak``
   and ``two ranks, pallas-ct f32`` paths.

Every torch.profiler capture goes through
``seld_tpu_torch.utils.profiling.device_events``: a capture whose first or
last kernel is not one of its bracket kernels is taken again with twice the
leading brackets (the profiler left out the first kernels of every capture
for stretches of some runs), at most CAPTURE_TRIES times; the count taken
again is printed before the kernels' line.

``python3 chip_smoke.py --parallel`` runs phases 1 and 2, a one-epoch
stand-in for phase 6 and phase 11 alone; on a host with several cards
phase 11 adds its nccl legs: (c) one rank a card, and (d) the train CLI
as one nccl rank a card from the .seldpak beside one process.

``python3 chip_smoke.py --k9-route [DIR]`` runs phase 1 and phase 3's K9
B1 / g_z timing alone (``k9_route_times``) on the package of DIR, an
unpacked ``git archive`` of another commit, or of this checkout.

The line before the last is the card (``nvidia-smi``'s name and power limit);
the one before that is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero, prints no
result, and prints its reason to both standard output and standard error.
Needs one CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, NamedTuple

ROOT = Path(__file__).resolve().parent
FLAGSHIP_CONFIG = ROOT / "config" / "DQSELD-TCN-S1-PHI_8ch.txt"
SR, CLIP_SECONDS, CHANNELS = 32000, 60, 8
REQUESTS, CLIPS_PER_REQUEST = 3, 4
F32_TOL = 2e-4    # x max|ref|: float32 sums in another order (TF32 off)
BF16_TOL = 2e-2   # x max|ref|: ~2.5 bf16 ulps (the plain versions round elsewhere)
MAIN_TOL = 0.05   # bf16 serving vs the float32 plain path, on sigmoid/tanh outputs
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 5
TRAIN_LOSS_TOL = 1e-4   # relative: f32 kernel path vs plain path, one step
TRAIN_GRAD_TOL = 1e-3   # relative norm of each parameter's gradient from float64, or
CONTROL_FACTOR = 2.0    # within this factor of the plain path's with float64 BN statistics
F64_FACTOR = 4.0   # a split-TF32 kernel's max|d| from float64, at most this x the float32 plain's
# the card's published peaks (H100 SXM data sheet, dense): bf16 tensor cores,
# float32 outside them, and the HBM rate; a kernel's bound is the larger of
# its operations over the peak for its input type and its bytes over HBM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12

SERVING_KERNELS = {  # launch-count name -> (source in the repo, TPU kernel it replaces)
    "stft_mag": ("seld_tpu_torch/csrc/stft_mag.cu",
                 "seld_tpu/ops/pallas/stft.py:322"),
    "conv3x3_smallcin": ("seld_tpu_torch/csrc/conv3x3_bn_relu_fpool.cu",
                         "seld_tpu/ops/pallas/conv2d_pool.py:619"),
    "conv3x3_widecin": ("seld_tpu_torch/csrc/conv3x3_bn_relu_fpool.cu",
                        "seld_tpu/ops/pallas/conv2d_pool.py:890"),
    "flash_attn_fwd": ("seld_tpu_torch/csrc/flash_attn_fwd.cu",
                       "seld_tpu/ops/pallas/attention.py:298"),
}
TRAINING_KERNELS = {  # K5's bf16 passes, K6; the training path runs K4 too
    "conv_train_stats": ("seld_tpu_torch/csrc/conv3x3_train.cu",
                         "seld_tpu/ops/pallas/conv2d_train.py:138"),
    # K5's bf16 F2 is K3's tile through K10b's entry, fed the batch-statistics
    # affine: its launches are counted as conv3x3_windows' (COUNTED_AS); in
    # float32 it is K2's smallcin kernel
    "conv_train_fwd": ("seld_tpu_torch/csrc/conv3x3_windows.cu",
                       "seld_tpu/ops/pallas/conv2d_pool.py:575"),
    "conv_train_sel_stats": ("seld_tpu_torch/csrc/conv3x3_train.cu",
                             "seld_tpu/ops/pallas/conv2d_train.py:248"),
    # B2 of the TPU kernel is two kernels in bf16: g_z, written once, and the dW tile
    "conv_train_gz": ("seld_tpu_torch/csrc/conv3x3_train.cu",
                      "seld_tpu/ops/pallas/conv2d_train.py:195"),
    "conv_train_dw": ("seld_tpu_torch/csrc/conv3x3_train.cu",
                      "seld_tpu/ops/pallas/conv2d_train.py:195"),
    "flash_attn_bwd": ("seld_tpu_torch/csrc/flash_attn_bwd.cu",
                       "seld_tpu/ops/pallas/attention.py:203"),
}
KERNELS = {**SERVING_KERNELS, **TRAINING_KERNELS}
CT_TRAIN_KERNELS = {  # K9's passes, on the pallas-ct training path (phase 6)
    "ct_train_stats": ("seld_tpu_torch/csrc/conv3x3_ct_train.cu",
                       "seld_tpu/ops/pallas/conv2d_ct_train.py:121"),
    # K9's F2 is K3's widecin kernel fed the batch-statistics affine
    "ct_train_fwd": ("seld_tpu_torch/csrc/conv3x3_bn_relu_fpool.cu",
                     "seld_tpu/ops/pallas/conv2d_ct_train.py:139"),
    "ct_train_sel_stats": ("seld_tpu_torch/csrc/conv3x3_ct_train.cu",
                           "seld_tpu/ops/pallas/conv2d_ct_train.py:152"),
    # B2 of the TPU kernel is two kernels here: g_z, written once, and dW
    "ct_train_gz": ("seld_tpu_torch/csrc/conv3x3_ct_train.cu",
                    "seld_tpu/ops/pallas/conv2d_ct_train.py:174"),
    "ct_train_dw": ("seld_tpu_torch/csrc/conv3x3_ct_train.cu",
                    "seld_tpu/ops/pallas/conv2d_ct_train.py:174"),
    "ct_train_dx": ("seld_tpu_torch/csrc/conv3x3_ct_train.cu",
                    "seld_tpu/ops/pallas/conv2d_ct_train.py:208"),
}
KERNELS = {**KERNELS, **CT_TRAIN_KERNELS}
PREDICT_KERNELS = {  # the predict CLI's apply path: qconv_impl 'pallas' (K7) and 'int8' (K8)
    "hamilton_matmul": ("seld_tpu_torch/csrc/hamilton_matmul.cu",
                        "seld_tpu/ops/pallas/qmatmul.py:95"),
    "int8_matmul": ("seld_tpu_torch/csrc/int8_matmul.cu", "seld_tpu/ops/pallas/quant.py:56"),
    # K1's float32 output (the apply path's featurizer): the FFT kernel, its
    # launches counted as stft_mag_fft (COUNTED_AS)
    "stft_mag_f32": ("seld_tpu_torch/csrc/stft_mag.cu", "seld_tpu/ops/pallas/stft.py:322"),
}
KERNELS = {**KERNELS, **PREDICT_KERNELS}
FRONTEND_KERNELS = {  # phase 8: the serving stage's other packs and the profiler's kernels
    "conv3x3_smallcin_wide": ("seld_tpu_torch/csrc/conv3x3_smallcin_wide.cu",
                              "seld_tpu/ops/pallas/conv2d_pool.py:363"),
    "conv3x3_im2col": ("seld_tpu_torch/csrc/conv3x3_im2col.cu",
                       "seld_tpu/ops/pallas/conv2d_pool.py:100"),
    # K10a's patches, built in XLA around the TPU kernel (conv2d_pool.py:129-138):
    # one CUDA pass here, since the torch build took longer than the product; its
    # launches are those of the profiler's K10a rows, not of its rows that time
    # the patches alone
    "im2col_patches": ("seld_tpu_torch/csrc/conv3x3_im2col.cu",
                       "seld_tpu/ops/pallas/conv2d_pool.py:129"),
    "conv3x3_windows": ("seld_tpu_torch/csrc/conv3x3_windows.cu",
                        "seld_tpu/ops/pallas/conv2d_pool.py:749"),
}
KERNELS = {**KERNELS, **FRONTEND_KERNELS}
COUNTED_AS = {"conv_train_fwd": "conv3x3_windows",   # summary row -> launch-count name
              "ct_train_fwd": "conv3x3_widecin", "stft_mag_f32": "stft_mag_fft"}
TRAINING_PATH = [*(COUNTED_AS.get(n, n) for n in TRAINING_KERNELS), "flash_attn_fwd"]
# the float32 step (phase 5a): K5's passes with F2 on K2's kernel, then K4 and K6
TRAINING_PATH_F32 = [{"conv3x3_windows": "conv3x3_smallcin"}.get(n, n) for n in TRAINING_PATH]
# launches per pallas-ct training step: K5's passes once (F2 is conv3x3_windows),
# K9's twice (stages 2 and 3; F2 is conv3x3_widecin), K4 and K6 at least once
CT_PER_STEP = {**{COUNTED_AS.get(n, n): 1 for n in TRAINING_KERNELS if n != "flash_attn_bwd"},
               **{COUNTED_AS.get(n, n): 2 for n in CT_TRAIN_KERNELS}}
CT_AT_LEAST = ("flash_attn_fwd", "flash_attn_bwd")
CT_BATCH, CT_CLIPS = 8, {"train": 16, "validation": 4, "test": 4}
CT_STEPS_TIMED = 5
# events in half the label slots: an untrained model's tests then score a
# Global SELD below 1, the trainer's first best-on-test bar (reference
# train.py:658), so every checkpoint role is written
CT_SED_RATE = 0.5
PREDICT_DIR = ROOT / "chip_tmp" / "predict"   # phase 6 leaves its best checkpoint here
PREDICT_CLIPS = 3
# a clip through the fused bf16 predict path: K1, K2, K3 at stages 2-3, K4
FUSED_PER_CLIP = {"stft_mag": 1, "conv3x3_smallcin": 1, "conv3x3_widecin": 2,
                  "flash_attn_fwd": 1}
# Hamilton matmuls per flagship forward: 10 ResBlocks x (skip, res) + 2 FC heads;
# a train step's backward runs K7 for dx on all but the last ResBlock's res conv,
# whose output feeds nothing (autograd never reaches it)
QMM_PER_FORWARD, QMM_DX_PER_STEP = 22, 21
PTQ_TOL = {"sed": 0.08, "doa": 0.15}   # the JAX package's int8 bounds (tests/test_pallas.py)
PREDICT_STEPS_TIMED = 3
# the bfloat16 tensor-core kernels (mangled-name stems): the conv tile's K3 / K10b,
# K9 F1 and dh bodies and K5's F1 and g_z bodies, the dW tile (K9's 32-channel Cin
# tile, K5's 16-channel one), K4's forward, K6's two backward passes (and the
# three at head dims past 128, in column groups: WIDE_ATTN_KERNELS), K7, K1's
# bf16-output GEMM, K2's bf16 stage 1, the GEMM tile of K10a and K2w, and K8's
# int8 GEMM (IMMA); and the float32 kernels of K4, K6 (and their three past head
# dim 128, in column groups: WIDE_TF32_ATTN_KERNELS), K7, the dW tile and the GEMM
# tile of K2w and K10a, the conv block tile of K3 / K10b / K9's F2, K9's F1 and
# K9's dh, and the float smallcin tile of K2 / K5's F2, K5's F1 and K5's g_z pass
# in split TF32 (TF32_KERNELS: HMMA.1688.F32.TF32, three products a float32
# product; the dW tile's 32-channel Cin tile is K9's, its 16- and 8-channel ones
# K5's; K2w's instances walk 8-32 pack rows)
WIDE_ATTN_KERNELS = ("flash_fwd_wide_tc_kernel", "flash_dq_wide_tc_kernel",
                     "flash_dkv_wide_tc_kernel")
WIDE_TF32_ATTN_KERNELS = ("flash_fwd_wide_tf32_kernel", "flash_dq_wide_tf32_kernel",
                          "flash_dkv_wide_tf32_kernel")
TF32_KERNELS = ("flash_fwd_tf32_kernel", "flash_dq_tf32_kernel", "flash_dkv_tf32_kernel",
                *WIDE_TF32_ATTN_KERNELS, "hamilton_tf32_kernel", "ct_dw_tf32_kernelILi32E",
                "ct_dw_tf32_kernelILi16E", "ct_dw_tf32_kernelILi8E", "smallcin_wide_tf32_kernel",
                "im2col_tf32_kernel", "conv3x3_tf32_kernel", "ct_stats_tf32_kernel",
                "ct_dx_tf32_kernel", "smallcin_tf32_kernel", "train_stats_tf32_kernel",
                "train_gz_tf32_kernel")
TC_KERNELS = ("conv3x3_tc_kernel", "ct_stats_tc_kernel", "ct_dx_tc_kernel",
              "train_stats_tc_kernel", "train_gz_tc_kernel", "ct_dw_tc_kernelILi32E",
              "ct_dw_tc_kernelILi16E", "flash_fwd_tc_kernel", "flash_dq_tc_kernel",
              "flash_dkv_tc_kernel", *WIDE_ATTN_KERNELS, "hamilton_tc_kernel", "stft_mag_tc_kernel",
              "smallcin_tc_kernel", "im2col_tc_kernel", "smallcin_wide_tc_kernel",
              "int8_matmul_tc_kernel", *TF32_KERNELS)
# K9's B1 and g_z: the streaming walker (route_walk), two instances a dtype
# (two quads a lane at pf <= 4, one above); phase 2 prints their registers
# and fails on a spill
ROUTE_KERNELS = ("ct_route_stats_kernel", "ct_route_gz_kernel")
# bf16 and TF32 (HMMA, HGMMA) and int8 (IMMA) products
TC_OPS = re.compile(r"\b(?:HG?MMA|IMMA)\b")
# device kernels read out of the step profiles (phases 5a, 5b, 6 and 7), by
# demangled name, each stem anchored at the start of a name (watched(): a stem
# never matches inside a longer name, so no kernel counts in two groups): K4's
# and K6's launches (bf16, or float32 in phase 5a's profiled float32 step),
# K9's and K5's dW (K5's B2: the g_z pass and the dW tile; their reductions
# share reduce_kernel with other passes), K5's F1, K9's B1 and g_z (the
# streaming walker, both dtypes) and K7
PROFILE_WATCH = {"K4": ("flash_fwd_tc_kernel", "flash_fwd_tf32_kernel"),
                 "K6": ("delta_kernel", "flash_dq_tc_kernel", "flash_dkv_tc_kernel",
                        "flash_dq_tf32_kernel", "flash_dkv_tf32_kernel"),
                 "K9 dW": ("ct_dw_tc_kernel<32>", "ct_dw_tf32_kernel<32>"),
                 "K5 dW": ("train_gz_tc_kernel", "ct_dw_tc_kernel<16>"),
                 "K5 F1": ("train_stats_tc_kernel",),
                 "K9 B1": ("ct_route_stats_kernel<",), "K9 g_z": ("ct_route_gz_kernel<",),
                 "K7": ("hamilton_tc_kernel", "hamilton_tf32_kernel")}
# the profiled float32 steps of phase 5a: K5's passes apart (F1, F2 = K2's
# kernel and the g_z pass on the float smallcin tile, B1, the split-TF32 dW
# tile), K4, K6 and K9's F1, F2, B1, g_z and dx and dW in the pallas-ct step
F32_STEP_WATCH = {"K5 F1": ("train_stats_tf32_kernel<",),
                  "K5 F2": ("smallcin_tf32_kernel<",),
                  "K5 B1": ("sel_stats_kernel<float>",), "K5 g_z": ("train_gz_tf32_kernel<",),
                  "K5 dW": ("ct_dw_tf32_kernel<8>",),
                  **{k: PROFILE_WATCH[k] for k in ("K4", "K6", "K9 dW", "K9 B1", "K9 g_z")},
                  "K9 F1": ("ct_stats_tf32_kernel",), "K9 F2": ("conv3x3_tf32_kernel",),
                  "K9 dx": ("ct_dx_tf32_kernel",)}
# device kernels read out of the serving profiles (phase 4), by demangled name
SERVING_WATCH = {"K1": ("stft_mag_tc_kernel",), "K2": ("smallcin_tc_kernel",),
                 "K3": ("conv3x3_tc_kernel",), "K4": ("flash_fwd_tc_kernel",)}
R_CONFIG = ROOT / "config" / "SELD-TCN-S1-PHI_8ch.txt"   # R domain, CNN 64 / 64 / 64
PROFILE_BATCH = 4
# (B, Cin, F, T, Cout, pf) of the conv tile's ragged checks: Cin chunks ragged
# (12, 24, 40, 200 against 8 in float32 and 16 in bfloat16), Cout tiles ragged
# against 64 (72, 80, 100, 200), frame tiles ragged (65, 129 and 257 one past a
# multiple of the bf16 block tile's 64 frames, kTbT; 300; 296 stages x by 16-byte
# loads, T % 8 == 0), pf 1-8: the block tile's 4 row slots in passes (pf 8),
# 4 / pf windows a block (pf 1, 2), a short last pass (pf 3, 5), F not a
# multiple of 4 (dh)
TILE_CASES = [(2, 12, 24, 300, 80, 8), (1, 24, 16, 129, 200, 4), (2, 200, 8, 300, 80, 2),
              (1, 24, 12, 296, 200, 2), (2, 12, 16, 129, 80, 4), (1, 40, 12, 65, 72, 3),
              (2, 16, 10, 257, 100, 5), (1, 24, 6, 257, 64, 1)]
# K1's float32 FFT kernel beside the flagship's nperseg 512: (audio shape, nperseg,
# noverlap, audio dtype) at nperseg 64, 256, 1024 and 2048, frames ragged against
# the block's 2048 / (nperseg / 2) frames, odd n, an odd hop (no pair loads), bf16
# audio; nperseg 480 stays on the SIMT DFT (route checked)
STFT_FFT_CASES = [((2, 30_001), 64, 16, "float32"), ((3, 40_003), 256, 128, "float32"),
                  ((2, 100_700), 1024, 512, "float32"), ((2, 100_999), 2048, 1024, "float32"),
                  ((3, 120_000), 512, 112, "bfloat16"), ((2, 50_001), 512, 113, "float32")]
# K8's row tiles, each forced by setting quant.ROW_TILES: held to the
# wrapper's bits, and timed in turns at the M of a predict clip's head calls
# (600), the flagship's batch-2 heads (1200), a clip's TCN (4800) and batch 2
# (9600); the wrapper's rule takes 32 rows at the first two, 64 at the others
K8_TILES = {"64-row": (64,), "32-row": (32,)}
K8_AB_M = (600, 1200, 4800, 9600)
# K1's bf16 kernel: (audio shape, nperseg, noverlap, audio dtype). Frames ragged
# against its 256-frame tiles (300, 293, 250, 325 frames); bins ragged against 64
# (240, 244; 244 % 8 != 0 writes element by element); nperseg 488 ragged against
# its 32-tap chunks; n % 4 != 0 gathers element by element; bf16 audio; 40 rows
# leave one frame split per (bin tile, row), so each block walks two frame tiles
STFT_TC_CASES = [((3, 120_000), 512, 112, "float32"), ((2, 117_123), 480, 80, "float32"),
                 ((2, 100_000), 488, 88, "float32"), ((3, 120_000), 512, 112, "bfloat16"),
                 ((2, 100_003), 488, 88, "bfloat16"), ((40, 130_000), 512, 112, "float32")]
# K2's bf16 kernel: (B, Cin, F, T, Cout, pf) at Cin 5 and 8, Cout tiles ragged (80,
# 200), frame tiles ragged (129, 300; 296 stages x by 16-byte loads), pf 2 and 8,
# pf 80, the most one halo staging holds (conv2d_pool.smallcin_max_pool_f), and
# pf 256, all of F in chunks of 80 rows
SMALLCIN_TC_CASES = [(2, 5, 24, 300, 80, 8), (2, 8, 16, 296, 200, 2), (1, 8, 16, 129, 200, 8),
                     (2, 5, 8, 129, 80, 2), (1, 8, 32, 300, 200, 8), (2, 5, 16, 296, 80, 8),
                     (1, 3, 80, 300, 72, 80), (1, 8, 256, 300, 80, 256)]
SERVE_ON_CARD_BATCHES = (4, 16)   # the serving forward with the audio already on the card
CARD_WINDOW = 100   # timed requests per batch with the audio on the card
HOST_WINDOW = 30    # timed requests from host memory (phase 4; phase 8a: each variant)
PROFILE_SECTIONS = "stft,cnn,tcn,fused,qmm,attn,f32,v3"
# phase 9: the shipped magnitude + phase configs (DQ trunks, 16 feature channels
# from 8-channel audio) and the kernels on their paths
MAGPHASE_CONFIG = ROOT / "config" / "DQSELD-TCN-S1-PHI_micAMagPhaseParallelmicBMagPhase.txt"
MAG16_CONFIG = ROOT / "config" / "DQSELD-TCN-S1-PHI_16chMagPhase.txt"
CONFIG_KERNELS = {name: KERNELS[name] for name in (
    "conv3x3_smallcin", "conv3x3_widecin", "flash_attn_fwd", *TRAINING_KERNELS,
    *CT_TRAIN_KERNELS)}
# a MagPhase-Parallel request (two trunks): K2 once and K3 twice a trunk, K4 once
# a trunk, no K1 (phase configs featurize in plain torch, as the JAX package does)
MAGPHASE_PER_REQUEST = {"conv3x3_smallcin": 2, "conv3x3_widecin": 4, "flash_attn_fwd": 2}
# a MagPhase-Parallel pallas-ct step: K5's passes once a trunk, K9's at stages 2-3
# of each trunk (F2 counted as K3's), K4 and K6 once a trunk
MAGPHASE_PER_STEP = {**{COUNTED_AS.get(n, n): 2 for n in TRAINING_KERNELS},
                     **{COUNTED_AS.get(n, n): 4 for n in CT_TRAIN_KERNELS}, "flash_attn_fwd": 2}
CONFIGS_STEPS = 3
CONFIGS_PREDICT_DIR = ROOT / "chip_tmp" / "predict_configs"
K3_CIN16 = (2, 16, 256, 4800, 192, 8)   # K3 at the 16chMagPhase config's stage 1
K3_CIN16_ROWS = {}   # dtype -> K3's numbers there (phase 9), in the JSON as "stage1_cin16"
# phase 10: checkpoints from outside the port. Phase 6 leaves its dataset and its
# model directory after two epochs here, and its CLI overrides and the model
# directory's path in a run directory in the fixture dict main() passes along;
# phase 7 its clips (PREDICT_DIR) and its fused run's outputs (the fixture's
# "fused")
CHECKPOINTS_DIR = ROOT / "chip_tmp" / "checkpoints"
CHECKPOINT_KERNELS = {name: KERNELS[name] for name in (
    *SERVING_KERNELS, *TRAINING_KERNELS, *CT_TRAIN_KERNELS)}
RESUME_TOL = 1e-4   # relative: epoch 3's train loss resumed from the seld_tpu file vs the port's
RESUME_FLAGS = ["--dropout_perc=0", "--spatial_dropout_rate=0"]
# phase 11: training from a .seldpak file and across processes. Phase 6's dataset
# packed into one container (under CHECKPOINTS_DIR, removed at the end); the
# train CLI from it; then DP_RANKS ranks of one float32 pallas-ct step on the
# card (gloo: NCCL takes one rank a device) at a global batch of DP_BATCH
DP_RANKS, DP_BATCH, DP_STEPS = 2, 4, 2
DP_TIMEOUT_S = 600
PAK_LOSS_TOL = 1e-2   # relative: epoch 1's losses from the .seldpak vs phase 6's from pickles
PAK_GATHER_BATCHES = 20   # timed C++ / numpy gathers of CT_BATCH clips
# the float32 pallas-ct step's kernels: K5's passes (F2 on K2's kernel,
# conv3x3_smallcin), K9's (F2 counted as conv3x3_widecin), K4 and K6
PARALLEL_KERNELS = {name: KERNELS[name] for name in (
    "conv_train_stats", "conv3x3_smallcin", "conv_train_sel_stats", "conv_train_gz",
    "conv_train_dw", *CT_TRAIN_KERNELS, "flash_attn_fwd", "flash_attn_bwd")}
# the all-reduces of one rank's step: K5's F1 and B1 sums, K9's at stages 2-3, the
# TCN's 30 BatchNorms (10 ResBlocks x 3) forward and backward, the gradients once
DP_REDUCES_PER_STEP = {"K5 F1": 1, "K5 B1": 1, "K9 F1": 2, "K9 B1": 2, "BN": 30,
                       "BN grad": 30, "grads": 1}


PTXAS = {}   # kernel -> ptxas' registers, shared memory and spills (phase 2)
F32_ROWS = {}   # summary name -> {tag: the [f32] line's numbers} (phase 3), in the JSON as "f32"
# K4 / K6 timed beside SDPA at the flagship's attention shape (B 2, T 2400, 8 heads):
# the flagship's D 48, then head dims past 128 in one, two and three column groups
PAST_128_DIMS = (48, 160, 192, 256, 320, 640)


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


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


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


def kernel_name(mangled: str) -> str:
    """"<kernel>I<template args>" of a mangled kernel symbol."""
    m = re.search(r"\d+(\w+?_kernel)(I\w+?EE)?", mangled.split("_GLOBAL__N_")[-1])
    return m.group(0) if m else mangled


def phase_build() -> None:
    """Build (or load) the kernels; print ptxas' registers, shared memory and
    spills per kernel, and the tensor-core instructions (HMMA / HGMMA, IMMA
    for int8) in the SASS of each tensor-core kernel (TC_KERNELS), failing if
    one has none."""
    from seld_tpu_torch import _build

    nvcc = _build.find_nvcc()
    path = _build.library_path(nvcc)
    prebuilt = path.exists()
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] kernels {'loaded' if prebuilt else 'built with nvcc and loaded'} "
          f"in {time.perf_counter() - t0:.1f} s: {path.name}")
    log = path.with_suffix(".log")   # nvcc's command line and ptxas' report
    ptxas = PTXAS
    if log.exists():
        entry, spill = "?", ""
        for line in log.read_text().splitlines():   # ptxas -v: entry, spills, registers
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1])
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                ptxas[entry] = f"{line.split(':', 1)[1].strip()}; {spill}"
                print(f"[build] {entry}: {ptxas[entry]}")
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    mma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_name(line.split("Function :")[1].strip())
            mma[fn] = 0
        elif fn is not None and TC_OPS.search(line):
            mma[fn] += 1
    tiles = {fn: n for fn, n in mma.items() if any(k in fn for k in TC_KERNELS)}
    for fn, n in sorted(tiles.items()):
        print(f"[build] tensor cores: {fn}: {n} HMMA/HGMMA/IMMA in its SASS; ptxas: "
              f"{ptxas.get(fn, '?')}")
    found = {k for k in TC_KERNELS if any(k in fn for fn in tiles)}
    require(found == set(TC_KERNELS), f"tensor-core kernels missing from the SASS: "
            f"{set(TC_KERNELS) - found}")
    require(all(tiles.values()), f"tensor-core kernels without tensor-core instructions: "
            f"{[fn for fn, n in tiles.items() if not n]}")
    # the attention kernels past head dim 128 and the split-TF32 kernels keep
    # every accumulator in registers, K9's walker its rows
    for fn, r in sorted(ptxas.items()):
        if any(k in fn for k in ROUTE_KERNELS):
            print(f"[build] K9 B1 / g_z walker: {fn}: ptxas: {r}")
    for group, what in ((WIDE_ATTN_KERNELS, "attention kernels past head dim 128"),
                        (TF32_KERNELS, "split-TF32 kernels"),
                        (ROUTE_KERNELS, "K9's B1 / g_z walker kernels")):
        regs = {fn: r for fn, r in ptxas.items() if any(k in fn for k in group)}
        require(regs and all(re.search(r"\b0 bytes spill stores", r) for r in regs.values()),
                f"{what} spill or are missing: {regs}")


def bound(flops: float, nbytes: float, dtype_name: str) -> tuple[float, str]:
    """(least ms the card could take, 'operations' or 'bytes'): the larger of
    flops over the peak for the input type and bytes over the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def f32_row(card: str, name: str, tag: str, kernel_ms: float, library_ms: float | None,
            flops: float, moved: float, split_tf32: bool = False) -> None:
    """One float32 flagship instance beside its library call in float32 (TF32
    off, ``seld_tpu_torch.disable_tf32``), where one computes the same
    function, and its float32 bound (67 TFLOP/s outside the tensor cores, or
    bytes), marked where the kernel loses; a split-TF32 kernel also beside
    the bound of its three TF32 products."""
    bound_ms, bound_by = bound(flops, moved, "float32")
    row = {"ms": kernel_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    extra = ""
    if split_tf32:
        row["tf32x3_bound_ms"] = bound(3 * flops, moved, "tf32")[0]
        extra = f", three TF32 products' bound {row['tf32x3_bound_ms']:.4f} ms"
    lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
    loses = library_ms is not None and kernel_ms > library_ms
    print(f"[f32] {name} {tag}: kernel {kernel_ms:.3f} ms, library {lib}, bound "
          f"{bound_ms:.4f} ms by {bound_by}{extra}{', loses' if loses else ''} ({card})")
    F32_ROWS.setdefault(name, {})[tag] = row


def f64_gate(card: str, name: str, tag: str, got, plain, exact, library=None) -> None:
    """A float32 kernel's output and its float32 plain version's (TF32 off),
    each against the plain version in float64 on the same inputs (max|d|),
    printed as an ``[f32]`` line with the library call's distance where one
    is given; the kernel within F64_FACTOR x the plain version's distance
    (the split-TF32 kernels' precision gate)."""
    dist = lambda u: (u.double() - exact).abs().max().item()
    d_k, d_p = dist(got), dist(plain)
    row = {"kernel": d_k, "plain": d_p}
    lib = ""
    if library is not None:
        row["library"] = dist(library)
        lib = f", library {row['library']:.3e}"
    print(f"[f32] {name} {tag}: max|d| from float64 kernel {d_k:.3e}, float32 plain {d_p:.3e} "
          f"({d_k / max(d_p, 1e-300):.2f}x; gate {F64_FACTOR:g}x){lib}, max|ref| "
          f"{exact.abs().max().item():.3e} ({card})")
    F32_ROWS.setdefault(name, {}).setdefault(tag, {})["f64_dist"] = row
    require(d_k <= F64_FACTOR * d_p, f"{name} {tag}: {d_k:.3e} from float64, over "
            f"{F64_FACTOR:g} x the float32 plain version's {d_p:.3e}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_ms(torch, fn, warmup: int = 2, iters: int = 10, before=None) -> float:
    """Median milliseconds of fn() over iters launches, CUDA events; ``before``
    (an L2 flush) runs ahead of each, outside the events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(torch, fn, iters: int = 20) -> float:
    """Milliseconds per fn() call over ``iters`` back-to-back calls between two
    CUDA events: the device's time where a call's kernels outlast its host
    path (K1, K2, K3 at the flagship's shapes). The profiler's sums lost some
    of K1's launches in some runs of this script; these events lose none."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device milliseconds per fn() call: the self device time of every kernel
    it launches, from torch.profiler over iters calls (no host time; the
    event timings of time_ms include the host's launch path where it is the
    longer)."""
    return sum(device_split(torch, fn, iters).values())


def device_split(torch, fn, iters: int = 20) -> dict:
    """device_ms by kernel: {profiler name: device ms per fn() call}."""
    from seld_tpu_torch.utils.profiling import device_events

    fn()
    events, _ = device_events(lambda: [fn() for _ in range(iters)])
    return {e.key: e.self_device_time_total / 1e3 / iters for e in events}


def int8_matmul_tiles(k8, tiles, *args):
    """K8's wrapper with ``k8.ROW_TILES`` set to ``tiles`` for the call."""
    saved = k8.ROW_TILES
    k8.ROW_TILES = tiles
    try:
        return k8.int8_matmul(*args)
    finally:
        k8.ROW_TILES = saved


def launched_kernels(torch, fn) -> list:
    """The device kernels one fn() call launches, by the profiler's name."""
    from seld_tpu_torch.utils.profiling import device_events

    fn()
    return [e.key for e in device_events(fn)[0]]


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
    from seld_tpu_torch.models.attention import attend_full
    from seld_tpu_torch.ops.kernels import launch_counts
    from seld_tpu_torch.ops.kernels.attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_plain,
        flash_attention_train, head_dim_plan,
    )
    from seld_tpu_torch.ops.kernels.conv2d_pool import (
        conv2d_bn_relu_fpool, conv2d_bn_relu_fpool_plain, conv2d_smallcin_bn_relu_fpool,
        conv2d_windows_bn_relu_fpool,
    )
    from seld_tpu_torch.ops.kernels.stft import stft_mag, stft_mag_plain, stft_route

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    summary, past_128 = {}, {}

    def record(name, d, timed, flops, moved, dtype_name, library_ms=None, **extra):
        """The JSON entry of one kernel, from its flagship bf16 run; ``extra``
        keys (parts of ``ms`` timed apart) follow the contract's."""
        bound_ms, bound_by = bound(flops, moved, dtype_name)
        summary[name] = {"max_abs_err": d, "ms": timed[0], "plain_ms": timed[1],
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         **extra}
        print(f"[kernel] {name}: {timed[0]:.3f} ms, plain {timed[1]:.3f} ms, library "
              f"{'none' if library_ms is None else f'{library_ms:.3f} ms'}, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({card})")

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
            fft_before = launch_counts["stft_mag_fft"]
            got = k()
            fft = launch_counts["stft_mag_fft"] - fft_before
            require(fft == (stft_route(nperseg, dt) == "fft"),
                    f"stft_mag {tag} {nperseg} {dt}: {fft} FFT launches, route "
                    f"{stft_route(nperseg, dt)}")
            d = compare(torch, "stft_mag", f"{tag} {stft_route(nperseg, dt)}", got, p(), dt, card,
                        timed)
            # bf16 output: a 512 x 512 DFT product per frame on the tensor cores
            flops = 2.0 * (got.numel() // got.shape[-1]) * nperseg * nperseg
            if tag == "flagship" and dt == torch.bfloat16:
                # the library's |STFT| with K1's window and hop, uncentred (the
                # kernel's zero boundary and its dropped DC bin and last frame aside)
                win = torch.hamming_window(nperseg, periodic=True, device=dev)
                rows = x.reshape(-1, x.shape[-1])
                lib = lambda: torch.stft(rows, nperseg, nperseg - noverlap, window=win,
                                         center=False, return_complex=True).abs()
                lib_ms = time_ms(torch, lib)
                print(f"[kernel] stft_mag bfloat16 back to back: kernel "
                      f"{stream_ms(torch, k):.4f} ms, torch.stft {stream_ms(torch, lib):.4f} ms "
                      f"({card})")
                record("stft_mag", d, timed, flops, nbytes(x, got), "bfloat16", lib_ms)
            elif tag == "flagship":
                # float32 output: the FFT's operations a frame, an M-point complex
                # FFT (5 M log2 M), the window (2 N), the split and |X| (~13 M);
                # the same library call as the bf16 row, against float32 audio
                m_pts = nperseg // 2
                fft_flops = (got.numel() // got.shape[-1]) * (
                    5 * m_pts * (m_pts.bit_length() - 1) + 2 * nperseg + 13 * m_pts)
                # float64 plain DFT on the same audio: the FFT's rounding
                want64 = stft_mag_plain(x.double(), nperseg, noverlap, out_dtype=torch.float64)
                d64 = (got.double() - want64).abs().max().item() / want64.abs().max().item()
                require(d64 <= 1e-5, f"stft_mag f32 flagship: {d64:.2e} x max from float64")
                del want64
                win = torch.hamming_window(nperseg, periodic=True, device=dev)
                rows = x.reshape(-1, x.shape[-1])
                lib = lambda: torch.stft(rows, nperseg, nperseg - noverlap, window=win,
                                         center=False, return_complex=True).abs()
                lib_ms = time_ms(torch, lib)
                k_stream, lib_stream = stream_ms(torch, k), stream_ms(torch, lib)
                print(f"[kernel] stft_mag float32 (FFT) back to back: kernel {k_stream:.4f} ms, "
                      f"torch.stft {lib_stream:.4f} ms; max|d| from float64 {d64:.2e} x max "
                      f"({card})")
                record("stft_mag_f32", d, timed, fft_flops, nbytes(x, got), "float32", lib_ms,
                       stream_ms=k_stream, library_stream_ms=lib_stream)
    for shape, nperseg, noverlap, xdt in STFT_FFT_CASES:   # float32 output, the FFT
        x = randn(*shape).to(getattr(torch, xdt))
        before = launch_counts["stft_mag_fft"]
        got = stft_mag(x, nperseg, noverlap, out_dtype=torch.float32)
        require(launch_counts["stft_mag_fft"] == before + 1, "stft_mag: no FFT launch counted")
        compare(torch, "stft_mag", f"fft {nperseg}", got,
                stft_mag_plain(x, nperseg, noverlap, out_dtype=torch.float32), torch.float32, card)
    for shape, nperseg, noverlap, xdt in STFT_TC_CASES:   # bf16 output only
        x = randn(*shape).to(getattr(torch, xdt))
        before = launch_counts["stft_mag"]
        got = stft_mag(x, nperseg, noverlap, out_dtype=torch.bfloat16)
        require(launch_counts["stft_mag"] == before + 1, "stft_mag: no launch counted")
        compare(torch, "stft_mag", f"tc {nperseg}", got,
                stft_mag_plain(x, nperseg, noverlap, out_dtype=torch.bfloat16),
                torch.bfloat16, card)

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
            got = k()
            d = compare(torch, name, label, got, p(), dt, card, timed)
            if tag == "flagship" and dt == torch.float32:
                # K2 on the float smallcin tile, K3 on the float block tile
                w_nchw = w.permute(3, 2, 0, 1).contiguous()
                f32_row(card, name, label, timed[0],
                        time_ms(torch, lambda: F.conv2d(x, w_nchw, padding=1)),
                        2.0 * 9 * cin * cout * b * f * t, nbytes(x, w, got), split_tf32=True)
                exact = conv2d_bn_relu_fpool_plain(x.double(), w.double(), scale.double(),
                                                   bias.double(), pf)
                f64_gate(card, name, label, got, p(), exact)
                require(torch.equal(k(), got), f"{name} {label} float32: not repeatable")
                del exact
                if name == "conv3x3_smallcin":
                    # one K walk: the smallcin tile's rows are the block tile's (K10b's)
                    k10b = conv2d_windows_bn_relu_fpool(x, w, scale, bias, pf)
                    differ = int((k10b != got).sum())
                    print(f"[kernel] K2 float32 against K10b float32, {label} random inputs: "
                          f"{differ} of {got.numel()} pooled outputs differ")
                    require(differ == 0, f"K2 float32 differs from K10b in {differ} places")
                    del k10b
            # the summary line carries stage 1 (smallcin) and stage 2 (widecin)
            if tag == "flagship" and dt == torch.bfloat16 and f != 4:
                w_nchw = w.permute(3, 2, 0, 1).contiguous()
                lib = lambda: F.conv2d(x, w_nchw, padding=1)
                lib_ms = time_ms(torch, lib)
                print(f"[kernel] {name} {label} bfloat16 back to back: kernel "
                      f"{stream_ms(torch, k):.4f} ms, cuDNN {stream_ms(torch, lib):.4f} ms ({card})")
                record(name, d, timed, 2.0 * 9 * cin * cout * b * f * t,
                       nbytes(x, w, got), "bfloat16", lib_ms)

    for b, cin, f, t, cout, pf in SMALLCIN_TC_CASES:
        x = randn(b, cin, f, t).to(torch.bfloat16)
        w = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(torch.bfloat16)
        scale, bias = randn(cout, scale=0.2) + 1.0, randn(cout, scale=0.2)
        before = launch_counts["conv3x3_smallcin"]
        got = conv2d_smallcin_bn_relu_fpool(x, w, scale, bias, pf)
        require(launch_counts["conv3x3_smallcin"] == before + 1, "K2: no launch counted")
        compare(torch, "conv3x3_smallcin", f"tc pf{pf}", got,
                conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf), torch.bfloat16, card)

    phase_tile(torch, card, randn)

    # ---- K4: q, k, v (B, T, H, D); ragged T = 200 = 3 * 64 + 8 and 130 = 2 * 64 + 2,
    # every head dim the kernel is built for, and 8 and 24 (zero-padded to 16 and 32);
    # past 128 ("sliced", the wide kernels, both dtypes on one plan): D 136 -> 160,
    # 160, 192, 224 and 256 in one column group, 300 -> 320, 320 and 512 in two
    # equal ones, 288 and 480 in two with a narrower last, 640 in three and 1280
    # in five. bfloat16 streams K and V with each tile in the dk/dv pass from 600,
    # Q and dO in the dq pass from 640, Q in the forward at 1280; float32 (split
    # TF32, twice the bytes) streams the backward's pair in chunks from 160, the
    # block's own rows from 192 (dk/dv) and 224 (dq); its forward takes
    # 128-query blocks up to 192 (K and V split at staging at 160), 64 past it,
    # Q streamed from 480; ragged key tiles
    attn_cases = [
        ("ragged", 2, 200, 3, 48),
        ("ragged", 1, 130, 2, 32),
        *(("ragged", b, t, h, d) for t in (130, 200)
          for b, h, d in ((1, 4, 16), (2, 2, 32), (1, 3, 48), (2, 1, 64), (1, 2, 128),
                          (2, 3, 8), (1, 2, 24))),
        ("sliced", 2, 200, 3, 160), ("sliced", 1, 130, 2, 256), ("sliced", 2, 65, 2, 320),
        ("sliced", 2, 65, 3, 136), ("sliced", 1, 130, 2, 192), ("sliced", 2, 200, 2, 224),
        ("sliced", 1, 200, 2, 320), ("sliced", 2, 130, 1, 512), ("sliced", 1, 65, 2, 512),
        ("sliced", 2, 200, 2, 300), ("sliced", 2, 65, 2, 288), ("sliced", 1, 200, 2, 480),
        ("sliced", 2, 130, 1, 640), ("sliced", 1, 65, 1, 1280),
        ("flagship", 2, 2400, 8, 48),
    ]
    for fn, regs in sorted(PTXAS.items()):
        if "wide" in fn and "flash" in fn:
            print(f"[kernel] head dims past 128: {fn}: {regs}")
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
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k_, v))
            if tag == "flagship" and dt == torch.float32:
                f32_row(card, "flash_attn_fwd", tag, timed[0],
                        time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                        4.0 * b * h * t * t * d_head, nbytes(q, k_, v, o, lse),
                        split_tf32=True)
                # the split-TF32 forward against the plain version in float64
                exact = flash_attention_plain(q.double(), k_.double(), v.double(), scale)
                for n, a, w_, e in zip(("out", "lse"), (o, lse), (o_ref, lse_ref), exact):
                    f64_gate(card, "flash_attn_fwd", f"{tag} {n}", a, w_, e)
                del exact
            if tag == "flagship" and dt == torch.bfloat16:
                lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)
                lib_ms = time_ms(torch, lib)
                # the exponentials' floor: one ex2 a score at the MUFU's 16 a clock an
                # SM, at the card's largest SM clock
                clock = max_sm_clock_hz()
                exp_floor = b * h * t * t / (16 * torch.cuda.get_device_properties(0)
                                             .multi_processor_count * clock) * 1e3
                print(f"[kernel] flash_attn_fwd bfloat16 back to back: kernel "
                      f"{stream_ms(torch, kern):.4f} ms, SDPA {stream_ms(torch, lib):.4f} ms; "
                      f"exp floor {exp_floor:.4f} ms at {clock / 1e9:.3f} GHz ({card})")
                record("flash_attn_fwd", d, timed, 4.0 * b * h * t * t * d_head,
                       nbytes(q, k_, v, o, lse), "bfloat16", lib_ms)

            # K6 from the plain forward's (out, lse), against its plain version
            out_r, lse_r = (a.contiguous() for a in (o_ref, lse_ref))
            dout = randn(b, t, h, d_head).to(dt)
            kern = lambda: flash_attention_bwd(q, k_, v, out_r, dout, lse_r, scale)
            plain = lambda: flash_attention_bwd_plain(q, k_, v, out_r, dout, lse_r, scale)
            timed = (time_ms(torch, kern), time_ms(torch, plain)) if tag == "flagship" else None
            got, want = kern(), plain()
            d = max(compare(torch, "flash_attn_bwd", f"{tag} {n}", a, w_, dt, card,
                            timed if n == "dq" else None)
                    for n, a, w_ in zip(("dq", "dk", "dv"), got, want))
            # two passes, no atomics: a rerun is bitwise equal
            require(all(torch.equal(a, b_) for a, b_ in zip(kern(), got)),
                    f"flash_attn_bwd {tag} {dt} (B {b}, T {t}, H {h}, D {d_head}): not repeatable")
            if tag == "flagship":
                # the library's backward: autograd of scaled_dot_product_attention
                leaves = [a.detach().requires_grad_() for a in (qt, kt, vt)]
                o_lib = F.scaled_dot_product_attention(*leaves)
                dout_t = dout.transpose(1, 2).contiguous()
                lib_ms = time_ms(torch, lambda: torch.autograd.grad(
                    o_lib, leaves, dout_t, retain_graph=True))
            if tag == "flagship" and dt == torch.float32:
                f32_row(card, "flash_attn_bwd", tag, timed[0], lib_ms,
                        10.0 * b * h * t * t * d_head, nbytes(q, k_, v, out_r, dout, lse_r, *got),
                        split_tf32=True)
                # the split-TF32 passes against the plain version in float64
                exact = flash_attention_bwd_plain(
                    *(a.double() for a in (q, k_, v, out_r, dout, lse_r)), scale)
                for n, a, w_, e in zip(("dq", "dk", "dv"), got, want, exact):
                    f64_gate(card, "flash_attn_bwd", f"{tag} {n}", a, w_, e)
                del exact
            if tag == "flagship" and dt == torch.bfloat16:
                # five (T, T, D) products the function needs (S, dP, dV, dK,
                # dQ); the dq pass's recompute of S and dP is the kernel's choice
                record("flash_attn_bwd", d, timed, 10.0 * b * h * t * t * d_head,
                       nbytes(q, k_, v, out_r, dout, lse_r, *got), "bfloat16", lib_ms)
            elif tag in ("ragged", "sliced"):
                # the autograd Function (K4 + K6) against autograd of full attention
                grads = []
                for fn in (flash_attention_train, attend_full):
                    leaves = [a.detach().clone().requires_grad_() for a in (q, k_, v)]
                    (fn(*leaves, scale).float() * dout.float()).sum().backward()
                    grads.append([a.grad for a in leaves])
                for n, a, w_ in zip(("dq", "dk", "dv"), *grads):
                    compare(torch, "flash_attn_train", f"{tag} {n}", a, w_, dt, card)

    # K4's bf16 launch takes 128-query blocks where ceil(T / 128) * B * H blocks fill
    # two waves of two an SM, else 64-query blocks (flash_attn_fwd.cu): the
    # flagship's batch 2 takes the 64-query instance, the serving requests'
    # batches 4 and 16 the 128-query one; each is held to the plain version there
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t, h, d_head = 2400, 8, 48
    block_rows = set()
    for b in (2, 4, 16):
        q, k_, v = (randn(b, t, h, d_head).to(torch.bfloat16) for _ in range(3))
        kern = lambda: flash_attention(q, k_, v, d_head ** -0.5)
        want_rows = 128 if -(-t // 128) * b * h >= 4 * sms else 64
        rows = {int(m.group(2) or m.group(4)) for n in launched_kernels(torch, kern)
                if (m := re.search(r"flash_fwd_tc_kernel(?:<(\d+), ?(\d+)>|ILi(\d+)ELi(\d+)E)",
                                   n))}
        print(f"[kernel] flash_attn_fwd bfloat16 (B {b}, T {t}, H {h}, D {d_head}): "
              f"{sorted(rows)}-query blocks launched, {want_rows} by the grid rule ({sms} SMs)")
        require(rows == {want_rows}, f"flash_attn_fwd B {b}: launched {rows}-query blocks, "
                f"the grid rule gives {want_rows}")
        block_rows |= rows
        (o, lse), (o_ref, lse_ref) = kern(), flash_attention_plain(q, k_, v, d_head ** -0.5)
        compare(torch, "flash_attn_fwd", f"batch {b}", o, o_ref, torch.bfloat16, card)
        compare(torch, "flash_attn_lse", f"batch {b}", lse, lse_ref, torch.float32, card)
        del q, k_, v, o, lse, o_ref, lse_ref
    require(block_rows == {64, 128}, f"flash_attn_fwd: only {block_rows}-query blocks checked")

    # past head dim 128 (the wide kernels) beside SDPA and its backward, back to
    # back, at the flagship's attention shape (B 2, T 2400, 8 heads), D 48 for
    # reference, with each kernel's bound (K4 4 B H T^2 D FLOP, K6 10 B H T^2 D,
    # at the bf16 peak; the exponentials' floor: one ex2 a score a column group);
    # at D 160 the wrapper launches the wide kernels alone (no pad copy)
    clock, sms = max_sm_clock_hz(), torch.cuda.get_device_properties(0).multi_processor_count
    for d_head in PAST_128_DIMS:
        q, k_, v, dout = (randn(2, t, h, d_head).to(torch.bfloat16) for _ in range(4))
        scale = d_head ** -0.5
        o, lse = (a.contiguous() for a in flash_attention(q, k_, v, scale))
        qt, kt, vt, dout_t = (a.transpose(1, 2).contiguous() for a in (q, k_, v, dout))
        leaves = [a.detach().requires_grad_() for a in (qt, kt, vt)]
        o_lib = F.scaled_dot_product_attention(*leaves)
        fwd = lambda: flash_attention(q, k_, v, scale)
        bwd = lambda: flash_attention_bwd(q, k_, v, o, dout, lse, scale)
        ms = [stream_ms(torch, fn) for fn in (
            fwd, lambda: F.scaled_dot_product_attention(qt, kt, vt), bwd,
            lambda: torch.autograd.grad(o_lib, leaves, dout_t, retain_graph=True))]
        flops = 2.0 * 2 * h * t * t * d_head   # one (T, T, D) product at B 2
        d_pad, width = head_dim_plan(d_head, torch.bfloat16)
        groups = -(-d_pad // width)
        b_fwd, by_fwd = bound(2 * flops, nbytes(q, k_, v, o, lse), "bfloat16")
        b_bwd, by_bwd = bound(5 * flops, nbytes(q, k_, v, o, dout, lse, q, k_, v), "bfloat16")
        exp_floor = groups * 2 * h * t * t / (16 * sms * clock) * 1e3
        print(f"[kernel] flash_attn bfloat16 (B 2, T {t}, H {h}, D {d_head}, {groups} column "
              f"group(s)) back to back: K4 {ms[0]:.4f} ms, SDPA {ms[1]:.4f} ms "
              f"({ms[0] / ms[1]:.2f}x), bound {b_fwd:.4f} ms by {by_fwd}, exp floor "
              f"{exp_floor:.4f} ms; K6 {ms[2]:.4f} ms, SDPA backward {ms[3]:.4f} ms "
              f"({ms[2] / ms[3]:.2f}x), bound {b_bwd:.4f} ms by {by_bwd} ({card})")
        past_128[d_head] = {"ms": ms[0], "sdpa_ms": ms[1], "bound_ms": b_fwd,
                            "bwd_ms": ms[2], "sdpa_bwd_ms": ms[3], "bwd_bound_ms": b_bwd}
        if d_head == 160:
            names = {"forward": launched_kernels(torch, fwd),
                     "backward": launched_kernels(torch, bwd)}
            print(f"[kernel] flash_attn bfloat16 D 160, launched: {names}")
            split = device_split(torch, bwd)
            print(f"[kernel] flash_attn bfloat16 D 160, K6's device time by kernel: "
                  + "; ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in split.items()) + f" ({card})")
            require(len(names["forward"]) == 1 and WIDE_ATTN_KERNELS[0] in names["forward"][0],
                    f"K4 at D 160 launched {names['forward']}, not the wide kernel alone")
            require(len(names["backward"]) == 3 and
                    all(any(k in n for n in names["backward"]) for k in WIDE_ATTN_KERNELS[1:]),
                    f"K6 at D 160 launched {names['backward']}")
        del q, k_, v, dout, o, lse, qt, kt, vt, dout_t, leaves, o_lib
    # float32 past head dim 128 (D 160 unpadded, one column group: the split-TF32
    # wide kernels alone) beside SDPA and its backward in float32, TF32 off, with
    # both bounds; out, lse, dq, dk and dv held to float64
    d_head = 160
    q, k_, v, dout = (randn(2, t, h, d_head) for _ in range(4))
    scale = d_head ** -0.5
    fwd = lambda: flash_attention(q, k_, v, scale)
    o, lse = (a.contiguous() for a in fwd())
    bwd = lambda: flash_attention_bwd(q, k_, v, o, dout, lse, scale)
    names = {"forward": launched_kernels(torch, fwd), "backward": launched_kernels(torch, bwd)}
    print(f"[kernel] flash_attn float32 D {d_head}, launched: {names}")
    require(len(names["forward"]) == 1 and WIDE_TF32_ATTN_KERNELS[0] in names["forward"][0],
            f"float32 K4 at D {d_head} launched {names['forward']}")
    require(len(names["backward"]) == 3 and
            all(any(k in n for n in names["backward"]) for k in WIDE_TF32_ATTN_KERNELS[1:]),
            f"float32 K6 at D {d_head} launched {names['backward']}")
    split = device_split(torch, bwd)
    print(f"[kernel] flash_attn float32 D {d_head}, K6's device time by kernel: "
          + "; ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in split.items()) + f" ({card})")
    qt, kt, vt, dout_t = (a.transpose(1, 2).contiguous() for a in (q, k_, v, dout))
    leaves = [a.detach().requires_grad_() for a in (qt, kt, vt)]
    o_lib = F.scaled_dot_product_attention(*leaves)
    got = bwd()
    flops = 2.0 * 2 * h * t * t * d_head   # one (T, T, D) product at B 2
    f32_row(card, "flash_attn_fwd", f"D {d_head}", time_ms(torch, fwd),
            time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            2 * flops, nbytes(q, k_, v, o, lse), split_tf32=True)
    f32_row(card, "flash_attn_bwd", f"D {d_head}", time_ms(torch, bwd),
            time_ms(torch, lambda: torch.autograd.grad(o_lib, leaves, dout_t, retain_graph=True)),
            5 * flops, nbytes(q, k_, v, o, dout, lse, *got), split_tf32=True)
    del qt, kt, vt, dout_t, leaves, o_lib
    plain_fwd = flash_attention_plain(q, k_, v, scale)
    exact = flash_attention_plain(q.double(), k_.double(), v.double(), scale)
    for n, a, w_, e in zip(("out", "lse"), (o, lse), plain_fwd, exact):
        f64_gate(card, "flash_attn_fwd", f"D {d_head} {n}", a, w_, e)
    del plain_fwd, exact
    plain_bwd = flash_attention_bwd_plain(q, k_, v, o, dout, lse, scale)
    exact = flash_attention_bwd_plain(*(a.double() for a in (q, k_, v, o, dout, lse)), scale)
    for n, a, w_, e in zip(("dq", "dk", "dv"), got, plain_bwd, exact):
        f64_gate(card, "flash_attn_bwd", f"D {d_head} {n}", a, w_, e)
    del q, k_, v, dout, o, lse, got, plain_bwd, exact
    summary["flash_attn_fwd"]["past_128"] = {str(d): {k: v for k, v in r.items() if "bwd" not in k}
                                             for d, r in past_128.items()}
    summary["flash_attn_bwd"]["past_128"] = {
        str(d): {"ms": r["bwd_ms"], "sdpa_ms": r["sdpa_bwd_ms"], "bound_ms": r["bwd_bound_ms"]}
        for d, r in past_128.items()}

    phase_k5(torch, card, randn, record)
    phase_k9(torch, card, record)
    k9_nan_routing(torch, card)
    k9_route_ragged(torch, card)
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
    route = k9_route_times(torch, card, k9)
    for name, part, kernel in (("ct_train_sel_stats", "B1", "ct_route_stats_kernel"),
                               ("ct_train_gz", "g_z", "ct_route_gz_kernel")):
        flag = route[f"stage 2 batch 2 bfloat16 {part}"]
        summary[name].update(kernel=kernel, stream_ms=flag["stream_ms"],
                             device_ms=flag["device_ms"],
                             route={k: v for k, v in route.items() if k.endswith(part)})
    phase_k7_k8(torch, card, record)
    phase_frontend_kernels(torch, card, randn, record)
    require(all(launch_counts[COUNTED_AS.get(n, n)] > 0 for n in KERNELS),
            f"kernels not launched: {launch_counts}")
    return summary


def phase_tile(torch, card: str, randn) -> None:
    """The conv tile that K3, K10b and K9's F1, F2 and dh share (the block
    tile: split TF32 in float32, mma.sync in bfloat16; dh on the transposed
    weights), launched as K3 (any Cin) and as K9's dh, against the plain
    versions at
    the ragged shapes of TILE_CASES; then
    the F1 / F2 identity at the flagship's stage 2 on random (not
    integer-grid) bf16 inputs: K3's pooled output equals max_r relu(pre *
    scale + bias) from F1's pre bit for bit (the affine as one fma: the
    float64 product of two floats is exact)."""
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
    from seld_tpu_torch.ops.kernels import conv2d_pool as pool

    F = torch.nn.functional
    for b, cin, f, t, cout, pf in TILE_CASES:
        xf = randn(b, cin, f, t)
        wf = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        scale = randn(cout, scale=0.2) + 1.0
        bias = randn(cout, scale=0.2)
        gzf = randn(b, cout, f, t)
        tag = f"Cin {cin} Cout {cout} T {t} pf {pf}"
        for dt in (torch.float32, torch.bfloat16):
            x, w, gz = xf.to(dt), wf.to(dt), gzf.to(dt)
            compare(torch, "conv_tile", tag, pool.conv2d_widecin_bn_relu_fpool(
                x, w, scale, bias, pf), pool.conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf),
                dt, card)
            compare(torch, "conv_tile_dh", tag, k9.ct_dx(gz, w), k9.ct_dx_plain(gz, w), dt, card)
        del xf, wf, gzf

    b, c, f, t, cout, pf = 2, 192, 32, 4800, 192, 8
    h = randn(b, c, f, t, dtype=torch.bfloat16)
    w = randn(3, 3, c, cout, dtype=torch.bfloat16, scale=(9 * c) ** -0.5)
    sums, pre = k9.ct_train_stats(h, w, pf)
    n = b * f * t
    mean = sums[:cout] / n
    inv = torch.rsqrt(torch.clamp(sums[cout:] / n - mean * mean, min=0.0) + 1e-5)
    scale = (randn(cout, scale=0.3) + 1.0) * inv
    bias = randn(cout, scale=0.3) - mean * scale
    out = pool.conv2d_widecin_bn_relu_fpool(h, w, scale, bias, pf)
    col = lambda v: v.double()[:, None, None]
    y = (pre.double() * col(scale) + col(bias)).float()
    want = F.max_pool2d(torch.relu(y), (pf, 1)).to(torch.bfloat16)
    differ = int((out != want).sum())
    print(f"[kernel] conv tile F1 / F2 identity, stage 2 bf16 random inputs: {differ} of "
          f"{out.numel()} pooled outputs differ from max_r relu(pre * scale + bias)")
    require(differ == 0, f"K3's pooled rows differ from F1's pre in {differ} places")
    del h, w, pre, out, y, want


def k5_inputs(torch, b, cin, f, t, cout, dtype, gen):
    """K5 inputs on a grid: x in {-2..2}, w in {-4..4}/16. Every conv sum is
    then exact in float32, so the kernel's conv and the plain one agree bit
    for bit and the max-pool routes each window's gradient to the same row in
    both; random real inputs leave near-ties that round apart and route to
    different rows, a difference of the two sums' order and not a fault.
    Exact ties are frequent, which exercises the first-max rule."""
    dev = torch.device("cuda")
    x = torch.randint(-2, 3, (b, f, t, cin), generator=gen, device=dev).to(dtype)
    w = (torch.randint(-4, 5, (3, 3, cin, cout), generator=gen, device=dev) / 16).to(dtype)
    gamma = 1.0 + 0.3 * torch.randn(cout, generator=gen, device=dev)
    beta = 0.3 * torch.randn(cout, generator=gen, device=dev)
    return x, w, gamma, beta


def phase_k5(torch, card: str, randn, record) -> None:
    """K5: the autograd op against autograd of the plain op, and each pass
    against its plain version, at ragged multi-tile shapes and at the
    flagship's stage 1 (batch 2): in float32 F1, F2 (K2's kernel) and the
    g_z pass on the float smallcin tile (F1's sums on real-valued x also
    within F64_FACTOR x the float32 plain version's distance from float64)
    and the split-TF32 dW tile, in bfloat16 the tensor-core
    passes (F1 and g_z on the conv tile, F2 K3's tile through K10b's entry,
    dW on the dW tile); the dW tiles against dW in float64, the float32 one
    also within F64_FACTOR x the float32 plain version's distance (cuDNN's
    float32 wgrad printed beside); records the flagship bf16 passes, prints
    B2 (g_z + dW) beside cuDNN's weight gradient in both dtypes, requires
    the g_z and dW passes to rerun bitwise equal, then checks the routing
    against F2 on random inputs in both dtypes (k5_routing_identity)."""
    from seld_tpu_torch.ops.kernels import conv2d_train as k5
    from seld_tpu_torch.ops.kernels.conv2d_pool import (
        conv2d_smallcin_bn_relu_fpool, conv2d_windows_bn_relu_fpool,
    )

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [  # tag, B, Cin, F, T, Cout, pf: >= 3 T splits / Cout tiles / B * F' rows
        ("ragged", 2, 8, 24, 1300, 200, 8),
        ("ragged", 2, 5, 24, 1100, 80, 8),
        ("ragged", 2, 9, 16, 700, 80, 4),       # Cin 9 and 10: 16 staged channels
        ("ragged", 1, 10, 24, 1300, 72, 8),
        ("ragged", 1, 8, 32, 515, 64, 16),      # T % 8 != 0 (2-byte staging), pf 16
        ("flagship", 2, CHANNELS, 256, 4800, 192, 8),
    ]
    for tag, b, cin, f, t, cout, pf in cases:
        for dt in (torch.float32, torch.bfloat16):
            x, w, gamma, beta = k5_inputs(torch, b, cin, f, t, cout, dt, gen)
            g = randn(b, f // pf, t, cout).to(dt)
            results = []
            for fn in (k5.conv2d_bn_relu_fpool_train, k5.conv2d_bn_relu_fpool_train_plain):
                wr, gr, br = (a.clone().requires_grad_() for a in (w, gamma, beta))
                out, mean, var = fn(x, wr, gr, br, pf)
                (out.float() * g.float()).sum().backward()
                results.append((out, mean, var, wr.grad, gr.grad, br.grad))
            for n, a, w_ in zip(("out", "mean", "var", "dW", "dgamma", "dbeta"), *results):
                compare(torch, "conv_train_op", f"{tag} {n}", a, w_,
                        dt if a.dtype == dt else torch.float32, card)
            del results

            # each pass on the same inputs as its plain version
            bf16 = k5.tensor_core_path(x)
            flag = tag == "flagship" and bf16
            xc = x.permute(0, 3, 1, 2).contiguous()
            gc = g.permute(0, 3, 1, 2).contiguous()
            n = b * f * t
            sums = k5.conv_train_stats(xc, w, pf)
            mean = sums[:cout] / n
            var = torch.clamp(sums[cout:] / n - mean * mean, min=0.0)
            inv = torch.rsqrt(var + 1e-5)
            scale = gamma * inv
            bias = beta - mean * scale
            p_col, q_col = inv / scale, (bias / scale + mean) * inv
            f2 = conv2d_windows_bn_relu_fpool if bf16 else conv2d_smallcin_bn_relu_fpool
            out = f2(xc, w, scale, bias, pf)
            sel = k5.sel_stats(out, gc, p_col, q_col)
            a_col = inv * scale * sel[cout:] / n
            b_col = scale * sel[:cout] / n - mean * a_col
            conv_flops = 2.0 * 9 * cin * cout * n
            g_read = gc.element_size() * int((out > 0).sum())   # B1 and B2 read g where out > 0
            w_nchw = w.permute(3, 2, 0, 1).contiguous()
            conv_lib = lambda: F.conv2d(xc, w_nchw, padding=1)
            passes = [
                ("conv_train_stats", lambda: k5.conv_train_stats(xc, w, pf),
                 lambda: k5.conv_train_stats_plain(xc, w), torch.float32,
                 conv_flops, nbytes(xc, w) + 8 * cout, conv_lib),
                ("conv_train_fwd", lambda: f2(xc, w, scale, bias, pf),
                 lambda: k5.conv_train_fwd_plain(xc, w, scale, bias, pf), dt,
                 conv_flops, nbytes(xc, w, out), conv_lib),
                ("conv_train_sel_stats", lambda: k5.sel_stats(out, gc, p_col, q_col),
                 lambda: k5.sel_stats_plain(out, gc, p_col, q_col), torch.float32,
                 5.0 * out.numel(), nbytes(out) + g_read + 8 * cout, None),
            ]
            b2_args = (xc, w, gc, scale, bias, a_col, b_col, pf)
            gz, gz_sums = k5.conv_train_gz(*b2_args)
            passes += [
                # g_z needs the conv again (no pre is kept), reads g where it
                # routes and writes (B, Cout, F, T)
                ("conv_train_gz", lambda: k5.conv_train_gz(*b2_args),
                 lambda: k5.conv_train_gz_plain(*b2_args), dt, conv_flops,
                 nbytes(xc, w, gz) + g_read + 8 * cout, None),
                ("conv_train_dw", lambda: k5.conv_train_dw_gz(xc, gz),
                 lambda: k5.dw_plain(xc, gz), torch.float32, conv_flops,
                 nbytes(xc, gz) + 4 * w.numel(),
                 lambda: torch.nn.grad.conv2d_weight(xc, w_nchw.shape, gz, padding=1)),
            ]
            dw_fn = lambda: k5.conv_train_dw_gz(xc, gz)
            pass_ms = {}
            for name, kern, plain, tol_dt, flops, moved, library in passes:
                timed = ((time_ms(torch, kern), time_ms(torch, plain)) if tag == "flagship"
                         else None)
                got, want = kern(), plain()
                if name == "conv_train_gz":   # (g_z, the routed sums)
                    compare(torch, name, f"{tag} sums", got[1], want[1], torch.float32, card)
                    got, want = got[0], want[0]
                label = tag if tol_dt == dt else f"{tag}/{str(dt)[6:]}-in"
                if name == "conv_train_dw":
                    # the plain dW in float32 sums B * F * T products per weight (2.46M
                    # at the flagship) in an order of its own, with an error of its own
                    # near the tolerance: the tile is held to the plain version's
                    # float64 value, and the three distances are printed
                    exact = k5.dw_plain(xc.double(), gz.double())
                    dist = lambda u, v: (u.double() - v).abs().max().item()
                    print(f"[kernel] K5 dW {tag}: max|d| kernel - float64 plain "
                          f"{dist(got, exact):.3e}, float32 plain - float64 plain "
                          f"{dist(want, exact):.3e}, kernel - float32 plain "
                          f"{dist(got, want.double()):.3e} (max|ref| "
                          f"{exact.abs().max().item():.3e})")
                    want, label = exact, f"{label}/f64-ref"
                d = compare(torch, name, label, got, want, tol_dt, card, timed)
                if tag == "flagship" and not bf16:
                    # every float32 pass but B1 runs split-TF32 products
                    f32_row(card, name, tag, timed[0],
                            None if library is None else time_ms(torch, library), flops, moved,
                            split_tf32=name != "conv_train_sel_stats")
                    pass_ms[name] = timed[0]
                if tag == "flagship" and name == "conv_train_stats" and not bf16:
                    # F1's sums on real-valued x (the grid's x has no lo part)
                    xr = randn(*xc.shape)
                    f64_gate(card, name, f"{tag} randn", k5.conv_train_stats(xr, w, pf),
                             k5.conv_train_stats_plain(xr, w),
                             k5.conv_train_stats_plain(xr.double(), w.double()))
                    del xr
                if not bf16 and name == "conv_train_dw":
                    # the split-TF32 tile, the float32 plain version without cuDNN
                    # and cuDNN's float32 wgrad against dW in float64: on the
                    # grid's x (x_lo = 0) and the kernel's g_z, then on real-valued
                    # x and g_z
                    for sub, xx, zz in (
                            (tag, xc, gz),
                            (f"{tag} randn", randn(*xc.shape), randn(*gz.shape, scale=0.01))):
                        f64_gate(card, name, sub, k5.conv_train_dw_gz(xx, zz),
                                 dw_plain_f32(xx, zz), k5.dw_plain(xx.double(), zz.double()),
                                 library=k5.dw_plain(xx, zz))
                        del xx, zz
                if flag:
                    pass_ms[name] = timed[0]
                    lib_ms = None if library is None else time_ms(torch, library)
                    record(name, d, timed, flops, moved, "bfloat16", lib_ms)
            # partial sums reduced in a fixed order, no atomics: a rerun is bitwise equal
            require(torch.equal(dw_fn(), dw_fn()), f"K5 dW {tag} {dt}: not repeatable")
            require(all(torch.equal(u, v) for u, v in zip(k5.conv_train_gz(*b2_args),
                                                          (gz, gz_sums))),
                    f"K5 g_z {tag} {dt}: not repeatable")
            if tag == "flagship":
                wgrad_ms = time_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                    xc, w_nchw.shape, gz, padding=1))
                b2_ms = pass_ms["conv_train_gz"] + pass_ms["conv_train_dw"]
                print(f"[kernel] K5 B2 stage 1 {str(dt)[6:]} batch {b}: g_z "
                      f"{pass_ms['conv_train_gz']:.3f} + dW {pass_ms['conv_train_dw']:.3f} = "
                      f"{b2_ms:.3f} ms; cuDNN wgrad {wgrad_ms:.3f} ms ({card})")
                if not bf16:
                    # B2's bounds: the function (two convs' operations, as the
                    # TPU kernel counts them), the g_z pass's recompute, the dW
                    # tile's three TF32 products, and g_z's round trip
                    fn_ms = bound(2 * conv_flops, nbytes(xc, w) + g_read, "float32")[0]
                    rc_ms = bound(conv_flops, 0, "float32")[0]
                    dw_ms = bound(3 * conv_flops, 0, "tf32")[0]
                    rt_ms = bound(0, 2 * nbytes(gz), "float32")[0]
                    print(f"[f32] K5 B2 flagship: g_z {pass_ms['conv_train_gz']:.3f} + dW "
                          f"{pass_ms['conv_train_dw']:.3f} = {b2_ms:.3f} ms; cuDNN's float32 "
                          f"wgrad alone {wgrad_ms:.3f} ms; bounds: B2 {fn_ms:.4f} ms "
                          f"(operations), the recompute {rc_ms:.4f} (operations), dW "
                          f"{dw_ms:.4f} (three TF32 products), g_z's round trip {rt_ms:.4f} "
                          f"(bytes) ({card})")
            del xc, gc, out, gz
    k5_f32_nans(torch, card, randn)
    k5_routing_identity(torch, card, randn)


def k5_f32_nans(torch, card: str, randn) -> None:
    """K5's float32 B2 keeps NaNs where its plain versions do: the g_z pass
    with a NaN in x (batch 0) and in g (batch 1), the dW tile with one in x
    (batch 0) and in g_z (batch 1), each as float('nan') and as the card's
    own 0x7fffffff (the dW tile against its plain version without cuDNN)."""
    from seld_tpu_torch.ops.kernels import conv2d_train as k5

    b, cin, f, t, cout, pf = 2, 8, 16, 300, 72, 8

    def nan_at(v, at, bits):
        v = v.clone()
        v.view(torch.int32)[at] = bits
        return v

    for bits in (0x7FC00000, 0x7FFFFFFF):
        x = nan_at(randn(b, cin, f, t), (0, 3, 5, 100), bits)
        w = randn(3, 3, cin, cout, scale=0.1)
        scale = randn(cout, scale=0.2) + 1.0
        bias, a, c = (randn(cout, scale=0.2) for _ in range(3))
        g = nan_at(randn(b, cout, f // pf, t), (1, 40, 1, 250), bits)
        args = (x, w, g, scale, bias, a, c, pf)
        gz, want_gz = k5.conv_train_gz(*args)[0], k5.conv_train_gz_plain(*args)[0]
        xz = nan_at(randn(b, cin, f, t), (0, 3, 5, 100), bits)
        zz = nan_at(randn(b, cout, f, t), (1, 17, 6, 99), bits)
        dw, want_dw = k5.conv_train_dw_gz(xz, zz), dw_plain_f32(xz, zz)
        torch.cuda.synchronize()
        same = [torch.equal(torch.isnan(u), torch.isnan(v)) for u, v in ((gz, want_gz),
                                                                         (dw, want_dw))]
        print(f"[kernel] K5 f32 NaN 0x{bits:08x}: g_z NaN at {int(torch.isnan(gz).sum())} "
              f"places (plain {int(torch.isnan(want_gz).sum())}), dW at "
              f"{int(torch.isnan(dw).sum())} of {dw.numel()} (plain "
              f"{int(torch.isnan(want_dw).sum())}) ({card})")
        require(all(same) and bool(torch.isnan(want_gz[1]).any())
                and 0 < int(torch.isnan(want_dw).sum()) < want_dw.numel(),
                f"K5 f32 B2 with NaN 0x{bits:08x}: NaNs not where the plain versions' are")


def fma_f32(torch, a, b, c):
    """a * b + c rounded once to float32 (the kernels' fmaf), from float32
    tensors: the product is exact in float64 and the float64 sum's error is
    recovered exactly (two-sum); only where that sum falls on a midpoint
    between two floats does the error decide the rounding, which a plain
    float64 sum rounded to float32 would get wrong there."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    y = s.float()
    up = torch.nextafter(y, torch.full_like(y, float("inf")))
    down = torch.nextafter(y, torch.full_like(y, -float("inf")))
    y = torch.where(((y.double() + up.double()) / 2 == s) & (err > 0), up, y)
    return torch.where(((y.double() + down.double()) / 2 == s) & (err < 0), down, y)


def k5_routing_identity(torch, card: str, randn) -> None:
    """At the flagship's stage 1 (B 2, Cin 8, F 256, T 4800, pf 8) on random
    (not integer-grid) inputs, in both dtypes: K5's F2 (bfloat16: K3's tile
    through K10b's entry; float32: K2's kernel on the float smallcin tile)
    pools max_r relu(pre * scale + bias) of the same conv rows (the affine
    as one fma) bit for bit (bfloat16: K9 F1's pre, the same tile; float32:
    the g_z pass's own recompute on the float smallcin tile, fed g = 0, a =
    -1 and b = 0 so that g_z = acc exactly),
    and K5's g_z pass, fed g = 1 and a = b = 0 so that g_z = scale > 0
    exactly where it routes, routes every window to the first row holding
    that max, where the max is > 0."""
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
    from seld_tpu_torch.ops.kernels import conv2d_train as k5
    from seld_tpu_torch.ops.kernels.conv2d_pool import (
        conv2d_smallcin_bn_relu_fpool, conv2d_windows_bn_relu_fpool,
    )

    b, cin, f, t, cout, pf = 2, CHANNELS, 256, 4800, 192, 8
    for dt in (torch.bfloat16, torch.float32):
        f2 = conv2d_windows_bn_relu_fpool if dt == torch.bfloat16 else conv2d_smallcin_bn_relu_fpool
        x = randn(b, cin, f, t, dtype=dt)
        w = randn(3, 3, cin, cout, dtype=dt, scale=(9 * cin) ** -0.5)
        scale = randn(cout, scale=0.3).abs() + 0.5
        bias = randn(cout, scale=0.3)
        zero = torch.zeros(cout, device=x.device)
        if dt == torch.bfloat16:
            pre = k9.ct_train_stats(x, w, pf)[1]
        else:
            pre = k5.conv_train_gz(x, w, torch.zeros(b, cout, f // pf, t, device=x.device),
                                   scale, bias, -torch.ones_like(zero), zero, pf)[0]
        out = f2(x, w, scale, bias, pf)
        y = torch.relu(fma_f32(torch, pre, scale[:, None, None], bias[:, None, None]))
        del pre
        y = y.view(b, cout, f // pf, pf, t)
        best, row = y[:, :, :, 0], torch.zeros(y[:, :, :, 0].shape, dtype=torch.uint8,
                                               device=y.device)
        for r in range(1, pf):   # strict >: ties keep the earlier row
            up = y[:, :, :, r] > best
            best = torch.where(up, y[:, :, :, r], best)
            row = torch.where(up, r, row)
        differ_out = int((out != best.to(dt)).sum())
        want = (torch.arange(pf, device=y.device).view(1, 1, 1, pf, 1) == row.unsqueeze(3)) & (
            best > 0).unsqueeze(3)
        del y
        ones = torch.ones(b, cout, f // pf, t, dtype=dt, device=x.device)
        gz, sums = k5.conv_train_gz(x, w, ones, scale, bias, zero, zero, pf)
        routed = (gz != 0).view(want.shape)
        differ_route = int((routed != want).sum())
        name = str(dt)[6:]
        print(f"[kernel] K5 routing, stage 1 {name} random inputs: {differ_out} of "
              f"{out.numel()} pooled outputs differ from max_r relu(pre * scale + bias); "
              f"{differ_route} of {routed.numel()} conv outputs routed otherwise than the first "
              f"max > 0; routed windows {int(want.sum())}")
        require(differ_out == 0, f"K5's F2 ({name}) differs from the conv rows in {differ_out} "
                "places")
        require(differ_route == 0, f"K5's g_z pass ({name}) routes {differ_route} outputs "
                "otherwise")
        require(torch.equal(sums[:cout], want.sum((0, 2, 3, 4)).float()),
                f"K5's routed S_g ({name}) is not the routed count")
        del x, gz, routed, want, out, ones


def phase_k9(torch, card: str, record) -> None:
    """K9: the autograd op (five kernels and K3) against autograd of the plain
    op, and each pass against its plain version on the same inputs, at a
    ragged multi-tile shape and at the flagship's stages 2 and 3 (batch 2), in
    float32 and bfloat16; records the flagship stage-2 bf16 passes and prints
    the whole op's time beside cuDNN's three convolutions of the stage."""
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
    from seld_tpu_torch.ops.kernels.conv2d_pool import conv2d_widecin_bn_relu_fpool
    from seld_tpu_torch.ops.kernels.conv2d_train import conv_train_fwd_plain, dw_plain

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [  # tag, B, C, F, T, Cout, pf: 3 T tiles, 2 Cout tiles, 3 pool groups
        ("ragged", 2, 24, 24, 300, 72, 8),
        ("stage2", 2, 192, 32, 4800, 192, 8),
        ("stage3", 2, 192, 4, 4800, 192, 2),
    ]
    for tag, b, c, f, t, cout, pf in cases:
        for dt in (torch.float32, torch.bfloat16):
            # on a grid (k5_inputs' reason): both convs exact, so both route alike
            h = torch.randint(-2, 3, (b, c, f, t), generator=gen, device=dev).to(dt)
            w = (torch.randint(-4, 5, (3, 3, c, cout), generator=gen, device=dev) / 16).to(dt)
            gamma = 1.0 + 0.3 * torch.randn(cout, generator=gen, device=dev)
            beta = 0.3 * torch.randn(cout, generator=gen, device=dev)
            g = torch.randn(b, cout, f // pf, t, generator=gen, device=dev).to(dt)
            results = []
            for fn in (k9.conv2d_ct_bn_relu_fpool_train, k9.conv2d_ct_bn_relu_fpool_train_plain):
                hr, wr, gr, br = (a.clone().requires_grad_() for a in (h, w, gamma, beta))
                out, mean, var = fn(hr, wr, gr, br, pf)
                (out.float() * g.float()).sum().backward()
                results.append((out, mean, var, hr.grad, wr.grad, gr.grad, br.grad))
            for n, a, w_ in zip(("out", "mean", "var", "dh", "dW", "dgamma", "dbeta"), *results):
                compare(torch, "ct_train_op", f"{tag} {n}", a, w_,
                        dt if a.dtype == dt else torch.float32, card)
            del results

            # each pass on the same inputs as its plain version
            flag = tag == "stage2" and dt == torch.bfloat16
            timed_tag = tag != "ragged" and dt == torch.bfloat16
            f32_tag = tag == "stage2" and dt == torch.float32
            f32_dx = tag != "ragged" and dt == torch.float32   # dx at stages 2 and 3
            n = b * f * t
            sums, pre = k9.ct_train_stats(h, w, pf)
            mean = sums[:cout] / n
            inv = torch.rsqrt(torch.clamp(sums[cout:] / n - mean * mean, min=0.0) + 1e-5)
            scale, zero = gamma * inv, torch.zeros_like(gamma)
            bias = beta - mean * scale
            out = conv2d_widecin_bn_relu_fpool(h, w, scale, bias, pf)
            cols = torch.stack([scale, bias, mean, inv, zero, zero])
            sel = k9.ct_sel_stats(pre, g, cols, pf)
            require(torch.equal(k9.ct_sel_stats(pre, g, cols, pf), sel),
                    f"{tag}: B1 not repeatable")
            cols = torch.stack([scale, bias, mean, inv, sel[:cout] / n, sel[cout:] / n])
            gz = k9.ct_gz(pre, g, cols, pf)
            conv_flops = 2.0 * 9 * c * cout * n
            w_nchw = w.permute(3, 2, 0, 1).contiguous()
            lib = {
                "fwd": lambda: F.conv2d(h, w_nchw, padding=1),
                "wgrad": lambda: torch.nn.grad.conv2d_weight(h, w_nchw.shape, gz, padding=1),
                "dgrad": lambda: torch.nn.grad.conv2d_input(h.shape, w_nchw, gz, padding=1),
            }
            passes = [
                ("ct_train_stats", lambda: k9.ct_train_stats(h, w, pf),
                 lambda: k9.ct_train_stats_plain(h, w), torch.float32,
                 conv_flops, nbytes(h, w, pre) + 8 * cout, lib["fwd"]),
                ("ct_train_fwd", lambda: conv2d_widecin_bn_relu_fpool(h, w, scale, bias, pf),
                 lambda: conv_train_fwd_plain(h, w, scale, bias, pf), dt,
                 conv_flops, nbytes(h, w, out), lib["fwd"]),
                ("ct_train_sel_stats", lambda: k9.ct_sel_stats(pre, g, cols, pf),
                 lambda: k9.ct_sel_stats_plain(pre, g, cols, pf), torch.float32,
                 5.0 * pre.numel(), nbytes(pre, g) + 8 * cout, None),
                ("ct_train_gz", lambda: k9.ct_gz(pre, g, cols, pf),
                 lambda: k9.ct_gz_plain(pre, g, cols, pf), dt,
                 6.0 * pre.numel(), nbytes(pre, g, gz), None),
                ("ct_train_dw", lambda: k9.ct_dw(h, gz), lambda: dw_plain(h, gz),
                 torch.float32, conv_flops, nbytes(h, gz) + 4 * w.numel(), lib["wgrad"]),
                ("ct_train_dx", lambda: k9.ct_dx(gz, w), lambda: k9.ct_dx_plain(gz, w), dt,
                 conv_flops, nbytes(gz, w, h), lib["dgrad"]),
            ]
            pass_ms = {}
            for name, kern, plain, tol_dt, flops, moved, library in passes:
                f32_line = f32_tag or (f32_dx and name == "ct_train_dx")
                timed = ((time_ms(torch, kern), time_ms(torch, plain)) if timed_tag or f32_line
                         else None)
                got, want = kern(), plain()
                if name == "ct_train_stats":   # (sums, pre)
                    compare(torch, name, f"{tag} pre", got[1], want[1], torch.float32, card)
                    got, want = got[0], want[0]
                label = tag if tol_dt == dt else f"{tag}/{str(dt)[6:]}-in"
                d = compare(torch, name, label, got, want, tol_dt, card, timed)
                if f32_line:
                    f32_row(card, name, tag, timed[0],
                            None if library is None else time_ms(torch, library), flops, moved,
                            split_tf32=name in ("ct_train_stats", "ct_train_fwd", "ct_train_dw",
                                                "ct_train_dx"))
                if f32_dx and name == "ct_train_dx":
                    # the split-TF32 dh on real-valued g_z and w against float64,
                    # beside the float32 plain version without cuDNN and cuDNN's
                    # float32 dgrad; bitwise on a rerun
                    zz = torch.randn(gz.shape, generator=gen, device=dev)
                    ww = torch.randn(w.shape, generator=gen, device=dev) / (9 * cout) ** 0.5
                    dh = k9.ct_dx(zz, ww)
                    f64_gate(card, name, f"{tag} randn", dh, dx_plain_f32(zz, ww),
                             k9.ct_dx_plain(zz.double(), ww.double()),
                             library=k9.ct_dx_plain(zz, ww))
                    require(torch.equal(k9.ct_dx(zz, ww), dh), f"{tag}: float32 dh not repeatable")
                    del zz, ww, dh
                if f32_tag and name == "ct_train_dw":
                    # the split-TF32 tile, the float32 plain version without
                    # cuDNN and cuDNN's float32 wgrad against dW in float64:
                    # on the grid's h (h_lo = 0), then on real-valued h and g_z
                    for sub, hh, zz in (
                            (tag, h, gz),
                            (f"{tag} randn", torch.randn(h.shape, generator=gen, device=dev),
                             torch.randn(gz.shape, generator=gen, device=dev) / 100)):
                        f64_gate(card, name, sub, k9.ct_dw(hh, zz), dw_plain_f32(hh, zz),
                                 dw_plain(hh.double(), zz.double()), library=dw_plain(hh, zz))
                        del hh, zz
                if timed_tag:
                    pass_ms[name] = timed[0]
                if flag:
                    lib_ms = None if library is None else time_ms(torch, library)
                    record(name, d, timed, flops, moved, "bfloat16", lib_ms)
            # partial sums reduced in a fixed order, no atomics: a rerun is bitwise equal
            require(torch.equal(k9.ct_dw(h, gz), k9.ct_dw(h, gz)), f"{tag}: dW not repeatable")
            if f32_tag:
                k9_tile_f64(torch, card, gen, h.shape, w.shape, scale, bias, pf)
            if timed_tag:
                # the whole op: its kernels' sum against cuDNN's three convs of
                # the stage; the bound counts the function's three products
                lib_ms = sum(time_ms(torch, f_) for f_ in lib.values())
                bound_ms, bound_by = bound(3 * conv_flops, nbytes(h, w, out, g, h, w),
                                           "bfloat16")
                print(f"[kernel] K9 op {tag} bf16 batch {b}: passes {sum(pass_ms.values()):.3f} "
                      f"ms ({', '.join(f'{k} {v:.3f}' for k, v in pass_ms.items())}); cuDNN "
                      f"fwd + wgrad + dgrad {lib_ms:.3f} ms; bound {bound_ms:.4f} ms by "
                      f"{bound_by} ({card})")
            del h, w, g, pre, gz, out


def k9_tile_f64(torch, card: str, gen, h_shape, w_shape, scale, bias, pf: int) -> None:
    """K9's float32 F1 and F2 (the split-TF32 block tile) on real-valued h
    and w of the given shapes (the grid's inputs make every conv exact):
    F1's pre and F2's pooled output each within F64_FACTOR x the float32
    plain version's distance from float64, F2 equal to max_r relu(fma(pre,
    scale, bias)) of F1's pre bit for bit, and both bitwise on a rerun."""
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
    from seld_tpu_torch.ops.kernels.conv2d_pool import conv2d_widecin_bn_relu_fpool
    from seld_tpu_torch.ops.kernels.conv2d_train import conv_train_fwd_plain

    dev = scale.device
    h = torch.randn(h_shape, generator=gen, device=dev)
    w = torch.randn(w_shape, generator=gen, device=dev) / (9 * h_shape[1]) ** 0.5
    pre = k9.ct_train_stats(h, w, pf)[1]
    f64_gate(card, "ct_train_stats", "stage2 randn pre", pre, k9.ct_train_stats_plain(h, w)[1],
             k9.ct_train_stats_plain(h.double(), w.double())[1])
    out = conv2d_widecin_bn_relu_fpool(h, w, scale, bias, pf)
    f64_gate(card, "ct_train_fwd", "stage2 randn", out,
             conv_train_fwd_plain(h, w, scale, bias, pf),
             conv_train_fwd_plain(h.double(), w.double(), scale.double(), bias.double(), pf))
    y = fma_f32(torch, pre, scale[:, None, None], bias[:, None, None])
    differ = int((out != torch.nn.functional.max_pool2d(torch.relu(y), (pf, 1))).sum())
    print(f"[kernel] K9 float32 F1 / F2 identity, stage 2 random inputs: {differ} of "
          f"{out.numel()} pooled outputs differ from max_r relu(fma(pre, scale, bias))")
    require(differ == 0, f"K9's float32 F2 differs from F1's pre in {differ} places")
    require(torch.equal(k9.ct_train_stats(h, w, pf)[1], pre) and
            torch.equal(conv2d_widecin_bn_relu_fpool(h, w, scale, bias, pf), out),
            "K9's float32 F1 / F2: not repeatable")


def k9_nan_routing(torch, card: str) -> None:
    """K9's B1 and g_z on a pre holding NaNs in row 0 and in later rows of
    some pool windows, both dtypes: a window that holds a NaN routes nothing
    (JAX's _route_group), as the plain version: S_g with g = 1 counts the
    routed windows exactly, S_gx and g_z are NaN exactly where the plain
    version's are, and within its tolerance elsewhere."""
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    b, cout, f, t, pf = 2, 72, 16, 300, 8
    pre = torch.randn(b, cout, f, t, generator=gen, device=dev)
    for at in ((0, 0, 0, 3), (0, 1, 5, 7), (1, 70, 15, 299), (1, 3, 9, 100), (0, 3, 8, 100)):
        pre[at] = float("nan")
    cols = torch.stack([1.0 + 0.2 * torch.randn(cout, generator=gen, device=dev),
                        0.2 * torch.randn(cout, generator=gen, device=dev),
                        0.1 * torch.randn(cout, generator=gen, device=dev),
                        1.0 + 0.1 * torch.rand(cout, generator=gen, device=dev),
                        1e-3 * torch.randn(cout, generator=gen, device=dev),
                        1e-3 * torch.randn(cout, generator=gen, device=dev)])
    for dt in (torch.float32, torch.bfloat16):
        g = torch.randn(b, cout, f // pf, t, generator=gen, device=dev).to(dt)
        ones = torch.ones_like(g)
        got, want = k9.ct_sel_stats(pre, ones, cols, pf), k9.ct_sel_stats_plain(pre, ones, cols, pf)
        gz, gz_want = k9.ct_gz(pre, g, cols, pf), k9.ct_gz_plain(pre, g, cols, pf)
        torch.cuda.synchronize()
        routed, want_routed = int(got[:cout].sum()), int(want[:cout].sum())
        nan_sgx, nan_gz = torch.isnan(want[cout:]), torch.isnan(gz_want)
        fin = ~nan_gz
        d = (gz.float()[fin] - gz_want.float()[fin]).abs().max().item()
        print(f"[kernel] K9 NaN routing {str(dt)[6:]}: {routed} windows routed (plain "
              f"{want_routed}), S_gx NaN in {int(torch.isnan(got[cout:]).sum())} channels "
              f"(plain {int(nan_sgx.sum())}), g_z NaN at {int(torch.isnan(gz).sum())} (plain "
              f"{int(nan_gz.sum())}), max|d| elsewhere {d:.3e} ({card})")
        require(torch.equal(got[:cout], want[:cout]), f"K9 B1 {dt}: routes past a NaN")
        require(torch.equal(torch.isnan(got[cout:]), nan_sgx) and
                torch.equal(torch.isnan(gz), nan_gz), f"K9 B1 / g_z {dt}: NaNs differ")
        require(d <= (2e-4 if dt == torch.float32 else 2e-2) * gz_want.float()[fin].abs().max(),
                f"K9 g_z {dt}: {d:.3e} from the plain version past the NaNs")


# K9's B1 and g_z at ragged shapes: (B, Cout, F, T, pf, g misaligned): T % 4 != 0
# (one frame at a time: 130, 515, 777), T % 4 == 0 (16-byte quads: 300, 4800),
# a g view one element off its 16-byte boundary (quads one frame at a time),
# pf 1, 2 and 3 (two quads a lane), 8 and 16 (one; 16 in two chunks of rows)
ROUTE_CASES = [(2, 72, 16, 130, 1, False), (2, 72, 16, 515, 2, False),
               (1, 40, 24, 777, 3, False), (2, 72, 16, 300, 8, False),
               (1, 24, 32, 4800, 16, False), (2, 40, 16, 300, 16, True),
               (1, 72, 4, 1000, 2, False)]


def k9_route_ragged(torch, card: str) -> None:
    """K9's B1 and g_z at ROUTE_CASES in both dtypes against their plain
    versions, on pre on a grid of quarters (ties in most windows) with scale
    and bias on grids (the kernels' fused pre * scale + bias and the plain
    version's then equal, so both route alike), and B1 bitwise on a rerun."""
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    for b, cout, f, t, pf, shifted in ROUTE_CASES:
        # pre, scale and bias on grids: pre * scale + bias exact, fused or not
        pre = torch.randint(-8, 9, (b, cout, f, t), generator=gen, device=dev).float() / 4
        grid = lambda lo, hi, step: torch.randint(lo, hi, (cout,), generator=gen,
                                                  device=dev).float() * step
        cols = torch.stack([0.5 + grid(0, 9, 1 / 8), grid(-4, 5, 1 / 16),
                            0.1 * torch.randn(cout, generator=gen, device=dev),
                            0.5 + torch.rand(cout, generator=gen, device=dev),
                            1e-3 * torch.randn(cout, generator=gen, device=dev),
                            1e-3 * torch.randn(cout, generator=gen, device=dev)])
        for dt in (torch.float32, torch.bfloat16):
            n = b * cout * (f // pf) * t
            flat = torch.randn(n + 1, generator=gen, device=dev).to(dt)
            g = (flat[1:] if shifted else flat[:n]).view(b, cout, f // pf, t)
            tag = f"B {b} Cout {cout} F {f} T {t} pf {pf}{' g off 16 B' if shifted else ''}"
            sel = k9.ct_sel_stats(pre, g, cols, pf)
            compare(torch, "ct_train_sel_stats", f"T{t} pf{pf}", sel,
                    k9.ct_sel_stats_plain(pre, g, cols, pf), torch.float32, card)
            require(torch.equal(k9.ct_sel_stats(pre, g, cols, pf), sel),
                    f"K9 B1 {tag} {dt}: not repeatable")
            compare(torch, "ct_train_gz", f"T{t} pf{pf}", k9.ct_gz(pre, g, cols, pf),
                    k9.ct_gz_plain(pre, g, cols, pf), dt, card)
            print(f"[kernel] K9 B1 / g_z {tag} {str(dt)[6:]}: within tolerance, B1 bitwise "
                  f"on a rerun ({card})")
        del pre, cols


# K9's B1 and g_z timed at the flagship's stages 2 and 3 (Cout 192, T 4800), and
# at stage 2's F with pf 16, where g_z reads the first 8 rows of a window again:
# (label, F, pf, L2 flushed); stage 3's pre (29.5 MB at batch 2) fits in the 50
# MB L2
ROUTE_STAGES = (("stage 2", 32, 8, False), ("stage 3", 4, 2, True),
                ("stage 2 pf 16", 32, 16, False))
ROUTE_BATCHES = (2, 8)
L2_FLUSH_BYTES = 64 << 20


def k9_route_times(torch, card: str, k9, batches=ROUTE_BATCHES) -> dict:
    """K9's B1 (``k9.ct_sel_stats``) and g_z (``k9.ct_gz``) at ROUTE_STAGES,
    per batch and dtype, on random pre and g: CUDA events (time_ms, the
    wrapper's host path included), back to back (stream_ms) and device time
    (the profiler's self device time of every kernel a call launches, B1's
    reduction included), with the achieved TB/s and the share of the byte
    bound (pre and g read once, gz written once, over 3.35 TB/s) of the
    device time. Stage 3 runs each launch after a 64 MB write that flushes
    the L2, as the pallas-ct step finds pre cold; the write is outside the
    events, and taken off the back-to-back and device times. ``k9`` is a
    ``conv2d_ct_train`` module (this tree's, or another tree's with
    ``--k9-route DIR``). Returns {"<stage> batch B dtype pass": numbers}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush = lambda: flush_buf.fill_(1)
    flush_keys = set(device_split(torch, flush))
    flush_b2b = stream_ms(torch, flush)
    cout, t = 192, 4800
    out = {}
    for stage, f, pf, cold in ROUTE_STAGES:
        for b in batches:
            pre = torch.randn(b, cout, f, t, generator=gen, device=dev)
            cols = torch.stack([1.0 + 0.2 * torch.randn(cout, generator=gen, device=dev),
                                0.2 * torch.randn(cout, generator=gen, device=dev),
                                0.1 * torch.randn(cout, generator=gen, device=dev),
                                1.0 + 0.1 * torch.rand(cout, generator=gen, device=dev),
                                1e-3 * torch.randn(cout, generator=gen, device=dev),
                                1e-3 * torch.randn(cout, generator=gen, device=dev)])
            for dt in (torch.bfloat16, torch.float32):
                g = torch.randn(b, cout, f // pf, t, generator=gen, device=dev).to(dt)
                gz = k9.ct_gz(pre, g, cols, pf)
                for name, fn, moved in (
                        ("B1", lambda: k9.ct_sel_stats(pre, g, cols, pf), nbytes(pre, g)),
                        ("g_z", lambda: k9.ct_gz(pre, g, cols, pf), nbytes(pre, g, gz))):
                    run = (lambda fn=fn: (flush(), fn())) if cold else fn
                    ev = time_ms(torch, fn, before=flush if cold else None)
                    b2b = stream_ms(torch, run) - (flush_b2b if cold else 0.0)
                    split = whole_device_split(torch, run, flush_keys)
                    dev_ms = sum(split.values())
                    bound_ms = moved / HBM_BYTES_PER_S * 1e3
                    tag = f"{stage} batch {b} {str(dt)[6:]} {name}"
                    out[tag] = {"ms": ev, "stream_ms": b2b, "device_ms": dev_ms,
                                "bound_ms": bound_ms, "tb_s": moved / dev_ms / 1e9,
                                "share": bound_ms / dev_ms,
                                "kernels": sorted(re.search(r"\w+_kernel(<[^()]*>)?", k)[0]
                                                  for k in split)}
                    print(f"[k9 route] {tag}{' (L2 flushed)' if cold else ''}: events {ev:.4f} "
                          f"ms, back to back {b2b:.4f} ms, device {dev_ms:.4f} ms; "
                          f"{moved / dev_ms / 1e9:.3f} TB/s, {100 * bound_ms / dev_ms:.1f}% of "
                          f"the byte bound {bound_ms:.4f} ms ({card})")
                del g, gz
            del pre, cols
    del flush_buf
    torch.cuda.empty_cache()
    return out


def whole_device_split(torch, fn, leave_out=(), iters: int = 20, tries: int = 3) -> dict:
    """device_split of fn() without the kernels named in ``leave_out``, taken
    again (at most ``tries`` times) until every kernel left ran ``iters``
    times: a capture that lost a launch read K9's float32 B1 at batch 8
    above its byte bound."""
    from seld_tpu_torch.utils.profiling import device_events

    fn()
    for _ in range(tries):
        events, _ = device_events(lambda: [fn() for _ in range(iters)])
        kept = [e for e in events if e.key not in leave_out]
        if kept and all(e.count == iters for e in kept):
            return {e.key: e.self_device_time_total / 1e3 / iters for e in kept}
    raise SmokeFailure(f"no whole capture of {iters} calls in {tries} tries: "
                       f"{[(e.key[:60], e.count) for e in kept]}")


def dx_plain_f32(gz, w):
    """dh in float32 without cuDNN (a float32 GEMM and col2im, TF32 off), the
    float32 plain version of dh's float64 gate, whatever algorithm cuDNN's
    float32 dgrad picks (printed beside as the library)."""
    import torch
    from seld_tpu_torch.ops.kernels.conv2d_ct_train import ct_dx_plain

    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        return ct_dx_plain(gz, w)


def dw_plain_f32(h, gz):
    """dW in float32 without cuDNN (im2col and a float32 GEMM, TF32 off), the
    float32 plain version of the float64 gate: cuDNN's float32 wgrad at the
    flagship's stage 2 is far from float32-faithful (PERF.md)."""
    import torch
    from seld_tpu_torch.ops.kernels.conv2d_train import dw_plain

    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        return dw_plain(h, gz)


def ulps_apart(torch, got, want) -> int:
    """Elements of got further than one ulp of got's dtype (at want) from want."""
    torch.cuda.synchronize()
    bits = 23 if got.dtype == torch.float32 else 7
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want.float()), e - 1 - bits)
    return int(((got.float() - want.float()).abs() > ulp).sum())


def phase_k7_k8(torch, card: str, record) -> None:
    """K7 (forward, and the autograd Function's dx, dcomps, db against plain
    autograd) and K8 against their plain versions at ragged multi-tile
    shapes and at the flagship's (batch 2: M = 9600 for the 20 pointwise
    convs, 1200 for the 2 heads), in float32 and bfloat16; records the
    flagship M = 9600 bf16 runs and prints the float32 ones."""
    from seld_tpu_torch.ops.hamilton import assemble_hamilton
    from seld_tpu_torch.ops.kernels import qmatmul as k7
    from seld_tpu_torch.ops.kernels import quant as k8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    k7_cases = [  # tag, M, n, cin_c, cout_c, linear_table: tables Q, DQ conv, DQ linear
        ("ragged", 1037, 4, 12, 20, False),
        ("ragged", 1037, 8, 6, 10, False),
        ("ragged", 1037, 8, 6, 10, True),
        ("ragged", 1029, 4, 5, 16, False),      # K % 8 != 0: bf16 x by 2-byte loads
        ("ragged", 513, 8, 3, 16, True),        # K % 16 != 0: a zero-filled k16 step
        ("ragged", 777, 4, 96, 24, True),       # the Q configs' cin_c
        ("flagship", 9600, 8, 48, 48, False),   # the ResBlocks' skip / res convs
        ("flagship", 1200, 8, 48, 48, True),    # the FC heads
    ]
    for tag, m, n, cin_c, cout_c, table in k7_cases:
        for dt in (torch.float32, torch.bfloat16):
            x, comps = randn(m, n * cin_c).to(dt), (randn(n, cin_c, cout_c) / cin_c ** 0.5).to(dt)
            bias = randn(n * cout_c).to(dt)
            kern = lambda: k7.hamilton_matmul(x, comps, bias, n, table)
            plain = lambda: k7.hamilton_matmul_plain(x, comps, bias, n, table)
            timed = (time_ms(torch, kern), time_ms(torch, plain)) if m == 9600 else None
            label = f"{tag}/{'q' if n == 4 else 'dq'}-{'lin' if table else 'conv'}/{m}"
            got = kern()
            d = compare(torch, "hamilton_matmul", label, got, plain(), dt, card, timed)
            if m == 9600:
                w_full = assemble_hamilton(comps, table).contiguous()
                lib = lambda: torch.addmm(bias, x, w_full)
                lib_ms = time_ms(torch, lib)
                flops, moved = 2.0 * m * n * cin_c * n * cout_c, nbytes(x, comps, bias, got)
                print(f"[kernel] hamilton_matmul {str(dt)[6:]} M {m} device time (profiler): "
                      f"kernel {device_ms(torch, kern):.4f} ms, addmm "
                      f"{device_ms(torch, lib):.4f} ms ({card})")
                if dt == torch.bfloat16:
                    record("hamilton_matmul", d, timed, flops, moved, "bfloat16", lib_ms)
                else:
                    bound_ms, bound_by = bound(flops, moved, "float32")
                    print(f"[kernel] hamilton_matmul f32 M {m}: {timed[0]:.3f} ms, plain "
                          f"{timed[1]:.3f} ms, library (addmm) {lib_ms:.3f} ms, bound "
                          f"{bound_ms:.4f} ms by {bound_by} ({card})")
                    f32_row(card, "hamilton_matmul", f"M {m}", timed[0], lib_ms, flops, moved,
                            split_tf32=True)
                    # the split-TF32 kernel against the plain version in float64: the
                    # forward, and dx through the autograd Function (K7 on the conjugate)
                    f64_gate(card, "hamilton_matmul", f"M {m} out", got, plain(),
                             k7.hamilton_matmul_plain(x.double(), comps.double(),
                                                      bias.double(), n, table))
                    g = randn(m, n * cout_c)
                    dx = []
                    for fn, dt_ in ((k7._HamiltonMatmulFn.apply, torch.float32),
                                    (k7.hamilton_matmul_plain, torch.float32),
                                    (k7.hamilton_matmul_plain, torch.float64)):
                        leaf = x.detach().to(dt_).clone().requires_grad_()
                        (fn(leaf, comps.to(dt_), bias.to(dt_), n, table) * g.to(dt_)).sum() \
                            .backward()
                        dx.append(leaf.grad)
                    f64_gate(card, "hamilton_matmul", f"M {m} dx", *dx)
                    require(torch.equal(kern(), got), f"hamilton_matmul f32 M {m}: "
                            "not repeatable")
            if tag == "ragged":
                # the autograd Function (K7 forward, K7 on the conjugate for dx)
                g = randn(m, n * cout_c).to(dt)
                results = []
                for fn in (k7._HamiltonMatmulFn.apply, k7.hamilton_matmul_plain):
                    leaves = [a.clone().requires_grad_() for a in (x, comps, bias)]
                    (fn(*leaves, n, table).float() * g.float()).sum().backward()
                    results.append([a.grad for a in leaves])
                for name, a, w_ in zip(("dx", "dcomps", "db"), *results):
                    compare(torch, "hamilton_matmul_fn", f"{label} {name}", a, w_, dt, card)

    k8_cases = [  # tag, M, Cin, Cout
        ("ragged", 1037, 48, 80),
        ("ragged", 129, 30, 7),
        ("ragged", 20, 30, 80),   # under one block; Cin 30: k padded to 32, x element by element
        ("flagship", 9600, 384, 384),
        ("flagship", 4800, 384, 384),   # a clip
        ("flagship", 1200, 384, 384),
    ]
    for tag, m, cin, cout in k8_cases:
        w_q, w_s = k8.quantize_weight_per_channel(randn(cin, cout) / cin ** 0.5)
        xf = randn(m, cin) * torch.rand(m, 1, generator=gen, device=dev) * 4
        xf[3] = 0.0   # amax = 0: the bias alone
        for dt in (torch.float32, torch.bfloat16):
            x, bias = xf.to(dt), randn(cout).to(dt)
            kern = lambda: k8.int8_matmul(x, w_q, w_s, bias)
            plain = lambda: k8.int8_matmul_plain(x, w_q, w_s, bias)
            timed = (time_ms(torch, kern), time_ms(torch, plain)) if m == 9600 else None
            got, want = kern(), plain()
            apart = ulps_apart(torch, got, want)
            differ = int((got.float() != want.float()).sum())
            d = (got.float() - want.float()).abs().max().item()
            msg = (f"[kernel] int8_matmul       {tag}/{m:<5d} {str(dt)[6:]:8s} shape "
                   f"{tuple(got.shape)} max|d| {d:.3e}; {differ} of {got.numel()} elements "
                   f"differ, {apart} by more than one ulp")
            if timed is not None:
                msg += f" | kernel {timed[0]:.3f} ms plain {timed[1]:.3f} ms ({card})"
            print(msg)
            require(apart == 0 and torch.equal(got[3].float(), bias.float()),
                    f"int8_matmul {tag} {dt}: {apart} elements beyond one ulp")
            for name, tiles in K8_TILES.items():   # each row tile: the same bits
                require(torch.equal(int8_matmul_tiles(k8, tiles, x, w_q, w_s, bias), got),
                        f"int8_matmul {tag}/{m} {dt}: {name} blocks not bit-equal")
            if tag == "flagship" and dt == torch.bfloat16 and m != 4800:
                # no single PyTorch call quantizes the rows and dequantizes: the
                # int8 GEMM alone on the pre-quantized operands, and a bf16 addmm;
                # each by events, back to back and in device time (the profiler)
                xq = k8.quantize_rows(x)[0].to(torch.int8)
                w_deq = (w_q.float() * w_s).to(dt)
                calls = {"K8": kern, "torch._int_mm": lambda: torch._int_mm(xq, w_q),
                         "bf16 addmm": lambda: torch.addmm(bias, x, w_deq)}
                ms = {n: (time_ms(torch, f), stream_ms(torch, f),
                          statistics.median(device_ms(torch, f) for _ in range(3)))
                      for n, f in calls.items()}
                print(f"[kernel] int8_matmul M {m} bf16, events / back to back / device (ms): "
                      + "; ".join(f"{n} {a:.4f} / {b:.4f} / {c:.4f}" for n, (a, b, c)
                                  in ms.items()) + f" ({card})")
                print(f"[kernel] int8_matmul M {m} bf16, K8's device time by kernel: "
                      + "; ".join(f"{k[:60]} {v:.4f} ms" for k, v in
                                  device_split(torch, kern).items()) + f" ({card})")
                if m == 9600:
                    record("int8_matmul", d, timed, 2.0 * m * cin * cout,
                           nbytes(x, w_q, w_s, bias, got), "int8", None,
                           stream_ms=ms["K8"][1], device_ms=ms["K8"][2],
                           int_mm_ms=ms["torch._int_mm"][0],
                           int_mm_device_ms=ms["torch._int_mm"][2],
                           addmm_ms=ms["bf16 addmm"][0], addmm_device_ms=ms["bf16 addmm"][2])

    # K8's two row tiles, device time in turns (each, then each again in
    # reverse) at Cin = Cout = 384, bf16; each reading the median of three
    # profiles, since the profiler drops a window's launches in some runs
    # (host-bound back-to-back events cannot resolve them)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in K8_AB_M:
        w_q, w_s = k8.quantize_weight_per_channel(randn(384, 384) / 384 ** 0.5)
        x, bias = randn(m, 384).bfloat16(), randn(384).bfloat16()
        times = {name: [] for name in K8_TILES}
        for names in (list(K8_TILES), list(reversed(K8_TILES))):
            for name in names:
                run = lambda: int8_matmul_tiles(k8, K8_TILES[name], x, w_q, w_s, bias)
                times[name].append(statistics.median(device_ms(torch, run) for _ in range(3)))
        print(f"[kernel] int8_matmul row tiles M {m} bf16, device ms in turns: "
              + "; ".join(f"{n} {' / '.join(f'{v:.4f}' for v in t)}" for n, t in times.items())
              + f"; the wrapper's tile {k8.row_tile(m, 384, 384, sms)} ({card})")


def phase_frontend_kernels(torch, card: str, randn, record) -> None:
    """K2w, K10a (with its patch build) and K10b against their plain versions
    at ragged multi-tile shapes and at the flagship's stages (batch 2),
    float32 and bfloat16, each flagship run beside cuDNN's conv of the
    stage. For K2w and K10a in both dtypes also: the operand build alone
    (K2w's torch pack, K10a's patch kernel) and the product alone on the
    built operands (the two public functions each wrapper calls), and
    wrapper and cuDNN back to back; in float32 (the split-TF32 tile) the
    float64 gate (F64_FACTOR) at the flagship's stages (K2w stage 1, K10a
    stages 1-3) and the three TF32 products' bound. Records, bf16, K2w,
    K10a and K10a's patch kernel at stage 1 and K10b at stage 2. Every
    ``ms`` is its wrapper's, as ``plain_ms`` and ``library_ms`` are the
    whole function's; K2w's and K10a's entries add ``operands_ms`` and
    ``product_ms`` (the wrapper's two parts), ``stream_ms`` and
    ``library_stream_ms`` (back to back), and their float32 rows the same
    under ``f32``. The bound is the function's (x + w + out bytes, 2 * 9 *
    Cin * Cout operations per output pixel; the patch build: x +
    patches): the packs' bytes are the designs' cost."""
    from seld_tpu_torch.ops.kernels import conv2d_pool as pool

    F = torch.nn.functional
    fns = {  # launch-count name -> (kernel wrapper, plain version)
        "conv3x3_smallcin_wide": (pool.conv2d_smallcin_wide_bn_relu_fpool,
                                  pool.conv2d_smallcin_wide_bn_relu_fpool_plain),
        "conv3x3_im2col": (pool.conv2d_im2col_bn_relu_fpool,
                           pool.conv2d_im2col_bn_relu_fpool_plain),
        "conv3x3_windows": (pool.conv2d_windows_bn_relu_fpool, pool.conv2d_bn_relu_fpool_plain),
    }

    def operands(name, x, w, scale, bias, pf):
        """(the wrapper's operand build, its product on the built operands):
        the two public functions each wrapper calls in turn"""
        if name == "conv3x3_smallcin_wide":
            built = pool.smallcin_pack(x, w)
            return (lambda: pool.smallcin_pack(x, w),
                    lambda: pool.smallcin_wide_product(*built, scale, bias, pf, x.shape[3],
                                                       x.shape[1]))
        built = pool.im2col_operands(x, w)
        return (lambda: pool.im2col_operands(x, w),
                lambda: pool.im2col_product(*built, scale, bias, pf))

    stage = {1: (2, CHANNELS, 256, 4800, 192, 8), 2: (2, 192, 32, 4800, 192, 8),
             3: (2, 192, 4, 4800, 192, 2)}
    cases = [  # name, tag, (B, Cin, F, T, Cout, pf): 3 T tiles (the last ragged), >= 2
        # Cout tiles, several pool groups, F borders; kg 16 and 32; a ragged Cin chunk
        ("conv3x3_smallcin_wide", "ragged", (2, 5, 24, 300, 80, 8)),
        ("conv3x3_smallcin_wide", "ragged", (2, 8, 8, 130, 64, 2)),
        ("conv3x3_smallcin_wide", "ragged", (1, 10, 12, 257, 200, 4)),
        ("conv3x3_im2col", "ragged", (2, 3, 24, 300, 80, 8)),
        ("conv3x3_im2col", "ragged", (2, 12, 8, 130, 64, 2)),
        ("conv3x3_im2col", "ragged", (1, 20, 12, 257, 200, 4)),
        ("conv3x3_windows", "ragged", (2, 12, 24, 300, 80, 8)),
        ("conv3x3_windows", "ragged", (2, 20, 9, 130, 64, 3)),
        ("conv3x3_windows", "ragged", (1, 200, 12, 257, 72, 4)),
        *((n, "stage1", stage[1]) for n in fns),
        *((n, f"stage{i}", stage[i]) for i in (2, 3)
          for n in ("conv3x3_im2col", "conv3x3_windows")),
    ]
    recorded = {"conv3x3_smallcin_wide": "stage1", "conv3x3_im2col": "stage1",
                "conv3x3_windows": "stage2"}
    for name, tag, (b, cin, f, t, cout, pf) in cases:
        kern_fn, plain_fn = fns[name]
        xf = randn(b, cin, f, t).abs()
        wf = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        scale = randn(cout, scale=0.2) + 1.0
        bias = randn(cout, scale=0.2)
        for dt in (torch.float32, torch.bfloat16):
            x, w = xf.to(dt), wf.to(dt)
            k = lambda: kern_fn(x, w, scale, bias, pf)
            p = lambda: plain_fn(x, w, scale, bias, pf)
            flag = tag != "ragged"
            timed = (time_ms(torch, k), time_ms(torch, p)) if flag else None
            got = k()
            d = compare(torch, name, tag, got, p(), dt, card, timed)
            if name == "conv3x3_im2col":   # the patch kernel, bit for bit the torch build
                k_align = 8 if dt == torch.bfloat16 else 1
                patches, want = pool.im2col(x, k_align), pool.im2col_patches(x, k_align)
                require(torch.equal(patches, want), f"im2col_patches {tag} {dt}: differs "
                        f"from the torch build")
                if flag and dt == torch.bfloat16 and tag == recorded[name]:
                    record("im2col_patches", 0.0,
                           (time_ms(torch, lambda: pool.im2col(x, 8)),
                            time_ms(torch, lambda: pool.im2col_patches(x, 8))),
                           0.0, nbytes(x, patches), "bfloat16", None)
                del patches, want
            if not flag:
                continue
            w_nchw = w.permute(3, 2, 0, 1).contiguous()
            lib = lambda: F.conv2d(x, w_nchw, padding=1)
            lib_ms = time_ms(torch, lib)
            flops, moved = 2.0 * 9 * cin * cout * b * f * t, nbytes(x, w, got)
            dt_name = str(dt)[6:]
            parts = {}
            if name != "conv3x3_windows":
                build, product = operands(name, x, w, scale, bias, pf)
                parts = {"operands_ms": time_ms(torch, build),
                         "product_ms": time_ms(torch, product),
                         "stream_ms": stream_ms(torch, k),
                         "library_stream_ms": stream_ms(torch, lib)}
                print(f"[kernel] {name} {tag} {dt_name}: wrapper {timed[0]:.3f} ms (back to back "
                      f"{parts['stream_ms']:.3f}) = operands built {parts['operands_ms']:.3f} ms "
                      f"(back to back {stream_ms(torch, build):.3f}) + product "
                      f"{parts['product_ms']:.3f} ms (back to back "
                      f"{stream_ms(torch, product):.3f}); cuDNN {lib_ms:.3f} ms, back to back "
                      f"{parts['library_stream_ms']:.3f} ms ({card})")
                del build, product
            if dt == torch.bfloat16 and recorded[name] == tag:
                record(name, d, timed, flops, moved, "bfloat16", lib_ms, **parts)
            elif dt == torch.float32:   # K2w, K10a, K10b: split-TF32 tiles
                f32_row(card, name, tag, timed[0], lib_ms, flops, moved, split_tf32=True)
                F32_ROWS[name][tag].update(parts)
                # within F64_FACTOR x the float32 plain version's distance
                # from float64, and bitwise on a rerun
                exact = plain_fn(x.double(), w.double(), scale.double(), bias.double(), pf)
                f64_gate(card, name, tag, got, p(), exact)
                require(torch.equal(k(), got), f"{name} {tag} float32: not repeatable")
                del exact
            else:
                bound_ms, bound_by = bound(flops, moved, dt_name)
                print(f"[kernel] {name} {tag} {dt_name}: {timed[0]:.3f} ms, plain "
                      f"{timed[1]:.3f} ms, library {lib_ms:.3f} ms, bound {bound_ms:.4f} ms by "
                      f"{bound_by}{', loses' if timed[0] > lib_ms else ''} ({card})")
        del xf, wf


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
    require(all(counts[k] > 0 for k in SERVING_KERNELS),
            f"a kernel of the serving path never ran: {counts}")
    require(counts["stft_mag"] == REQUESTS and counts["conv3x3_smallcin"] == REQUESTS,
            f"K1 and K2 must launch once per request: {counts}")

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
    print(f"[main] the {REQUESTS} counted requests: "
          f"{[round(1e3 * v, 1) for v in latencies]} ms ({card})")
    window = timed_window(torch, HOST_WINDOW, lambda i: serve(
        model, torch.from_numpy(requests[i % REQUESTS]).to(dev)))
    print(f"[main] from host memory, {CLIPS_PER_REQUEST} clips per request: "
          f"{window_summary(window, audio_h)} ({card})")

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
    serve_on_card(torch, model, card)
    return counts


def timed_window(torch, n: int, run) -> list:
    """Host seconds of each of ``n`` back-to-back requests ``run(i)``, each
    synchronised with the card before the next starts."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def window_summary(times: list, audio_h: float) -> str:
    """A window's total audio over its total wall time, and its spread."""
    ms = sorted(1e3 * v for v in times)
    p10, p90 = ms[len(ms) // 10], ms[(9 * len(ms)) // 10]
    return (f"{len(ms)} requests in {sum(ms) / 1e3:.3f} s = "
            f"{len(ms) * audio_h / (sum(ms) / 1e3):.4f} audio-hours/s; per request min "
            f"{ms[0]:.2f} p10 {p10:.2f} median {statistics.median(ms):.2f} p90 {p90:.2f} "
            f"max {ms[-1]:.2f} ms")


def serve_on_card(torch, model, card: str) -> None:
    """The serving forward with the audio already on the card, at each batch
    of SERVE_ON_CARD_BATCHES: a window of CARD_WINDOW requests (host clock
    around each synchronised ``serve``) as audio-hours/s, then one profiled
    request (device time by kernel, the device's idle share)."""
    from seld_tpu_torch.ops.kernels.conv2d_pool import conv2d_smallcin_bn_relu_fpool
    from seld_tpu_torch.ops.kernels.stft import stft_mag
    from seld_tpu_torch.serve import serve

    gen = torch.Generator(device="cuda").manual_seed(4)
    w1 = (torch.randn(3, 3, CHANNELS, 192, generator=gen, device="cuda") / 8).bfloat16()
    s1, b1 = torch.ones(192, device="cuda"), torch.zeros(192, device="cuda")
    for batch in SERVE_ON_CARD_BATCHES:
        audio = torch.randn(batch, CHANNELS, SR * CLIP_SECONDS, generator=gen, device="cuda")
        sed, _ = serve(model, audio)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(sed).all()), f"batch {batch}: non-finite sed")
        window = timed_window(torch, CARD_WINDOW, lambda i: serve(model, audio))
        print(f"[main] audio on the card, batch {batch}: "
              f"{window_summary(window, batch * CLIP_SECONDS / 3600.0)} ({card})")
        profiled = profile_step(torch, lambda: serve(model, audio), card, top=8,
                                label=f"serving request, batch {batch}, audio on the card",
                                watch=SERVING_WATCH)
        print(f"[profile] serving request, batch {batch}: "
              f"{device_shares(profiled, SERVING_WATCH)} ({card})")
        # K1 and K2 back to back at the request's shapes, beside the profile
        k1 = stream_ms(torch, lambda: stft_mag(audio, out_dtype=torch.bfloat16))
        x1 = torch.randn(batch, CHANNELS, 256, 4800, generator=gen, device="cuda").bfloat16()
        k2 = stream_ms(torch, lambda: conv2d_smallcin_bn_relu_fpool(x1, w1, s1, b1, 8))
        busy = profiled["busy"]
        print(f"[profile] serving request, batch {batch}, K1 and K2 back to back at its "
              f"shapes: K1 {k1:.2f} ms ({100 * k1 / busy:.1f}%), K2 {k2:.2f} ms "
              f"({100 * k2 / busy:.1f}%) of {busy:.1f} ms busy ({card})")
        del audio, sed, x1
    torch.cuda.empty_cache()



def set_dropout(model, rate: float) -> None:
    from seld_tpu_torch.models.layers import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = rate


def profile_step(torch, run, card: str, top: int = 14, label: str = "one bf16 step",
                 watch: dict = PROFILE_WATCH) -> dict:
    """One more step under torch.profiler: device time by kernel (top
    ``top`` by self device time) and the device's idle share of the step;
    returns the device ms of each ``watch`` group in it and of the whole
    step ("busy")."""
    from seld_tpu_torch.utils.profiling import device_events

    # device kernels only: a CPU op also reports the device time it launched
    events, wall_ms = device_events(run, cpu=True)
    self_ms = lambda e: e.self_device_time_total / 1e3
    busy = sum(self_ms(e) for e in events)
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall_ms:.3f}, {sum(e.count for e in events)} device "
          f"kernels ({card})")
    for e in sorted(events, key=self_ms, reverse=True)[:top]:
        print(f"[profile]   {self_ms(e):8.2f} ms {100 * self_ms(e) / busy:5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}")
    twice = [e.key for e in events if len(watched(e.key, watch)) > 1]
    require(not twice, f"{label}: kernels in two watch groups: {twice}")
    groups = {name: sum(self_ms(e) for e in events if name in watched(e.key, watch))
              for name in watch}
    return {"busy": busy, **groups}


def watched(key: str, watch: dict) -> list:
    """The ``watch`` groups whose stems match the device kernel ``key`` (the
    profiler's demangled name): a stem matches where no letter, digit or _
    precedes it, so ``sel_stats_kernel<float>`` (K5's B1) is not found in a
    longer name that ends the same way."""
    return [name for name, stems in watch.items()
            if any(re.search(r"(?<!\w)" + re.escape(k), key) for k in stems)]


def device_shares(profiled: dict, watch: dict = PROFILE_WATCH) -> str:
    """'<group> <ms> ms (<share>%), ...' of every ``watch`` group, shares of
    device busy."""
    busy = profiled["busy"]
    return ", ".join(f"{name} {profiled[name]:.2f} ms ({100 * profiled[name] / busy:.1f}%)"
                     for name in watch)


def take_bn_statistics_in_float64(torch, model) -> None:
    """A control of phase 5a: every train-mode BatchNorm of ``model`` takes
    its batch statistics (E[x^2] - E[x]^2) in float64 and normalizes in the
    input's dtype; the port's BatchNorm takes them in float32."""
    import types

    from seld_tpu_torch.models.layers import BN_EPS, BatchNorm

    def forward(self, x, train=False, cross_rank=None):
        if not train:
            return BatchNorm.forward(self, x, train)
        axes = tuple(range(x.ndim - 1))
        xd = x.double()
        mean = xd.mean(axes)
        var = ((xd * xd).mean(axes) - mean * mean).clamp_min(0.0)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        self.update_running(mean, var, x.numel() // x.shape[-1])
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) + self.bias

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.forward = types.MethodType(forward, m)


def stage0_route_study(torch, x, w, gamma, beta, pool_f: int) -> None:
    """CNN stage 0 alone at the flagship's shape, on phase 5a's batch x
    (B, C, F, T): dW, dgamma and dbeta of one seeded cotangent as
    relative norm distances from float64, for the plain stage in float32, the
    same with its batch statistics taken in float64, the K5 op in float32,
    and float64 routed through the windows and ReLU edges the float32 plain
    stage chose; with the number of pool windows each run routes apart from
    float64. Prints; checks only that every gradient is finite."""
    from seld_tpu_torch.ops.kernels import conv2d_train as k5

    F = torch.nn.functional
    b, _, f, t = x.shape
    cout = w.shape[-1]
    gen = torch.Generator(device=x.device).manual_seed(7)
    g = torch.randn(b, cout, f // pool_f, t, generator=gen, device=x.device)

    def plain(dt, stats_dt=None, route=None):
        """The plain stage (conv, batch-statistics BN, ReLU, first-max pool);
        returns its gradients in float64 and its route (row, kept) per window."""
        wr, gr, br = (a.to(dt).clone().requires_grad_() for a in (w, gamma, beta))
        z = F.conv2d(x.to(dt), wr.permute(3, 2, 0, 1), padding=1)        # (B, C, F, T)
        zs = z.to(stats_dt or dt)
        mean = zs.mean((0, 2, 3))
        var = ((zs * zs).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        scale = gr * torch.rsqrt(var.to(dt) + 1e-5)
        y = z * scale[:, None, None] + (br - mean.to(dt) * scale)[:, None, None]
        y = y.unflatten(2, (f // pool_f, pool_f))                         # (B, C, F', pf, T)
        if route is None:
            with torch.no_grad():
                top, row = y.max(dim=3)                                   # first max
            route = (row, top > 0)
        row, kept = route
        out = y.gather(3, row.unsqueeze(3)).squeeze(3) * kept
        (out * g.to(dt)).sum().backward()
        return [a.grad.double() for a in (wr, gr, br)], route

    def apart(r1, r2) -> int:
        return int(((r1[1] != r2[1]) | (r1[1] & (r1[0] != r2[0]))).sum())

    def dist(a, ref) -> str:
        return ", ".join(f"{((u - v).norm() / v.norm()).item():.3e}" for u, v in zip(a, ref))

    ref, r64 = plain(torch.float64)
    p32, r32 = plain(torch.float32)
    s32, rs32 = plain(torch.float32, stats_dt=torch.float64)
    routed, _ = plain(torch.float64, route=r32)
    wr, gr, br = (a.clone().requires_grad_() for a in (w, gamma, beta))
    out, _, _ = k5.conv2d_bn_relu_fpool_train(x.permute(0, 2, 3, 1), wr, gr, br, pool_f)
    (out * g.permute(0, 2, 3, 1)).sum().backward()
    kern = [a.grad.double() for a in (wr, gr, br)]
    windows = r64[0].numel()
    require(all(bool(torch.isfinite(a).all()) for a in (*ref, *p32, *s32, *routed, *kern)),
            "stage 0 study: non-finite gradient")
    print(f"[route] stage 0 alone, batch {b}: (dW, dgamma, dbeta) "
          f"relative norm from float64, {windows} pool windows")
    print(f"[route]   plain f32: {dist(p32, ref)}; windows routed apart from float64: "
          f"{apart(r32, r64)}")
    print(f"[route]   plain f32, batch statistics in float64: {dist(s32, ref)}; routed apart: "
          f"{apart(rs32, r64)}")
    print(f"[route]   K5 op f32: {dist(kern, ref)}")
    print(f"[route]   float64 routed as plain f32: {dist(routed, ref)}; from plain f32 "
          f"{dist(routed, p32)}")


def phase_training(torch, card: str) -> dict:
    """(a) the f32 kernel path against the plain path, one step; (b) bf16
    training at TRAIN_BATCH; returns the launch counts of (b)'s timed steps."""
    import copy

    import numpy as np

    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.data.synthetic import make_task2_batch
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9
    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from seld_tpu_torch.ops.kernels.conv2d_train import dw_plain
    from seld_tpu_torch.serve import build_flagship
    from seld_tpu_torch.training import create_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = load_config(str(FLAGSHIP_CONFIG))
    ct_dw = k9.ct_dw
    rng = np.random.default_rng(0)

    def batch(n):
        x, y = make_task2_batch(rng, n, channels=CHANNELS, freq=cfg.freq_dim,
                                time_frames=4800, label_frames=600)
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    # (a) float32, batch 2, dropout off, one step from the same weights and
    # batch: the kernel path, the plain path, the plain path in float64 as
    # the exact reference, and two controls on the plain path. At this size
    # the float32 gradient below the attention is ill-conditioned: moving
    # stage 0's BN bias by one ulp moves it by ~1e-3, so no two float32 paths
    # agree to 1e-3. The plain path's float32 batch statistics (E[x^2] -
    # E[x]^2) add to its distance from float64; taken in float64 they leave
    # the rest. So the kernel path's gradients are held to float64: each
    # within TRAIN_GRAD_TOL of it or no further from it than CONTROL_FACTOR x
    # the plain path with float64 batch statistics.
    cfg32 = cfg.replace(compute_dtype="float32", dropout_perc=0.0, spatial_dropout_rate=0.0)
    base = build_flagship(str(FLAGSHIP_CONFIG), torch.float32, dev,
                          torch.Generator().manual_seed(0))
    set_dropout(base, 0.0)
    x, y = batch(2)
    step = make_train_step(cfg32)
    runs = {  # tag: frontend, attention, dtype, control
        "kernel": ("auto", "flash", torch.float32, None),
        # every CNN stage on a kernel: K5, then K9 at stages 2-3 (its split-TF32 dW);
        # the control takes K9's dW in float64 (the plain version) on the same path
        "kernel ct": ("ct", "flash", torch.float32, None),
        "kernel ct, K9 dW in f64": ("ct", "flash", torch.float32, "f64 dW"),
        "plain": ("xla", "full", torch.float32, None),
        "plain f64": ("xla", "full", torch.float64, None),
        "plain, stage 0 bias +1 ulp": ("xla", "full", torch.float32, "ulp"),
        "plain, BN statistics in f64": ("xla", "full", torch.float32, "f64 stats"),
    }
    losses, grads, counts = {}, {}, {}
    for tag, (frontend, attention, dt, control) in runs.items():
        model = copy.deepcopy(base).to(dt)
        model.seld_block.frontend_impl, model.seld_block.tcn.attention.impl = frontend, attention
        if control == "ulp":
            with torch.no_grad():
                bias = model.seld_block.cnn_bn_0.bias
                bias.copy_(torch.nextafter(bias, torch.full_like(bias, float("inf"))))
        elif control == "f64 stats":
            take_bn_statistics_in_float64(torch, model)
        state = create_train_state(model, cfg32, torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        if control == "f64 dW":
            try:
                k9.ct_dw = lambda h, gz: dw_plain(h.double(), gz.double()).float()
                state, loss = step(state, x.to(dt), y.to(dt))
            finally:
                k9.ct_dw = ct_dw
        else:
            state, loss = step(state, x.to(dt), y.to(dt))
        torch.cuda.synchronize()
        counts[tag] = dict(launch_counts)
        losses[tag] = float(loss)
        grads[tag] = {n: p.grad.double() for n, p in model.named_parameters()
                      if p.grad is not None}
        print(f"[train] f32 batch 2, {tag} path: loss {losses[tag]:.8f}, one step "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms")
        if tag in ("kernel", "kernel ct"):   # K5's, K4's, K6's (and K9 dW's) float32 kernels
            f32_step = profile_step(torch, lambda: step(state, x.to(dt), y.to(dt)), card,
                                    label=f"one f32 {tag} step at batch 2",
                                    watch=F32_STEP_WATCH)
            k5_ms = sum(f32_step[k] for k in F32_STEP_WATCH if k.startswith("K5"))
            k9_ms = f32_step["K9 F1"] + f32_step["K9 F2"]
            print(f"[train] f32 {tag} step: {device_shares(f32_step, F32_STEP_WATCH)}; K5's "
                  f"passes {k5_ms:.2f} ms ({100 * k5_ms / f32_step['busy']:.1f}%); K9's F1 + F2 "
                  f"{k9_ms:.2f} ms ({100 * k9_ms / f32_step['busy']:.1f}%) ({card})")
        del model, state
    require(all(counts["kernel"][k] > 0 for k in TRAINING_PATH_F32),
            f"f32 kernel path: a training kernel never ran: {counts['kernel']}")
    # K5's B2 in float32: the g_z pass and the split-TF32 dW tile, once a step
    b2_counts = {tag: [counts[tag][k] for k in ("conv_train_gz", "conv_train_dw")]
                 for tag in ("kernel", "kernel ct")}
    require(all(c == [1, 1] for c in b2_counts.values()),
            f"f32 steps: K5's g_z pass or dW tile not launched once: {b2_counts}")
    require(all(counts["kernel ct"][k] > 0 for k in (*CT_TRAIN_KERNELS, "flash_attn_bwd")
                if k != "ct_train_fwd"), f"f32 pallas-ct path: a kernel never ran: "
            f"{counts['kernel ct']}")
    require(counts["kernel ct, K9 dW in f64"]["ct_train_dw"] == 0,
            "the float64-dW control launched K9's dW")
    require(not any(counts["plain"].values()), f"plain path launched kernels: {counts['plain']}")
    require(all(set(g) == set(grads["plain"]) for g in grads.values()),
            "the paths give gradients to other parameters")

    def rel(a, b):
        return {n: ((grads[a][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                for n, g in grads[b].items()}

    def spread(d):
        w = max(d, key=d.get)
        return f"worst {d[w]:.3e} at {w}, median {statistics.median(d.values()):.3e}"

    k_64, p_64 = rel("kernel", "plain f64"), rel("plain", "plain f64")
    c_64, e_64 = rel("kernel ct", "plain f64"), rel("kernel ct, K9 dW in f64", "plain f64")
    s_64 = rel("plain, BN statistics in f64", "plain f64")
    d_loss = max(abs(losses[k] - losses["plain"]) / abs(losses["plain"])
                 for k in ("kernel", "kernel ct"))
    print(f"[train] f32 kernel vs plain: loss rel {d_loss:.3e} (tol {TRAIN_LOSS_TOL}, the "
          f"worse of auto and ct); {len(k_64)} gradients, {spread(rel('kernel', 'plain'))}; "
          f"ct {spread(rel('kernel ct', 'plain'))}")
    print(f"[train] from float64: kernel path {spread(k_64)}; pallas-ct kernel path "
          f"{spread(c_64)}; plain f32 path {spread(p_64)}")
    print(f"[train] control, pallas-ct with K9's dW in float64, from float64: {spread(e_64)}; "
          f"pallas-ct over it: worst ratio {max(c_64[n] / e_64[n] for n in c_64):.4f}")
    print(f"[train] control, plain f32 with stage 0's BN bias one ulp up, from plain f32: "
          f"{spread(rel('plain, stage 0 bias +1 ulp', 'plain'))}")
    print(f"[train] control, plain f32 with every BN's batch statistics in float64, from "
          f"float64: {spread(s_64)}; kernel path over it: worst ratio "
          f"{max(k_64[n] / s_64[n] for n in k_64):.3f}, pallas-ct "
          f"{max(c_64[n] / s_64[n] for n in c_64):.3f}")
    for n in ("seld_block.cnn_0.w", "seld_block.cnn_bn_0.scale", "seld_block.cnn_1.w",
              "seld_block.tcn.resblock_0.conv_filter.w", "seld_block.tcn.conv1.w",
              "seld_block.tcn.attention.keys.kernel", "sed_out.kernel"):
        print(f"[train]   {n}: from float64, kernel {k_64[n]:.3e}, pallas-ct {c_64[n]:.3e}, "
              f"plain {p_64[n]:.3e}, plain with float64 statistics {s_64[n]:.3e}")
    del base, grads
    torch.cuda.empty_cache()
    stage0 = build_flagship(str(FLAGSHIP_CONFIG), torch.float32, dev,
                            torch.Generator().manual_seed(0)).seld_block
    stage0_route_study(torch, x, stage0.cnn_0.dense_kernel().detach(),
                       stage0.cnn_bn_0.scale.detach(), stage0.cnn_bn_0.bias.detach(),
                       int(cfg.pool_size[0][0]))
    del x, y, stage0
    torch.cuda.empty_cache()
    require(d_loss <= TRAIN_LOSS_TOL, f"f32 losses differ by {d_loss:.3e}")
    over = [n for n in k_64 if k_64[n] > max(TRAIN_GRAD_TOL, CONTROL_FACTOR * s_64[n])]
    require(not over, f"gradients further from float64 than max({TRAIN_GRAD_TOL}, "
            f"{CONTROL_FACTOR} x plain f32 with float64 statistics): "
            f"{[(n, k_64[n], s_64[n]) for n in over]}")
    # the pallas-ct path (K9 at stages 2-3) takes K9's float32 batch statistics
    # and conv rows, as far from float64 as the plain f32 path: held to twice
    # the plain f32 path, and to twice the same path with K9's dW in float64
    # (what the split-TF32 dW adds)
    over = [(n, c_64[n], p_64[n], e_64[n]) for n in c_64
            if c_64[n] > max(TRAIN_GRAD_TOL, CONTROL_FACTOR * min(p_64[n], e_64[n]))]
    require(not over, f"pallas-ct gradients further from float64 than max({TRAIN_GRAD_TOL}, "
            f"{CONTROL_FACTOR} x the plain f32 path's and the K9-dW-in-f64 path's): {over}")

    # (b) bfloat16 at TRAIN_BATCH from synthetic features and targets
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    model = build_flagship(str(FLAGSHIP_CONFIG), torch.bfloat16, dev,
                           torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg16, torch.Generator(device=dev).manual_seed(2))
    step = make_train_step(cfg16)
    x, y = batch(TRAIN_BATCH)
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        state, loss = step(state, x, y)
    torch.cuda.synchronize()
    reset_launch_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = dict(launch_counts)
    print(f"[train] launches during the {TRAIN_STEPS} timed bf16 steps: "
          f"{ {k: counts[k] for k in TRAINING_PATH} }")
    require(all(np.isfinite(losses)), f"non-finite bf16 losses {losses}")
    # every parameter with a gradient moved (the last ResBlock's conv_res feeds nothing)
    trained = [(a, p) for a, p in zip(before, model.parameters()) if p.grad is not None]
    changed = sum(not torch.equal(a, p.detach()) for a, p in trained)
    require(changed == len(trained) >= len(before) - 1,
            f"only {changed} of {len(trained)} trained parameters changed ({len(before)} in all)")
    require(all(counts[k] > 0 for k in TRAINING_PATH),
            f"a kernel of the training path never ran: {counts}")
    profiled = profile_step(torch, lambda: step(state, x, y), card)
    ms = statistics.median(times) * 1e3
    audio_h = TRAIN_BATCH * CLIP_SECONDS / 3600.0
    print(f"[train] bf16 batch {TRAIN_BATCH}: losses {[round(v, 5) for v in losses]}; "
          f"step {ms:.1f} ms (median of {TRAIN_STEPS}; {[round(1e3 * v, 1) for v in times]}) "
          f"= {audio_h / (ms / 1e3):.4f} audio-hours trained/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; in the profiled step "
          f"{device_shares(profiled)} ({card})")
    return counts


def start_train_cli(run_dir: Path, overrides: list, max_epochs: int, log: Path,
                    env: dict | None = None):
    """Start ``python -m seld_tpu_torch.train`` on the flagship config in
    ``run_dir`` with ``env`` added to the environment, its output going to
    ``log``; returns (process, command, start time) for
    :func:`finish_train_cli`."""
    import os

    cmd = [sys.executable, "-m", "seld_tpu_torch.train", f"--TextArgs={FLAGSHIP_CONFIG}",
           *overrides, f"--max_epochs={max_epochs}"]
    env = {**os.environ, "PYTHONPATH": str(ROOT), **(env or {})}
    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as f:
        f.write(" ".join(cmd) + "\n")
        f.flush()
        proc = subprocess.Popen(cmd, cwd=run_dir, env=env, stdout=f, stderr=subprocess.STDOUT,
                                text=True)
    return proc, cmd, time.perf_counter()


def finish_train_cli(started, max_epochs: int, log: Path, tag: str = "[entry]") -> str:
    """Wait for a :func:`start_train_cli` run (killed past 600 s); returns
    its output, printing its epoch, test and resume lines."""
    proc, cmd, t0 = started
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    text = log.read_text().split("\n", 1)[1]
    print(f"{tag} train CLI, --max_epochs={max_epochs}: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s (log {log.relative_to(ROOT)})")
    for line in text.splitlines():
        if line.startswith(("epoch ", "TEST epoch", "Resuming from", "train_loss ",
                            "val_loss ", "test_loss ")):
            print(f"{tag}   {line}")
    require(proc.returncode == 0, f"train CLI failed:\n{text[-3000:]}")
    return text


def run_train_cli(run_dir: Path, overrides: list, max_epochs: int, log: Path) -> str:
    """``python -m seld_tpu_torch.train`` on the flagship config from
    ``run_dir``; returns its output (also written to ``log``)."""
    return finish_train_cli(start_train_cli(run_dir, overrides, max_epochs, log), max_epochs,
                            log)


def phase_entry(torch, card: str, fixture: dict) -> dict:
    """The port's training entry point at full width with every CNN stage on
    a kernel; then the pallas-ct step beside the auto step. Returns the
    launches of the CLI's first run's training steps; leaves its dataset and
    its model directory after two epochs under CHECKPOINTS_DIR and their
    use in ``fixture``, for phase 10."""
    import shutil

    import numpy as np

    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.data.synthetic import gen_fake_task2_dataset, make_task2_batch
    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from seld_tpu_torch.serve import build_flagship
    from seld_tpu_torch.training import create_train_state, make_train_step
    from seld_tpu_torch.training.checkpoint import ROLES

    cfg = load_config(str(FLAGSHIP_CONFIG))
    run_dir = ROOT / "chip_tmp" / "train_cli"
    shutil.rmtree(run_dir, ignore_errors=True)
    shutil.rmtree(CHECKPOINTS_DIR, ignore_errors=True)
    run_dir.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        # the dataset outlives this phase: phase 10 resumes on it
        paths = gen_fake_task2_dataset(
            str(CHECKPOINTS_DIR / "data"), n_train=CT_CLIPS["train"],
            n_val=CT_CLIPS["validation"],
            n_test=CT_CLIPS["test"], channels=CHANNELS, freq=cfg.freq_dim, time_frames=4800,
            label_frames=600, sed_rate=CT_SED_RATE)
        print(f"[entry] synthetic dataset of {sum(CT_CLIPS.values())} one-minute clips "
              f"({CHANNELS} x {cfg.freq_dim} x 4800) written in {time.perf_counter() - t0:.1f} s")
        flags = {"training": "train", "validation": "validation", "test": "test"}
        overrides = [f"--{k}_{kind}_path={paths[split][i]}" for k, split in flags.items()
                     for i, kind in enumerate(("predictors", "target"))]
        overrides += ["--results_path=results", "--frontend_impl=pallas-ct",
                      "--compute_dtype=bfloat16", f"--batch_size={CT_BATCH}", "--test_step=1",
                      "--checkpoint_step=1"]
        logs = ROOT / "chip_tmp" / "train_cli_logs"
        first = run_train_cli(run_dir, overrides, 2, logs / "run1.log")
        require("Resuming from" not in first, "the first run resumed")
        model_dirs = list((run_dir / "RESULTS_Original").glob("Task2/*/*"))
        require(len(model_dirs) == 1, f"model directories: {model_dirs}")
        model_dir = model_dirs[0]
        records = [json.loads(line) for line in (model_dir / "metrics.jsonl").read_text()
                   .splitlines()]
        # the model directory after two epochs, for phase 10's resumes
        shutil.copytree(model_dir, CHECKPOINTS_DIR / "epoch2")
        fixture.update(overrides=overrides, model_dir=model_dir.relative_to(run_dir),
                       data_paths=paths, epoch1=records[0])
        second = run_train_cli(run_dir, overrides, 3, logs / "run2.log")
        require("Resuming from" in second, "the second run did not resume")
        records2 = [json.loads(line) for line in (model_dir / "metrics.jsonl").read_text()
                    .splitlines()][len(records):]
        require([r["epoch"] for r in records] == [1, 2] and [r["epoch"] for r in records2]
                == [3], f"epochs logged: {[r['epoch'] for r in records + records2]}")
        steps_per_epoch = -(-CT_CLIPS["train"] // CT_BATCH)
        for r in records + records2:
            require(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]),
                    f"epoch {r['epoch']}: non-finite loss {r}")
            got = r["kernel_launches"]
            want = {k: v * steps_per_epoch for k, v in CT_PER_STEP.items()}
            require(all(got.get(k) == v for k, v in want.items())
                    and all(got.get(k, 0) >= steps_per_epoch for k in CT_AT_LEAST),
                    f"epoch {r['epoch']}: launches {got}, want {want} and >= "
                    f"{steps_per_epoch} of {CT_AT_LEAST}")
        for f_ in [*ROLES.values(), "checkpoint_epoch_1", "checkpoint_epoch_2",
                   "checkpoint_epoch_3"]:
            require((model_dir / f_).exists(), f"missing {f_} in {model_dir}")
        csvs = sorted(p_.name for p_ in model_dir.glob("*.csv"))
        require(any("training_metrics" in n for n in csvs)
                and any("test_metrics" in n for n in csvs), f"CSVs: {csvs}")
        results = json.loads((run_dir / "results" / "results_dict.json").read_text())
        require(all(np.isfinite(results[k]) for k in ("train_loss", "val_loss", "test_loss")),
                f"results_dict.json: {results}")
        print(f"[entry] {model_dir.relative_to(run_dir)}: roles {sorted(ROLES.values())}, "
              f"archives 1-3, {csvs}, results_dict.json; per-epoch launches "
              f"{[r['kernel_launches'] for r in records + records2]}")
        counts = {}
        for r in records:
            for k, v in r["kernel_launches"].items():
                counts[k] = counts.get(k, 0) + v
        # the trained weights the predict phase serves
        PREDICT_DIR.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(model_dir / ROLES["checkpoint_best"],
                        PREDICT_DIR / ROLES["checkpoint_best"])
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    # the pallas-ct step beside the auto step, batch 8, bf16, in turns
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(a).to(dev) for a in make_task2_batch(
        rng, CT_BATCH, channels=CHANNELS, freq=cfg.freq_dim, time_frames=4800,
        label_frames=600))
    runs = {}
    c16 = cfg.replace(compute_dtype="bfloat16")
    for impl in ("auto", "pallas-ct"):
        model = build_flagship(str(FLAGSHIP_CONFIG), torch.bfloat16, dev,
                               torch.Generator().manual_seed(0))
        model.seld_block.frontend_impl = "ct" if impl == "pallas-ct" else "auto"
        runs[impl] = (create_train_state(model, c16, torch.Generator(device=dev).manual_seed(2)),
                      make_train_step(c16), [])
    peak = dict.fromkeys(runs, 0)
    for impl, (state, step, _) in runs.items():
        for _ in range(TRAIN_WARMUP):
            step(state, x, y)
    torch.cuda.synchronize()
    for i in range(CT_STEPS_TIMED):
        for impl in ("auto", "pallas-ct") if i % 2 == 0 else ("pallas-ct", "auto"):
            state, step, times = runs[impl]
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, loss = step(state, x, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peak[impl] = max(peak[impl], torch.cuda.max_memory_allocated())
            require(bool(torch.isfinite(loss)), f"{impl} step: loss {float(loss)}")
            if impl == "pallas-ct":
                require(all(launch_counts[k] == v for k, v in CT_PER_STEP.items()),
                        f"pallas-ct step launches {dict(launch_counts)}")
    audio_h = CT_BATCH * CLIP_SECONDS / 3600.0
    for impl, (_, _, times) in runs.items():
        ms = statistics.median(times) * 1e3
        print(f"[entry] {impl} step, bf16 batch {CT_BATCH}: {ms:.1f} ms (median of "
              f"{len(times)}, in turns; {[round(1e3 * v, 1) for v in times]}) = "
              f"{audio_h / (ms / 1e3):.4f} audio-hours trained/s; peak memory "
              f"{peak[impl] / 2**30:.2f} GiB ({card})")
    state, step, times = runs["pallas-ct"]
    del runs["auto"]
    profiled = profile_step(torch, lambda: step(state, x, y), card, top=18)
    print(f"[entry] pallas-ct step {statistics.median(times) * 1e3:.1f} ms; in the profiled "
          f"step {device_shares(profiled)} ({card})")
    return counts


def set_qconv_impl(model, impl: str) -> None:
    """Route every Hamilton layer of ``model`` through ``impl`` ('xla',
    'pallas', 'int8'); only the pointwise convs and the FC layers take it."""
    from seld_tpu_torch.models.layers import HamiltonConv, HamiltonLinear

    for m in model.modules():
        if isinstance(m, (HamiltonConv, HamiltonLinear)):
            m.impl = impl
    model.qconv_impl = impl


def check_submission(path: str, cfg) -> int:
    """The rows of one submission CSV: [frame, class, x, y, z] with frame in
    [0, 600), class in [0, classes) and each coordinate within
    max_loc_value; returns the number of rows."""
    import numpy as np

    lines = Path(path).read_text().splitlines()
    rows = np.array([[float(v) for v in line.split(",")] for line in lines]).reshape(-1, 5)
    frame, cls, xyz = rows[:, 0], rows[:, 1], rows[:, 2:]
    require(bool(np.all((frame >= 0) & (frame < 600) & (frame == np.round(frame)))),
            f"{path}: frames outside [0, 600)")
    require(bool(np.all((cls >= 0) & (cls < cfg.output_classes) & (cls == np.round(cls)))),
            f"{path}: classes outside [0, {cfg.output_classes})")
    require(bool(np.all(np.abs(xyz) <= cfg.max_loc_value)), f"{path}: |xyz| > max_loc_value")
    return len(rows)


def phase_predict(torch, card: str, fixture: dict) -> dict:
    """The port's predict CLI on the full-width flagship with phase 6's best
    checkpoint: three one-minute clips (two .npy, one int16 .wav) through
    (a) auto -> fused bf16, (b) apply with K7 in float32, (c) apply with K7
    in bf16, (d) apply with K8 in bf16, each checked for its CSVs and its
    launches, and clip 0 of each against the float32 'xla' apply path; then
    the bf16 batch-8 train step with qconv_impl 'pallas' beside 'xla', in
    turns. Returns the launches of runs (a)-(d); leaves its clips, and run
    (a)'s outputs and checkpoint in ``fixture``, for phase 10."""
    total = predict_runs(torch, card, fixture)   # its clips stay for phase 10
    predict_train_steps(torch, card)
    return total


def predict_runs(torch, card: str, fixture: dict) -> dict:
    """Phase 7's four CLI runs and the reference run; returns their launches."""
    import numpy as np
    import scipy.io.wavfile as wavfile

    from seld_tpu_torch import predict
    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from seld_tpu_torch.training.checkpoint import ROLES

    cfg = load_config(str(FLAGSHIP_CONFIG))
    ckpt = PREDICT_DIR / ROLES["checkpoint_best"]
    require(ckpt.is_file(), f"phase 6 left no checkpoint at {ckpt}")
    rng = np.random.default_rng(11)
    n = SR * CLIP_SECONDS
    clips = []
    for i in range(PREDICT_CLIPS - 1):
        clips.append(PREDICT_DIR / f"clip_{i}.npy")
        np.save(clips[-1], rng.standard_normal((CHANNELS, n), dtype=np.float32))
    clips.append(PREDICT_DIR / f"clip_{PREDICT_CLIPS - 1}.wav")
    wavfile.write(clips[-1], SR, (rng.standard_normal((n, CHANNELS)) * 3000).astype(np.int16))
    base = [f"--TextArgs={FLAGSHIP_CONFIG}", f"--checkpoint={ckpt}"]

    def run(tag, flags, inputs):
        reset_launch_counts()
        t0 = time.perf_counter()
        results = predict.main([*base, "--inputs", *map(str, inputs),
                                f"--out-dir={PREDICT_DIR / tag}", *flags])
        torch.cuda.synchronize()
        return results, dict(launch_counts), time.perf_counter() - t0

    ref, _, _ = run("ref", ["--impl=apply", "--qconv_impl=xla"], clips[:1])
    ref_sed, ref_doa = ref[0]["sed"], ref[0]["doa"]
    bf16 = "--compute_dtype=bfloat16"
    runs = {  # tag: flags, launches per clip (every other count 0), tolerance on clip 0
        "a_auto_fused_bf16": ([bf16], FUSED_PER_CLIP, {"sed": MAIN_TOL, "doa": MAIN_TOL}),
        "b_apply_pallas_f32": (["--impl=apply", "--qconv_impl=pallas"],
                               {"stft_mag": 1, "stft_mag_fft": 1,
                                "hamilton_matmul": QMM_PER_FORWARD},
                               {"sed": F32_TOL * np.abs(ref_sed).max(),
                                "doa": F32_TOL * np.abs(ref_doa).max()}),
        "c_apply_pallas_bf16": (["--impl=apply", "--qconv_impl=pallas", bf16],
                                {"stft_mag": 1, "stft_mag_fft": 1,
                                 "hamilton_matmul": QMM_PER_FORWARD,
                                 "flash_attn_fwd": 1}, {"sed": MAIN_TOL, "doa": MAIN_TOL}),
        "d_apply_int8_bf16": (["--impl=apply", "--qconv_impl=int8", bf16],
                              {"stft_mag": 1, "stft_mag_fft": 1, "int8_matmul": QMM_PER_FORWARD,
                               "flash_attn_fwd": 1}, PTQ_TOL),
    }
    total = {}
    for tag, (flags, per_clip, tol) in runs.items():
        results, counts, wall = run(tag, flags, clips)
        want = {k: per_clip.get(k, 0) * len(clips) for k in counts}
        require(counts == want, f"predict {tag}: launches {counts}, want {want}")
        if tag == "a_auto_fused_bf16":   # phase 10 serves the same weights from a seld_tpu file
            fixture["fused"] = {"clips": clips, "results": results, "checkpoint": ckpt,
                                "flags": flags}
        rows = [check_submission(r["csv"], cfg) for r in results]
        d = {"sed": float(np.abs(results[0]["sed"] - ref_sed).max()),
             "doa": float(np.abs(results[0]["doa"] - ref_doa).max())}
        secs = [r["seconds"] for r in results]
        launched = {k: v for k, v in counts.items() if v}
        print(f"[predict] {tag}: {len(results)} CSVs, rows {rows}, launches {launched}; clip 0 vs "
              f"the f32 xla apply path: max|d sed| {d['sed']:.3e} (tol {tol['sed']:.3e}), "
              f"max|d doa| {d['doa']:.3e} (tol {tol['doa']:.3e}); per clip "
              f"{[round(1e3 * v, 1) for v in secs]} ms (median {1e3 * statistics.median(secs):.1f}"
              f"), CLI {wall:.1f} s ({card})")
        require(all(d[k] <= tol[k] for k in d), f"predict {tag}: clip 0 {d} beyond {tol}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    predict_int8_profile(torch, card, lambda: run("d_profiled", runs["d_apply_int8_bf16"][0],
                                                  clips[:1]))
    return total


def predict_int8_profile(torch, card: str, run_one_clip) -> None:
    """One more int8 apply clip under the profiler: K1's (the FFT) and K8's
    device time a clip; K1 also back to back at the clip's shape, since the
    profiler has dropped K1's launches in some runs."""
    from seld_tpu_torch.ops.kernels.stft import stft_mag

    watch = {"K1 f32 (FFT)": ("stft_mag_fft_kernel",),
             "K8": ("int8_matmul_tc_kernel", "int8_prepare_kernel")}
    profiled = profile_step(torch, run_one_clip, card, top=10,
                            label="predict, --impl apply --qconv_impl=int8 bf16, one clip",
                            watch=watch)
    audio = torch.randn(CHANNELS, SR * CLIP_SECONDS, device="cuda")
    k1 = stream_ms(torch, lambda: stft_mag(audio, out_dtype=torch.float32))
    print(f"[profile] predict int8 clip: {device_shares(profiled, watch)}; K1 f32 back to back "
          f"at the clip's shape {k1:.4f} ms ({card})")
    del audio


def predict_train_steps(torch, card: str) -> None:
    """The bf16 batch-8 train step with qconv_impl 'pallas' beside 'xla'."""
    import numpy as np

    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.data.synthetic import make_task2_batch
    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from seld_tpu_torch.serve import build_flagship
    from seld_tpu_torch.training import create_train_state, make_train_step

    cfg = load_config(str(FLAGSHIP_CONFIG))
    # the bf16 batch-8 train step with qconv_impl 'pallas' (K7 forward and dx)
    # beside 'xla', from the same weights, in turns
    dev = torch.device("cuda")
    c16 = cfg.replace(compute_dtype="bfloat16")
    x, y = (torch.from_numpy(a).to(dev) for a in make_task2_batch(
        np.random.default_rng(0), TRAIN_BATCH, channels=CHANNELS, freq=cfg.freq_dim,
        time_frames=4800, label_frames=600))
    steps = {}
    for impl in ("xla", "pallas"):
        model = build_flagship(str(FLAGSHIP_CONFIG), torch.bfloat16, dev,
                               torch.Generator().manual_seed(0))
        set_qconv_impl(model, impl)
        state = create_train_state(model, c16, torch.Generator(device=dev).manual_seed(2))
        steps[impl] = (state, make_train_step(c16), [], [p.detach().clone()
                                                         for p in model.parameters()])
    for state, step, _, _ in steps.values():
        for _ in range(TRAIN_WARMUP):
            step(state, x, y)
    torch.cuda.synchronize()
    per_step = QMM_PER_FORWARD + QMM_DX_PER_STEP
    peak = dict.fromkeys(steps, 0)
    for i in range(PREDICT_STEPS_TIMED):
        for impl in ("xla", "pallas") if i % 2 == 0 else ("pallas", "xla"):
            state, step, times, _ = steps[impl]
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, loss = step(state, x, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peak[impl] = max(peak[impl], torch.cuda.max_memory_allocated())
            require(bool(torch.isfinite(loss)), f"{impl} step: loss {float(loss)}")
            got = launch_counts["hamilton_matmul"]
            require(got == (per_step if impl == "pallas" else 0),
                    f"{impl} step: {got} Hamilton matmul launches, want "
                    f"{per_step if impl == 'pallas' else 0} ({QMM_PER_FORWARD} forward + "
                    f"{QMM_DX_PER_STEP} dx)")
    state, _, _, before = steps["pallas"]
    trained = [(a, p) for a, p in zip(before, state.model.parameters()) if p.grad is not None]
    changed = sum(not torch.equal(a, p.detach()) for a, p in trained)
    require(changed == len(trained) >= len(before) - 1,
            f"pallas step: only {changed} of {len(trained)} trained parameters changed")
    audio_h = TRAIN_BATCH * CLIP_SECONDS / 3600.0
    for impl, (_, _, times, _) in steps.items():
        ms = statistics.median(times) * 1e3
        print(f"[predict] train step qconv_impl={impl}, bf16 batch {TRAIN_BATCH}: {ms:.1f} ms "
              f"(median of {len(times)}, in turns; {[round(1e3 * v, 1) for v in times]}) = "
              f"{audio_h / (ms / 1e3):.4f} audio-hours trained/s; K7 launches per step "
              f"{per_step if impl == 'pallas' else 0}; peak memory {peak[impl] / 2**30:.2f} GiB "
              f"({card})")
    for impl, (state, step, _, _) in steps.items():
        print(f"[predict] profiled train step, qconv_impl={impl}:")
        profiled = profile_step(torch, lambda: step(state, x, y), card, top=10)
        print(f"[predict] qconv_impl={impl}: in the profiled step {device_shares(profiled)} "
              f"({card})")
    del steps
    torch.cuda.empty_cache()


def phase_frontend_paths(torch, card: str) -> dict:
    """Phase 8, the front-end variants: (a) serving with the wide pack, (b)
    fused_infer on general-Cin stages, (c) the per-stage profiler. Returns
    {path: ({launch-count name: (source, TPU kernel)}, launches of that run)}."""
    wide = frontend_serving(torch, card)
    general = frontend_general_cin(torch, card)
    profiled = frontend_profiler(torch)
    pick = lambda name: {name: FRONTEND_KERNELS[name]}
    return {"serving, smallcin_impl='wide'": (pick("conv3x3_smallcin_wide"), wide),
            "fused_infer, R config with 12 input channels": (pick("conv3x3_windows"), general),
            "profile_stages": ({**pick("im2col_patches"), **pick("conv3x3_im2col")}, profiled)}


def frontend_serving(torch, card: str) -> dict:
    """(a) ``serve(..., smallcin_impl='wide')`` beside 'thin' on the
    full-width flagship in bf16, in turns: REQUESTS requests of
    CLIPS_PER_REQUEST one-minute clips for each; K2w launches once per
    'wide' request and K2 never, and the reverse for 'thin'; clip 0 of the
    first 'wide' request against the float32 plain path. Returns the 'wide'
    requests' launches."""
    import numpy as np

    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from seld_tpu_torch.ops.kernels.stft import stft_mag_plain
    from seld_tpu_torch.serve import build_flagship, serve

    dev = torch.device("cuda")
    model = build_flagship(str(FLAGSHIP_CONFIG), torch.bfloat16, dev,
                           torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    requests = [rng.standard_normal((CLIPS_PER_REQUEST, CHANNELS, SR * CLIP_SECONDS),
                                    dtype=np.float32) for _ in range(REQUESTS)]
    counts = {"thin": {}, "wide": {}}
    sed_w = int(model.output_classes * model.class_overlaps)
    for i, audio in enumerate(requests):
        for impl in ("thin", "wide") if i % 2 == 0 else ("wide", "thin"):
            torch.cuda.synchronize()
            reset_launch_counts()
            sed, doa = serve(model, torch.from_numpy(audio).to(dev), smallcin_impl=impl)
            torch.cuda.synchronize()
            for k, v in launch_counts.items():
                counts[impl][k] = counts[impl].get(k, 0) + v
            require(tuple(sed.shape) == (CLIPS_PER_REQUEST, 600, sed_w)
                    and tuple(doa.shape) == (CLIPS_PER_REQUEST, 600, 3 * sed_w),
                    f"{impl} request {i}: shapes {tuple(sed.shape)} {tuple(doa.shape)}")
            require(bool(torch.isfinite(sed).all() and torch.isfinite(doa).all()),
                    f"{impl} request {i}: non-finite output")
            if impl == "wide" and i == 0:
                first = (sed[:1].float(), doa[:1].float())
    wide, thin = counts["wide"], counts["thin"]
    launched = {impl: {k: v for k, v in c.items() if v} for impl, c in counts.items()}
    print(f"[variants] launches during the {REQUESTS} 'wide' requests: {launched['wide']}; "
          f"'thin': {launched['thin']}")
    require(wide["conv3x3_smallcin_wide"] == REQUESTS and wide["conv3x3_smallcin"] == 0,
            f"'wide' serving: K2w {wide['conv3x3_smallcin_wide']}, K2 {wide['conv3x3_smallcin']}; "
            f"want {REQUESTS} and 0")
    require(thin["conv3x3_smallcin"] == REQUESTS and thin["conv3x3_smallcin_wide"] == 0,
            f"'thin' serving launched {thin}")
    require(all(wide[k] > 0 for k in ("stft_mag", "conv3x3_widecin", "flash_attn_fwd")),
            f"'wide' serving skipped a kernel: {wide}")
    audio_h = CLIPS_PER_REQUEST * CLIP_SECONDS / 3600.0
    windows = {"thin": [], "wide": []}
    for i in range(HOST_WINDOW):
        for impl in ("thin", "wide") if i % 2 == 0 else ("wide", "thin"):
            windows[impl] += timed_window(torch, 1, lambda _: serve(
                model, torch.from_numpy(requests[i % REQUESTS]).to(dev), smallcin_impl=impl))
    for impl, window in windows.items():
        print(f"[variants] serve smallcin_impl='{impl}', bf16, {CLIPS_PER_REQUEST} clips per "
              f"request from host memory, in turns: {window_summary(window, audio_h)} ({card})")
    # one profiled request of each: stage 1's share of the device time
    watch = {"K2w": ("smallcin_wide_tc_kernel",), "K2": ("smallcin_tc_kernel",)}
    for impl in ("wide", "thin"):
        profiled = profile_step(torch, lambda: serve(
            model, torch.from_numpy(requests[0]).to(dev), smallcin_impl=impl), card, top=8,
            label=f"'{impl}' serving request, batch {CLIPS_PER_REQUEST}", watch=watch)
        print(f"[variants] one profiled '{impl}' request: {device_shares(profiled, watch)} "
              f"({card})")
    clip = torch.from_numpy(requests[0][:1]).to(dev)
    with torch.no_grad():
        feats = stft_mag_plain(clip, out_dtype=torch.float32).transpose(-1, -2)
        sed_ref, doa_ref = model(feats.contiguous())
    d_sed = (first[0] - sed_ref.float()).abs().max().item()
    d_doa = (first[1] - doa_ref.float()).abs().max().item()
    print(f"[variants] clip 0, 'wide' kernels bf16 vs plain f32: max|d sed| {d_sed:.3e} "
          f"max|d doa| {d_doa:.3e} (tol {MAIN_TOL})")
    require(max(d_sed, d_doa) <= MAIN_TOL, "'wide' served clip disagrees with the plain path")
    del model
    torch.cuda.empty_cache()
    return wide


def frontend_general_cin(torch, card: str) -> dict:
    """(b) ``fused_infer`` on the full-width R-domain config with 10 and 12
    input channels (stage 1 on K2w, then on K10b; stages 2-3 on K3), float32,
    batch 2 at 256 x 4800, each against its float32 plain ``model(x)``.
    Returns the Cin-12 run's launches."""
    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.models.fused_infer import fused_infer
    from seld_tpu_torch.models.seld import model_from_config
    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from seld_tpu_torch.serve import perturb_bn

    dev = torch.device("cuda")
    counts = {}
    for cin, name in ((10, "conv3x3_smallcin_wide"), (12, "conv3x3_windows")):
        gen = torch.Generator().manual_seed(0)
        cfg = load_config(str(R_CONFIG)).replace(input_channels=cin, compute_dtype="float32")
        model = model_from_config(cfg, device=dev, generator=gen)
        perturb_bn(model, gen)
        model.eval()
        x = torch.rand(2, cin, cfg.freq_dim, 4800, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(cin))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        sed, doa = fused_infer(model, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[cin] = dict(launch_counts)
        with torch.no_grad():
            sed_ref, doa_ref = model(x)
        d = max((a - r).abs().max().item() for a, r in ((sed, sed_ref), (doa, doa_ref)))
        tol = F32_TOL * max(sed_ref.abs().max().item(), doa_ref.abs().max().item())
        launched = {k: v for k, v in counts[cin].items() if v}
        others = {"conv3x3_smallcin", "conv3x3_smallcin_wide", "conv3x3_windows"} - {name}
        print(f"[variants] fused_infer {R_CONFIG.name} with {cin} input channels, f32 batch 2: "
              f"{1e3 * wall:.1f} ms, launches {launched}; vs plain model(x): max|d| {d:.3e} "
              f"(tol {tol:.3e}) ({card})")
        require(launched.get(name) == 1 and launched.get("conv3x3_widecin") == 2
                and not others & set(launched), f"Cin {cin}: launches {launched}, want {name} once")
        require(d <= tol, f"Cin {cin}: fused_infer is {d:.3e} from model(x)")
        del model, x
    torch.cuda.empty_cache()
    return counts[12]


def frontend_profiler(torch) -> dict:
    """(c) ``python -m seld_tpu_torch.profile_stages`` at PROF_BATCH=4 over
    every section: every row timed (no FAILED), K2w, K10a and K10b launched.
    Its output goes to chip_tmp/profile_stages.log. Returns its launches,
    the patch kernel's those of K10a's rows."""
    import os

    torch.cuda.empty_cache()   # the profiler is another process on the same card
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PROF_BATCH": str(PROFILE_BATCH),
           "PROF_SECTIONS": PROFILE_SECTIONS}
    cmd = [sys.executable, "-m", "seld_tpu_torch.profile_stages"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    log = ROOT / "chip_tmp" / "profile_stages.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    lines = proc.stdout.strip().splitlines()
    print(f"[variants] profile_stages at PROF_BATCH={PROFILE_BATCH}: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s (log {log.relative_to(ROOT)})")
    for line in lines[:-1]:
        print(f"[stages] {line}")
    require(proc.returncode == 0 and len(lines) > 2,
            f"profile_stages failed:\n{(proc.stdout + proc.stderr)[-3000:]}")
    rows = lines[1:-1]
    require(all(r.endswith(" ms") and "FAILED" not in r for r in rows),
            f"profile_stages rows without a time: {[r for r in rows if not r.endswith(' ms')]}")
    counts = json.loads(lines[-1])["launch_counts"]
    require(all(counts[k] > 0 for k in FRONTEND_KERNELS),
            f"profile_stages launched {counts}")
    # the rows that time K10a's patches alone launch the patch kernel too (one
    # warm-up and ITERS timed calls a row): K10a's path counts its own rows' alone
    from seld_tpu_torch.profile_stages import ITERS
    alone = sum("patches alone" in r for r in rows) * (ITERS + 1)
    require(alone > 0 and counts["im2col_patches"] == counts["conv3x3_im2col"] + alone,
            f"profile_stages: {counts['im2col_patches']} patch launches, K10a "
            f"{counts['conv3x3_im2col']}, {alone} from the rows of the patches alone")
    return {**counts, "im2col_patches": counts["im2col_patches"] - alone}


def phase_configs(torch, card: str) -> dict:
    """Phase 9, the shipped magnitude + phase configurations and the SE block:
    (a) MagPhase-Parallel serving, (b) 16chMagPhase with stage 1 on K3, (c)
    the SE block, (d) MagPhase-Parallel training under pallas-ct, (e) the
    predict CLI on MagPhase-Parallel. Returns the launches of (a)'s requests
    and (d)'s timed steps together, each kernel's own: K3's are the
    requests', K9's F2 (counted as K3's) and K5's F2 (as K10b's) the steps'."""
    t0 = time.perf_counter()
    serving = configs_serving(torch, card)
    configs_16ch(torch, card)
    configs_se(torch, card)
    training = configs_training(torch, card)
    configs_predict(torch, card)
    print(f"[configs] phase 9 took {time.perf_counter() - t0:.1f} s")
    total = {k: serving.get(k, 0) + training.get(k, 0) for k in {*serving, *training}}
    return {**total, "conv3x3_widecin": serving["conv3x3_widecin"],
            "ct_train_fwd": training["conv3x3_widecin"],
            "conv_train_fwd": training["conv3x3_windows"]}


def launches_of(torch, run) -> dict:
    """The launch counts of one ``run()``, from zero, after the card is idle."""
    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, dict(launch_counts)


def require_launches(tag: str, counts: dict, want: dict) -> None:
    """``counts`` equal ``want`` for its names and 0 for every other."""
    full = {k: want.get(k, 0) for k in {*counts, *want}}
    require(counts == full, f"{tag}: launches { {k: v for k, v in counts.items() if v} }, "
            f"want { {k: v for k, v in full.items() if v} }")


def check_outputs(torch, tag: str, sed, doa, batch: int) -> None:
    require(tuple(sed.shape) == (batch, 600, 42) and tuple(doa.shape) == (batch, 600, 126),
            f"{tag}: shapes {tuple(sed.shape)} {tuple(doa.shape)}")
    require(bool(torch.isfinite(sed).all() and torch.isfinite(doa).all()),
            f"{tag}: non-finite output")


def max_diff(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def configs_serving(torch, card: str) -> dict:
    """(a) The MagPhase-Parallel config in bf16 through ``serve(...,
    phase=True)``: REQUESTS requests of CLIPS_PER_REQUEST one-minute 8-channel
    clips from host memory; K2 once and K3 twice a trunk, K4 once a trunk and
    no K1 a request; clip 0 against the float32 plain ``model(x)`` on the
    same float32 features; the wall per request, the featurizer's device
    time per request and one profiled request. Returns the requests'
    launches."""
    import numpy as np

    from seld_tpu_torch.data.features import spectrum_fast_batch
    from seld_tpu_torch.serve import NOVERLAP, NPERSEG, build_flagship, serve

    dev = torch.device("cuda")
    model = build_flagship(str(MAGPHASE_CONFIG), torch.bfloat16, dev,
                           torch.Generator().manual_seed(9))
    require(model.trunk_names == ("branch_A", "branch_B") and model.input_channels == 16,
            f"MagPhase-Parallel built {model.trunk_names}, {model.input_channels} channels")
    rng = np.random.default_rng(9)
    requests = [rng.standard_normal((CLIPS_PER_REQUEST, CHANNELS, SR * CLIP_SECONDS),
                                    dtype=np.float32) for _ in range(REQUESTS)]
    serve(model, torch.from_numpy(requests[0]).to(dev), phase=True)   # first call: builds
    total, walls, first = {}, [], None
    for i, audio in enumerate(requests):
        t0 = time.perf_counter()
        (sed, doa), counts = launches_of(torch, lambda: serve(
            model, torch.from_numpy(audio).to(dev), phase=True))
        walls.append(time.perf_counter() - t0)
        check_outputs(torch, f"MagPhase-Parallel request {i}", sed, doa, CLIPS_PER_REQUEST)
        require_launches(f"MagPhase-Parallel request {i}", counts, MAGPHASE_PER_REQUEST)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if i == 0:
            first = (sed[:1], doa[:1])
    audio0 = torch.from_numpy(requests[0]).to(dev)
    feat_ms = device_ms(torch, lambda: spectrum_fast_batch(
        audio0, nperseg=NPERSEG, noverlap=NOVERLAP, output_phase=True, return_layout="CTF"),
        iters=5)
    print(f"[configs] MagPhase-Parallel serving, bf16, {CLIPS_PER_REQUEST} clips a request from "
          f"host memory: launches { {k: v for k, v in total.items() if v} } in {REQUESTS} "
          f"requests; wall per request {[round(1e3 * v, 1) for v in walls]} ms; the "
          f"featurizer's device time {feat_ms:.3f} ms a request ({card})")
    watch = {"K2": ("smallcin_tc_kernel",), "K3": ("conv3x3_tc_kernel",),
             "K4": ("flash_fwd_tc_kernel",)}
    profiled = profile_step(torch, lambda: serve(model, audio0, phase=True), card, top=10,
                            label="MagPhase-Parallel request, batch 4, audio on the card",
                            watch=watch)
    print(f"[profile] MagPhase-Parallel request: {device_shares(profiled, watch)}; the "
          f"featurizer {feat_ms:.2f} ms ({100 * feat_ms / profiled['busy']:.1f}%) ({card})")
    with torch.no_grad():
        feats = spectrum_fast_batch(audio0[:1], nperseg=NPERSEG, noverlap=NOVERLAP,
                                    output_phase=True)
        ref = model(feats)
    d = max_diff(first, ref)
    print(f"[configs] MagPhase-Parallel clip 0, kernels bf16 vs plain f32 on the same float32 "
          f"features: max|d| {d:.3e} (tol {MAIN_TOL})")
    require(d <= MAIN_TOL, "MagPhase-Parallel served clip disagrees with the plain path")
    del model, audio0, feats
    torch.cuda.empty_cache()
    return total


def configs_16ch(torch, card: str) -> None:
    """(b) The 16chMagPhase config through ``fused_infer``: float32 at batch 2
    (held to the plain ``model(x)`` within F32_TOL x max) and bf16 at batch 4
    (clip 0 within MAIN_TOL of float32 plain), stage 1 on K3 (3 launches, K2
    none); then K3 alone at stage 1 (B 2, Cin 16, F 256, T 4800, pf 8) in
    both dtypes against its plain version, beside cuDNN's conv."""
    import numpy as np

    from seld_tpu_torch.data.features import spectrum_fast_batch
    from seld_tpu_torch.models.fused_infer import fused_infer
    from seld_tpu_torch.ops.kernels.conv2d_pool import (
        conv2d_bn_relu_fpool, conv2d_bn_relu_fpool_plain,
    )
    from seld_tpu_torch.serve import NOVERLAP, NPERSEG, build_flagship

    F = torch.nn.functional
    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    audio = torch.from_numpy(rng.standard_normal((4, CHANNELS, SR * CLIP_SECONDS),
                                                 dtype=np.float32)).to(dev)
    feats = spectrum_fast_batch(audio, nperseg=NPERSEG, noverlap=NOVERLAP, output_phase=True)
    want = {"conv3x3_widecin": 3, "flash_attn_fwd": 1}
    for dt, b in ((torch.float32, 2), (torch.bfloat16, 4)):
        model = build_flagship(str(MAG16_CONFIG), dt, dev, torch.Generator().manual_seed(16))
        require(model.input_channels == 16 and len(model.trunks) == 1, "16chMagPhase built wrong")
        x = feats[:b].contiguous()
        (sed, doa), counts = launches_of(torch, lambda: fused_infer(model, x))
        check_outputs(torch, f"16chMagPhase {dt}", sed, doa, b)
        require_launches(f"16chMagPhase {dt}", counts, want)
        n = b if dt == torch.float32 else 1
        with torch.no_grad():
            ref = model(x[:n])
        if dt == torch.float32:
            d = max_diff((sed, doa), ref)
            tol = F32_TOL * max(r.abs().max().item() for r in ref)
            what = f"(tol F32_TOL x max = {tol:.3e})"
        else:
            d, tol = max_diff((sed[:1], doa[:1]), ref), MAIN_TOL
            what = f"on clip 0 (tol {MAIN_TOL})"
        ms = time_ms(torch, lambda: fused_infer(model, x), warmup=1, iters=3)
        print(f"[configs] 16chMagPhase fused_infer {str(dt)[6:]} batch {b}: launches "
              f"{ {k: v for k, v in counts.items() if v} }; against the float32 plain "
              f"model(x): max|d| {d:.3e} {what}; {ms:.1f} ms a call ({card})")
        require(d <= tol, f"16chMagPhase {dt}: {d:.3e} from the plain path")
        del model, ref
    del audio, feats
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(17)
    b, cin, f, t, cout, pf = K3_CIN16
    xf = torch.randn(b, cin, f, t, generator=gen, device=dev).abs()
    wf = torch.randn(3, 3, cin, cout, generator=gen, device=dev) * (9 * cin) ** -0.5
    scale = 1.0 + 0.2 * torch.randn(cout, generator=gen, device=dev)
    bias = 0.2 * torch.randn(cout, generator=gen, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        x, w = xf.to(dt), wf.to(dt)
        k = lambda: conv2d_bn_relu_fpool(x, w, scale, bias, pf)
        p = lambda: conv2d_bn_relu_fpool_plain(x, w, scale, bias, pf)
        w_nchw = w.permute(3, 2, 0, 1).contiguous()
        lib = lambda: F.conv2d(x, w_nchw, padding=1)
        (got, counts) = launches_of(torch, k)
        require_launches(f"K3 at Cin 16 {dt}", counts, {"conv3x3_widecin": 1})
        timed = (time_ms(torch, k), time_ms(torch, p))
        d = compare(torch, "conv3x3_widecin", "stage1 c16", got, p(), dt, card, timed)
        flops, moved = 2.0 * 9 * cin * cout * b * f * t, nbytes(x, w, got)
        dt_name = str(dt)[6:]
        bound_ms, bound_by = bound(flops, moved, dt_name)
        lib_ms = time_ms(torch, lib)
        k_b2b, lib_b2b = stream_ms(torch, k), stream_ms(torch, lib)
        print(f"[kernel] conv3x3_widecin stage1 c16 {dt_name} back to back: kernel "
              f"{k_b2b:.4f} ms, cuDNN {lib_b2b:.4f} ms; events kernel {timed[0]:.3f} ms, cuDNN "
              f"{lib_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} ({card})")
        K3_CIN16_ROWS[dt_name] = {"max_abs_err": d, "ms": timed[0], "plain_ms": timed[1],
                                  "stream_ms": k_b2b, "library_ms": lib_ms,
                                  "library_stream_ms": lib_b2b, "bound_ms": bound_ms,
                                  "bound_by": bound_by}
        if dt == torch.float32:
            f32_row(card, "conv3x3_widecin", "stage1 c16", timed[0], lib_ms, flops, moved,
                    split_tf32=True)
        del x, w, got
    del xf, wf
    torch.cuda.empty_cache()


def configs_se(torch, card: str) -> None:
    """(c) The flagship with ``use_se_block=True`` in bf16 at batch 2 through
    ``serve`` (``fused_infer`` after K1): the same launches as the flagship
    without SE, and clip 0 within MAIN_TOL of its float32 plain ``model(x)``."""
    from seld_tpu_torch.ops.kernels.stft import stft_mag_plain
    from seld_tpu_torch.serve import build_flagship, serve

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    audio = torch.randn(2, CHANNELS, SR * CLIP_SECONDS, generator=gen, device=dev)
    counts, out = {}, None
    for se in (False, True):
        model = build_flagship(str(FLAGSHIP_CONFIG), torch.bfloat16, dev,
                               torch.Generator().manual_seed(18), use_se_block=se)
        require(hasattr(model.seld_block, "se_0") == se, f"use_se_block={se}: se_0 wrong")
        (sed, doa), counts[se] = launches_of(torch, lambda: serve(model, audio))
        check_outputs(torch, f"SE {se}", sed, doa, 2)
        out = (sed[:1], doa[:1])
        if not se:
            del model
    require(counts[True] == counts[False], f"SE serving launched {counts[True]}, without SE "
            f"{counts[False]}")
    with torch.no_grad():
        feats = stft_mag_plain(audio[:1], out_dtype=torch.float32).transpose(-1, -2)
        ref = model(feats.contiguous())
    d = max_diff(out, ref)
    print(f"[configs] SE block, flagship bf16 batch 2 through serve: launches "
          f"{ {k: v for k, v in counts[True].items() if v} } (as without SE); clip 0 vs "
          f"plain f32: max|d| {d:.3e} (tol {MAIN_TOL})")
    require(d <= MAIN_TOL, "SE served clip disagrees with the plain path")
    del model, audio, feats
    torch.cuda.empty_cache()


def configs_training(torch, card: str) -> dict:
    """(d) The MagPhase-Parallel config training in bf16 at its batch (4) under
    pallas-ct through ``make_train_step``: one warm-up and CONFIGS_STEPS
    timed steps, each with K5's passes twice, K9's four times (stages 2-3 of
    two trunks), K4 and K6 twice; finite losses, parameters of both trunks
    changed; then one float32 batch-1 step on the ct path and on the plain
    path from the same weights and batch, losses within TRAIN_LOSS_TOL.
    Returns the timed steps' launches."""
    import copy

    import numpy as np

    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.data.synthetic import make_task2_batch
    from seld_tpu_torch.serve import build_flagship
    from seld_tpu_torch.training import create_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = load_config(str(MAGPHASE_CONFIG))
    rng = np.random.default_rng(19)

    def batch(n):
        x, y = make_task2_batch(rng, n, channels=cfg.input_channels, freq=cfg.freq_dim,
                                time_frames=4800, label_frames=600)
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    cfg16 = cfg.replace(compute_dtype="bfloat16", frontend_impl="pallas-ct")
    model = build_flagship(str(MAGPHASE_CONFIG), torch.bfloat16, dev,
                           torch.Generator().manual_seed(19), frontend_impl="pallas-ct")
    require(all(t.frontend_impl == "ct" for t in model.trunks), "trunks not on pallas-ct")
    state = create_train_state(model, cfg16, torch.Generator(device=dev).manual_seed(19))
    step = make_train_step(cfg16)
    x, y = batch(cfg.batch_size)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, x, y)
    total, times, losses = {}, [], []
    for i in range(CONFIGS_STEPS):
        t0 = time.perf_counter()
        (state, loss), counts = launches_of(torch, lambda: step(state, x, y))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        require_launches(f"MagPhase-Parallel pallas-ct step {i}", counts, MAGPHASE_PER_STEP)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    require(all(np.isfinite(losses)), f"non-finite MagPhase-Parallel losses {losses}")
    moved = {t: sum(not torch.equal(before[n], p.detach())
                    for n, p in model.named_parameters() if n.startswith(t + "."))
             for t in model.trunk_names}
    require(all(moved.values()), f"a trunk's parameters never moved: {moved}")
    ms = statistics.median(times) * 1e3
    print(f"[configs] MagPhase-Parallel pallas-ct training, bf16 batch {cfg.batch_size}: "
          f"losses {[round(v, 5) for v in losses]}; step {ms:.1f} ms (median of "
          f"{CONFIGS_STEPS}; {[round(1e3 * v, 1) for v in times]}); parameters moved per trunk "
          f"{moved}; launches { {k: v for k, v in total.items() if v} }; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    del model, state, before, x, y
    torch.cuda.empty_cache()

    # float32 batch 1: the ct path (K5, K9, K4 + K6 in each trunk) and the
    # plain path (plain stages, full attention) from the same weights and batch
    cfg32 = cfg.replace(compute_dtype="float32", dropout_perc=0.0, spatial_dropout_rate=0.0)
    base = build_flagship(str(MAGPHASE_CONFIG), torch.float32, dev,
                          torch.Generator().manual_seed(20))
    set_dropout(base, 0.0)
    step = make_train_step(cfg32)
    x, y = batch(1)
    f32 = {}
    for tag, frontend, attention in (("ct", "ct", "flash"), ("plain", "xla", "full")):
        model = copy.deepcopy(base)
        for trunk in model.trunks:
            trunk.frontend_impl, trunk.tcn.attention.impl = frontend, attention
        state = create_train_state(model, cfg32, torch.Generator(device=dev).manual_seed(1))
        (state, loss), counts = launches_of(torch, lambda: step(state, x, y))
        f32[tag] = float(loss)
        if tag == "ct":
            require(counts["ct_train_dx"] == 4 and counts["conv_train_gz"] == 2,
                    f"f32 ct step launches {counts}")
        else:
            require(not any(counts.values()), f"f32 plain step launched {counts}")
        del model, state
    d = abs(f32["ct"] - f32["plain"]) / abs(f32["plain"])
    print(f"[configs] MagPhase-Parallel f32 batch 1: ct loss {f32['ct']:.8f}, plain "
          f"{f32['plain']:.8f}, rel {d:.3e} (tol {TRAIN_LOSS_TOL})")
    require(d <= TRAIN_LOSS_TOL, f"MagPhase-Parallel f32 losses differ by {d:.3e}")
    del base, x, y
    torch.cuda.empty_cache()
    return total


def configs_predict(torch, card: str) -> None:
    """(e) The port's predict CLI on the MagPhase-Parallel config (seeded
    random init) over one one-minute clip: ``--impl auto`` with
    ``--compute_dtype=bfloat16`` (the fused path: K2 and K3 per trunk, K4, no
    K1) and ``--impl apply`` (float32, the plain featurizer and model); both
    CSVs valid and the two outputs within MAIN_TOL."""
    import numpy as np

    from seld_tpu_torch import predict
    from seld_tpu_torch.config import load_config

    cfg = load_config(str(MAGPHASE_CONFIG))
    CONFIGS_PREDICT_DIR.mkdir(parents=True, exist_ok=True)
    clip = CONFIGS_PREDICT_DIR / "clip.npy"
    np.save(clip, np.random.default_rng(21).standard_normal((CHANNELS, SR * CLIP_SECONDS),
                                                            dtype=np.float32))
    results = {}
    for tag, flags, want in (("auto", ["--compute_dtype=bfloat16"], MAGPHASE_PER_REQUEST),
                             ("apply", ["--impl=apply"], {})):
        (r,), counts = launches_of(torch, lambda: predict.main([
            f"--TextArgs={MAGPHASE_CONFIG}", "--inputs", str(clip),
            f"--out-dir={CONFIGS_PREDICT_DIR / tag}", *flags]))
        require_launches(f"predict {tag}", counts, want)
        rows = check_submission(r["csv"], cfg)
        results[tag] = r
        print(f"[configs] predict MagPhase-Parallel --impl={tag}: {rows} rows, launches "
              f"{ {k: v for k, v in counts.items() if v} }, {1e3 * r['seconds']:.1f} ms ({card})")
    d = max(float(np.abs(results["auto"][k] - results["apply"][k]).max()) for k in ("sed", "doa"))
    print(f"[configs] predict auto (fused bf16) vs apply (f32): max|d| {d:.3e} (tol {MAIN_TOL})")
    require(d <= MAIN_TOL, "predict auto and apply disagree")


def k5_b1_device_times(torch, card: str) -> dict:
    """K5's B1 (``sel_stats``) at the flagship's stage 1 (Cin 8, F 256, T
    4800, Cout 192, pf 8), batches 2 and 8, both dtypes: device time
    (device_ms, the profiler's self device time of its kernels) beside its
    events time, and the share of its byte bound (the pooled output read
    once, g where the output routes, 8 bytes a channel written)."""
    from seld_tpu_torch.ops.kernels import conv2d_train as k5
    from seld_tpu_torch.ops.kernels.conv2d_pool import (
        conv2d_smallcin_bn_relu_fpool, conv2d_windows_bn_relu_fpool,
    )

    gen = torch.Generator(device="cuda").manual_seed(22)
    cin, f, t, cout, pf = CHANNELS, 256, 4800, 192, 8
    out_rows = {}
    for b in (2, 8):
        for dt in (torch.bfloat16, torch.float32):
            x, w, gamma, beta = k5_inputs(torch, b, cin, f, t, cout, dt, gen)
            xc = x.permute(0, 3, 1, 2).contiguous()
            del x
            gc = torch.randn(b, cout, f // pf, t, generator=gen, device="cuda").to(dt)
            n = b * f * t
            sums = k5.conv_train_stats(xc, w, pf)
            mean = sums[:cout] / n
            var = torch.clamp(sums[cout:] / n - mean * mean, min=0.0)
            inv = torch.rsqrt(var + 1e-5)
            scale = gamma * inv
            bias = beta - mean * scale
            p_col, q_col = inv / scale, (bias / scale + mean) * inv
            f2 = (conv2d_windows_bn_relu_fpool if dt == torch.bfloat16
                  else conv2d_smallcin_bn_relu_fpool)
            out = f2(xc, w, scale, bias, pf)
            fn = lambda: k5.sel_stats(out, gc, p_col, q_col)
            moved = nbytes(out) + gc.element_size() * int((out > 0).sum()) + 8 * cout
            dev_ms, ev_ms = device_ms(torch, fn), time_ms(torch, fn)
            bound_ms = moved / HBM_BYTES_PER_S * 1e3
            tag = f"batch {b} {str(dt)[6:]}"
            out_rows[tag] = {"device_ms": dev_ms, "ms": ev_ms, "bound_ms": bound_ms,
                             "share": bound_ms / dev_ms}
            print(f"[k5 b1] stage 1 {tag}: device {dev_ms:.4f} ms, events {ev_ms:.4f} ms; byte "
                  f"bound {bound_ms:.4f} ms, {100 * bound_ms / dev_ms:.1f}% of it in device time "
                  f"({card})")
            del xc, gc, out
    torch.cuda.empty_cache()
    return out_rows


# ---------------------------------------------------------------- phase 10
# A seld_tpu checkpoint, written without JAX: the JAX package pickles a host copy
# of its TrainState (seld_tpu/training/checkpoint.py:36-55), whose pickle names
# these classes. The stand-ins below are pickled under those names (GLOBAL
# opcodes) in the opcode forms of the real ones: the flax struct dataclass as
# NEWOBJ () + BUILD(fields), the optax NamedTuples as NEWOBJ(fields).
class SeldTpuTrainState:
    """Written as ``seld_tpu.training.steps.TrainState``."""

    def __init__(self, **fields):
        self.fields = fields

    def __reduce_ex__(self, protocol):
        import copyreg

        return copyreg.__newobj__, (type(self),), dict(self.fields)


class SeldTpuAdamState(NamedTuple):   # optax._src.transform.ScaleByAdamState
    count: Any
    mu: Any
    nu: Any


class SeldTpuEmptyState(NamedTuple):   # optax._src.base.EmptyState
    pass


class SeldTpuInjectState(NamedTuple):   # optax.schedules._inject.InjectStatefulHyperparamsState
    count: Any
    hyperparams: Any
    hyperparams_states: Any
    inner_state: Any


def seld_tpu_train_state(state, zero_moments: bool = False) -> SeldTpuTrainState:
    """The JAX TrainState of a port ``TrainState``: params and batch_stats at
    their flax paths (``to_jax_variables``), Adam's ``mu`` / ``nu`` / ``count``
    from each parameter's torch state (zeros where a parameter has none, as
    optax keeps them; all zeros with ``zero_moments``), the learning rate,
    betas and eps as float32 hyperparameters, the step, and the dropout
    generator's seed as the PRNG key's two words."""
    import numpy as np

    from seld_tpu_torch.utils.jax_bridge import to_jax_variables

    tree = to_jax_variables(state.model)
    group = state.optimizer.param_groups[0]
    moments = {"mu": {}, "nu": {}}
    counts = set()
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        if "step" in st:
            counts.add(int(st["step"]))
        *path, leaf = name.split(".")
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            node = moments[moment]
            for k in path:
                node = node.setdefault(k, {})
            value = st[key].detach().cpu().numpy() if key in st else None
            node[leaf] = (np.zeros(tuple(p.shape), np.float32) if value is None or zero_moments
                          else np.ascontiguousarray(value))
    require(len(counts) <= 1, f"parameters at different Adam steps: {sorted(counts)}")
    count = np.asarray(counts.pop() if counts else 0, np.int32)
    f32 = lambda v: np.asarray(v, np.float32)
    hyper = {"b1": f32(group["betas"][0]), "b2": f32(group["betas"][1]), "eps": f32(group["eps"]),
             "eps_root": f32(0.0), "learning_rate": f32(group["lr"])}
    seed = state.generator.initial_seed()
    return SeldTpuTrainState(
        step=np.asarray(state.step, np.int32), params=tree["params"],
        batch_stats=tree["batch_stats"],
        opt_state=SeldTpuInjectState(count, hyper, {}, (
            SeldTpuAdamState(count.copy(), moments["mu"], moments["nu"]), SeldTpuEmptyState())),
        rng=np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32))


def write_seld_tpu_checkpoint(path, state, loop_state: dict, sched, np_rng_state,
                              zero_moments: bool = False) -> None:
    """Write a port ``TrainState`` (with the loop state, the StepLRState and a
    numpy generator's state) as the JAX package's ``save_checkpoint`` writes
    its own: a pickle of ``{format_version: 1, train_state, loop_state, sched,
    np_rng_state}`` that names six globals, the four classes above under
    their JAX names, ``numpy.dtype`` and numpy's ``_frombuffer``. The pure
    Python pickler writes each as a GLOBAL opcode and refuses anything else."""
    import dataclasses
    import pickle
    import types

    import numpy as np

    frombuffer = np.zeros(1).__reduce_ex__(5)[0]
    names = {SeldTpuTrainState: ("seld_tpu.training.steps", "TrainState"),
             SeldTpuAdamState: ("optax._src.transform", "ScaleByAdamState"),
             SeldTpuEmptyState: ("optax._src.base", "EmptyState"),
             SeldTpuInjectState: ("optax.schedules._inject", "InjectStatefulHyperparamsState"),
             np.dtype: ("numpy", "dtype"),
             frombuffer: (frombuffer.__module__, frombuffer.__name__)}

    class Pickler(pickle._Pickler):
        # functions too go through save_global below (the base table holds its own)
        dispatch = {**pickle._Pickler.dispatch,
                    types.FunctionType: lambda self, obj: self.save_global(obj)}

        def save_global(self, obj, name=None):
            if obj not in names:
                raise pickle.PicklingError(f"a seld_tpu checkpoint names no {obj!r}")
            module, qualname = names[obj]
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
            self.memoize(obj)

    payload = {"format_version": 1,
               "train_state": seld_tpu_train_state(state, zero_moments),
               "loop_state": dict(loop_state),
               "sched": dataclasses.asdict(sched) if sched is not None else None,
               "np_rng_state": np_rng_state}
    with open(path, "wb") as f:
        Pickler(f, protocol=5).dump(payload)


def checkpoint_fixtures(torch, fixture: dict) -> dict:
    """Phase 10's files: phase 6's model directory after two epochs copied
    three times under CHECKPOINTS_DIR (``port`` as it is; ``jax`` with every
    role rewritten as a seld_tpu file; ``control`` as ``jax`` with the Adam
    moments of ``checkpoint`` zeroed) and phase 7's served checkpoint as a
    seld_tpu file; each seld_tpu ``checkpoint`` read back through the port
    into the same tensors, bit for bit. Returns the run directories and the
    served file."""
    import shutil

    import numpy as np

    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.models.seld import model_from_config
    from seld_tpu_torch.training import ROLES, create_train_state, load_checkpoint
    from seld_tpu_torch.training.checkpoint import SELD_TPU, checkpoint_format

    require(bool(fixture.get("fused")) and "model_dir" in fixture,
            "phases 6 and 7 left no checkpoint fixture")
    cfg = load_config(str(FLAGSHIP_CONFIG))
    rel = fixture["model_dir"]
    runs = {tag: CHECKPOINTS_DIR / tag for tag in ("port", "jax", "control")}
    for run_dir in runs.values():
        shutil.copytree(CHECKPOINTS_DIR / "epoch2", run_dir / rel)

    # one port state takes every file in turn (a flagship build takes seconds); the
    # model stays on the host, the dropout generator is the card's, as the files'
    state = create_train_state(model_from_config(cfg, generator=torch.Generator().manual_seed(0)),
                               cfg, torch.Generator(device="cuda").manual_seed(0))

    def read(path):
        np_rng = np.random.default_rng(0)
        _, loop, sched = load_checkpoint(str(path), state, np_rng)
        return state, loop, sched, np_rng.bit_generator.state

    def snapshot():
        return ({k: v.clone() for k, v in state.model.state_dict().items()},
                [{k: v.clone() for k, v in state.optimizer.state.get(p, {}).items()}
                 for p in state.model.parameters()], state.step)

    t0 = time.perf_counter()
    written = []
    for role in ROLES.values():
        src = runs["port"] / rel / role
        if not src.is_file():
            continue
        args = read(src)
        write_seld_tpu_checkpoint(runs["jax"] / rel / role, *args)
        if role == ROLES["checkpoint"]:
            write_seld_tpu_checkpoint(runs["control"] / rel / role, *args, zero_moments=True)
            latest = snapshot()
        else:
            shutil.copyfile(runs["jax"] / rel / role, runs["control"] / rel / role)
        written.append(role)
    served = CHECKPOINTS_DIR / "served" / ROLES["checkpoint_best"]
    served.parent.mkdir(parents=True)
    write_seld_tpu_checkpoint(served, *read(fixture["fused"]["checkpoint"]))
    seconds = time.perf_counter() - t0
    require(ROLES["checkpoint"] in written, f"phase 6 left no latest checkpoint: {written}")

    # the seld_tpu file through the port's reader: every tensor as the port file's
    path = runs["jax"] / rel / ROLES["checkpoint"]
    require(checkpoint_format(str(path)) == SELD_TPU, f"{path} is not read as a seld_tpu file")
    read(path)
    back = snapshot()
    for (name, a), b in zip(latest[0].items(), back[0].values()):
        require(torch.equal(a, b), f"{name} differs after the seld_tpu round trip")
    n_moments, adam_steps = 0, set()
    for s_, t_ in zip(latest[1], back[1], strict=True):
        for key in ("exp_avg", "exp_avg_sq"):
            require(torch.equal(s_[key], t_[key]) if key in s_ else not bool(t_[key].any()),
                    f"Adam {key} differs after the seld_tpu round trip")
            n_moments += 1
        require(float(t_["step"]) == float(s_.get("step", t_["step"])), "Adam step differs")
        adam_steps.add(float(t_["step"]))
    require(back[2] == latest[2], f"step {back[2]} != {latest[2]}")
    print(f"[checkpoints] {len(written) + 1} seld_tpu files written (roles {written} of "
          f"{rel}, phase 7's {ROLES['checkpoint_best']}) in {seconds:.1f} s, "
          f"{path.stat().st_size / 2**20:.1f} MiB each; the latest read back through the port: "
          f"{len(latest[0])} model tensors and {n_moments} Adam moments bit for bit, step "
          f"{back[2]}, Adam step {sorted(adam_steps)}")
    return {"runs": runs, "served": served}


def checkpoints_predict(torch, card: str, served: Path, fixture: dict) -> dict:
    """The predict CLI on phase 7's clips through the fused bf16 path, with
    phase 7's checkpoint as a seld_tpu file: CSVs equal to phase 7's bit for
    bit. Returns the launches."""
    import numpy as np

    from seld_tpu_torch import predict

    fused = fixture["fused"]
    out_dir = CHECKPOINTS_DIR / "predict"
    results, counts = launches_of(torch, lambda: predict.main([
        f"--TextArgs={FLAGSHIP_CONFIG}", f"--checkpoint={served}", "--inputs",
        *map(str, fused["clips"]), f"--out-dir={out_dir}", *fused["flags"]]))
    require_launches("predict from the seld_tpu file", counts,
                     {k: v * len(results) for k, v in FUSED_PER_CLIP.items()})
    same = [Path(a["csv"]).read_bytes() == Path(b["csv"]).read_bytes()
            for a, b in zip(results, fused["results"], strict=True)]
    d = {k: max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(results, fused["results"]))
         for k in ("sed", "doa")}
    print(f"[checkpoints] predict --checkpoint=<seld_tpu file>, fused bf16, {len(results)} "
          f"clips: CSVs equal to phase 7's port-format run {same}, rows "
          f"{[r['events'] for r in results]}; max|d sed| {d['sed']:.3e}, max|d doa| "
          f"{d['doa']:.3e}; launches per clip "
          f"{ {k: v // len(results) for k, v in counts.items() if v} } ({card})")
    require(all(same), "predict from the seld_tpu file wrote other rows than phase 7")
    return counts


def checkpoints_resume(torch, card: str, runs: dict, fixture: dict) -> dict:
    """One more epoch through the train CLI from each copy of phase 6's
    model directory, the three runs at once, under phase 6's overrides with
    dropout off: each resumes at epoch 3 from its format, continues the
    step counter and the schedule and launches the pallas-ct kernels in
    every step; the seld_tpu file's train loss within RESUME_TOL of the port
    file's, the zeroed-moments control printed beside. Returns the launches
    of the seld_tpu run's epoch."""
    from seld_tpu_torch.training import ROLES

    rel = fixture["model_dir"]
    steps = -(-CT_CLIPS["train"] // CT_BATCH)   # per epoch
    base = torch.load(CHECKPOINTS_DIR / "epoch2" / ROLES["checkpoint"], map_location="cpu",
                      weights_only=True)
    logs = ROOT / "chip_tmp" / "train_cli_logs"
    torch.cuda.empty_cache()
    started = {}
    try:
        for tag, run_dir in runs.items():
            started[tag] = start_train_cli(run_dir, fixture["overrides"] + RESUME_FLAGS,
                                           3, logs / f"resume_{tag}.log")
        texts = {tag: finish_train_cli(started[tag], 3, logs / f"resume_{tag}.log",
                                       f"[checkpoints] {tag}:") for tag in runs}
    finally:
        for proc, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    loss, launches = {}, {}
    for tag, run_dir in runs.items():
        fmt = "port" if tag == "port" else "seld_tpu"
        want_line = f"Resuming from {rel / ROLES['checkpoint']} ({fmt} checkpoint)"
        require(want_line in texts[tag], f"{tag}: no line '{want_line}'")
        record = json.loads((run_dir / rel / "metrics.jsonl").read_text().splitlines()[-1])
        after = torch.load(run_dir / rel / ROLES["checkpoint"], map_location="cpu",
                           weights_only=True)
        require(record["epoch"] == 3 and record["step"] == base["loop_state"]["step"] + steps
                and after["loop_state"]["epochs"] == 3
                and after["step"] == base["step"] + steps
                and after["sched"]["steps_taken"] == base["sched"]["steps_taken"] + 1,
                f"{tag}: epoch {record['epoch']}, step {record['step']} / {after['step']}, "
                f"schedule {after['sched']} after resuming from step {base['step']}, "
                f"schedule {base['sched']}")
        got = record["kernel_launches"]
        want = {k: v * steps for k, v in CT_PER_STEP.items()}
        require(all(got.get(k) == v for k, v in want.items())
                and all(got.get(k, 0) >= steps for k in CT_AT_LEAST),
                f"{tag}: launches {got}, want {want} and >= {steps} of {CT_AT_LEAST}")
        loss[tag], launches[tag] = record["train_loss"], got
    rel_d = {tag: abs(loss[tag] - loss["port"]) / abs(loss["port"]) for tag in ("jax", "control")}
    print(f"[checkpoints] epoch 3 resumed, dropout off: train loss from the port file "
          f"{loss['port']:.8f}, from the seld_tpu file {loss['jax']:.8f} (rel {rel_d['jax']:.3e}, "
          f"tol {RESUME_TOL}), control with the Adam moments zeroed {loss['control']:.8f} (rel "
          f"{rel_d['control']:.3e}, {rel_d['control'] / RESUME_TOL:.1f}x the tol); step "
          f"{base['step']} -> {base['step'] + steps}, schedule steps "
          f"{base['sched']['steps_taken']} -> {base['sched']['steps_taken'] + 1}; seld_tpu "
          f"run's launches {launches['jax']} ({card})")
    require(rel_d["jax"] <= RESUME_TOL, f"resumed train losses differ by {rel_d['jax']:.3e}")
    return launches["jax"]


def phase_checkpoints(torch, card: str, fixture: dict) -> dict:
    """Phase 10, checkpoints from outside the port at the flagship's full
    width: phase 6's and phase 7's checkpoints rewritten as seld_tpu files
    (``write_seld_tpu_checkpoint``), served through the predict CLI and
    resumed through the train CLI. Returns the launches of the predict run
    and the seld_tpu resume's epoch, each kernel's own: K3's are predict's,
    K9's F2 (counted as K3's) and K5's F2 (as K10b's) the resume's."""
    import shutil

    t0 = time.perf_counter()
    try:
        files = checkpoint_fixtures(torch, fixture)
        served = checkpoints_predict(torch, card, files["served"], fixture)
        resumed = checkpoints_resume(torch, card, files["runs"], fixture)
    finally:   # phase 6's dataset stays for phase 11
        for child in CHECKPOINTS_DIR.glob("*"):
            if child.name != "data":
                shutil.rmtree(child, ignore_errors=True)
        shutil.rmtree(PREDICT_DIR, ignore_errors=True)
    print(f"[checkpoints] phase 10 took {time.perf_counter() - t0:.1f} s ({card})")
    total = {k: served.get(k, 0) + resumed.get(k, 0) for k in {*served, *resumed}}
    return {**total, "conv3x3_widecin": served["conv3x3_widecin"],
            "ct_train_fwd": resumed["conv3x3_widecin"],
            "conv_train_fwd": resumed["conv3x3_windows"]}


# ---------------------------------------------------------------- phase 11
def dp_model(torch, dev, dtype, frontend: str, attention: str):
    """Phase 11's model: the flagship at full width from seed 0 (the same
    weights in every process), dropout off, in ``dtype`` on ``dev``."""
    from seld_tpu_torch.serve import build_flagship

    model = build_flagship(str(FLAGSHIP_CONFIG), torch.float32, dev,
                           torch.Generator().manual_seed(0)).to(dtype)
    set_dropout(model, 0.0)
    model.seld_block.frontend_impl, model.seld_block.tcn.attention.impl = frontend, attention
    return model


def dp_batch():
    """Phase 11's global batch (numpy, the same in every process)."""
    import numpy as np

    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.data.synthetic import make_task2_batch

    cfg = load_config(str(FLAGSHIP_CONFIG))
    return make_task2_batch(np.random.default_rng(11), DP_BATCH, channels=CHANNELS,
                            freq=cfg.freq_dim, time_frames=4800, label_frames=600)


def dp_steps(torch, model, x, y, mesh=None) -> dict:
    """DP_STEPS float32 train steps (``make_train_step(cfg, mesh)``) of
    ``model`` on (x, y): the losses, each step's gradients (averaged over the
    ranks under ``mesh``; float64 on the host), the launches and the times."""
    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from seld_tpu_torch.training import create_train_state, make_train_step

    cfg = load_config(str(FLAGSHIP_CONFIG)).replace(
        compute_dtype="float32", dropout_perc=0.0, spatial_dropout_rate=0.0)
    state = create_train_state(model, cfg, torch.Generator(device=x.device).manual_seed(1))
    step = make_train_step(cfg, mesh)
    losses, grads, times = [], [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        grads.append({n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
                      if p.grad is not None})
    return {"losses": losses, "grads": grads, "launches": dict(launch_counts),
            "ms": [1e3 * t for t in times]}


def dp_rank(torch, rank: int, port: int, out: Path, backend: str) -> int:
    """``chip_smoke.py --dp-rank RANK PORT OUT BACKEND``: one rank of phase
    11's step, on CUDA device RANK modulo the visible ones; its losses,
    gradients, launches and all-reduces to ``out`` (torch.save)."""
    sys.path.insert(0, str(ROOT))
    import seld_tpu_torch
    from seld_tpu_torch.parallel import make_mesh, multihost, shard_batch

    seld_tpu_torch.disable_tf32()
    multihost.initialize(f"localhost:{port}", DP_RANKS, rank, backend=backend, device="cuda",
                         timeout_s=DP_TIMEOUT_S)
    dev = multihost.local_device()
    mesh = make_mesh(-1)
    x, y = shard_batch(mesh, *dp_batch(), device=dev)
    run = dp_steps(torch, dp_model(torch, dev, torch.float32, "ct", "flash"), x, y, mesh)
    run.update(rank=rank, device=str(dev), rows=x.shape[0], backend=backend,
               reduces=dict(mesh.cross_rank.counts))
    multihost.barrier("phase 11 steps")
    torch.save(run, out)
    print(json.dumps({k: run[k] for k in ("rank", "device", "rows", "losses", "ms",
                                          "launches", "reduces")}))
    multihost.shutdown()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def pak_container(torch, card: str, fixture: dict) -> Path:
    """(a) Phase 6's six pickles packed into one .seldpak by the port's
    ``pack_dataset``; every split read back bit for bit; the C++ gather
    against its numpy plain version on shuffled batches, both timed."""
    import pickle

    import numpy as np

    from seld_tpu_torch.config import SELDConfig
    from seld_tpu_torch.data.native import PakReader, build_library, pack_dataset

    t0 = time.perf_counter()
    lib = build_library()
    build_s = time.perf_counter() - t0
    paths = fixture["data_paths"]
    cfg = SELDConfig(training_predictors_path=paths["train"][0],
                     training_target_path=paths["train"][1],
                     validation_predictors_path=paths["validation"][0],
                     validation_target_path=paths["validation"][1],
                     test_predictors_path=paths["test"][0], test_target_path=paths["test"][1])
    pak = CHECKPOINTS_DIR / "data" / "task2.seldpak"
    t0 = time.perf_counter()
    pack_dataset(cfg, str(pak))
    pack_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    with PakReader(str(pak)) as reader:
        for split, (xi, yi) in zip(("train", "validation", "test"), PakReader.SPLITS.values()):
            for i, path in zip((xi, yi), paths[split]):
                with open(path, "rb") as f:
                    want = np.asarray(pickle.load(f), dtype=np.float32)
                require(np.array_equal(reader.tensor(i), want),
                        f".seldpak tensor {i} ({split}) differs from {path}")
        n = reader.shape(0)[0]
        batches = [rng.permutation(n)[:CT_BATCH] for _ in range(PAK_GATHER_BATCHES)]
        times = {"C++": [], "numpy": []}
        for idx in batches:
            for tag, fn in (("C++", reader.gather), ("numpy", reader.gather_plain)):
                t0 = time.perf_counter()
                got = fn(0, idx)
                times[tag].append(time.perf_counter() - t0)
            require(np.array_equal(reader.gather(0, idx), reader.gather_plain(0, idx)),
                    f"the C++ gather differs from numpy at rows {idx.tolist()}")
        row_bytes = 4 * int(np.prod(reader.shape(0)[1:]))
    ms = {tag: 1e3 * statistics.median(v) for tag, v in times.items()}
    gbs = {tag: CT_BATCH * row_bytes / (v / 1e3) / 1e9 for tag, v in ms.items()}
    print(f"[parallel] (a) {pak.relative_to(ROOT)}: {pak.stat().st_size / 2**20:.1f} MiB packed "
          f"in {pack_s:.2f} s (reader built in {build_s:.2f} s, {lib.name}); six tensors read "
          f"back bit for bit; the C++ gather equals numpy's on {PAK_GATHER_BATCHES} shuffled "
          f"batches of {CT_BATCH} clips: median {ms['C++']:.2f} ms ({gbs['C++']:.2f} GB/s) "
          f"against numpy's {ms['numpy']:.2f} ms ({gbs['numpy']:.2f} GB/s), page cache warm "
          f"(host of {card})")
    return pak


def pak_train_cli(torch, card: str, pak: Path, fixture: dict) -> dict:
    """(b) The train CLI from the .seldpak file: phase 6's run (pallas-ct,
    bf16, batch CT_BATCH) for one epoch; its losses beside phase 6's first
    epoch from the pickles. Returns the epoch's launches."""
    import shutil

    import numpy as np

    run_dir = ROOT / "chip_tmp" / "pak_cli"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    overrides = [o for o in fixture["overrides"] if not o.startswith("--training_predictors")]
    overrides.append(f"--training_predictors_path={pak}")
    try:
        run_train_cli(run_dir, overrides, 1, ROOT / "chip_tmp" / "train_cli_logs" / "pak.log")
        records = [json.loads(line) for line in next(
            (run_dir / "RESULTS_Original").glob("Task2/*/*/metrics.jsonl")).read_text()
            .splitlines()]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    require(len(records) == 1, f"epochs logged: {records}")
    got, want = records[0], fixture["epoch1"]
    steps = CT_CLIPS["train"] // CT_BATCH
    launches = got["kernel_launches"]
    require(all(launches.get(k) == v * steps for k, v in CT_PER_STEP.items()),
            f".seldpak epoch launches {launches}")
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("train_loss", "val_loss")}
    print(f"[parallel] (b) train CLI from the .seldpak, pallas-ct bf16 batch {CT_BATCH}, one "
          f"epoch ({steps} steps): train loss {got['train_loss']:.6f}, val {got['val_loss']:.6f}; "
          f"phase 6 from the pickles: train {want['train_loss']:.6f}, val "
          f"{want['val_loss']:.6f} (rel {rel['train_loss']:.2e} / {rel['val_loss']:.2e}, tol "
          f"{PAK_LOSS_TOL}); launches {launches} ({card})")
    require(all(np.isfinite(got[k]) for k in rel) and max(rel.values()) <= PAK_LOSS_TOL,
            f"losses from the .seldpak differ from the pickles' by {rel}")
    return launches


def dp_two_ranks(torch, card: str, backend: str) -> dict:
    """(c) DP_RANKS processes, one float32 pallas-ct step each at DP_BATCH /
    DP_RANKS rows, DP_STEPS steps; against one process at DP_BATCH and the
    plain path in float64 (phase 5a's measure). Returns rank 0's launches."""
    import shutil

    import numpy as np

    out_dir = ROOT / "chip_tmp" / f"dp_{backend}"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    torch.cuda.empty_cache()
    port = free_port()
    logs = [out_dir / f"rank{r}.log" for r in range(DP_RANKS)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(DP_RANKS):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", str(r), str(port),
                     str(out_dir / f"rank{r}.pt"), backend],
                    cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            p.wait(timeout=DP_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"{backend} rank {r} failed ({p.returncode}):\n"
                f"{log.read_text()[-3000:]}")
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    shutil.rmtree(out_dir, ignore_errors=True)
    for run in ranks:
        print(f"[parallel] (c) {backend} rank {run['rank']} on {run['device']}, {run['rows']} "
              f"rows: losses {[round(v, 8) for v in run['losses']]}, step ms "
              f"{[round(v, 1) for v in run['ms']]}; K5 "
              f"{ {k: v for k, v in run['launches'].items() if k.startswith('conv_train')} }, "
              f"K9 { {k: v for k, v in run['launches'].items() if k.startswith('ct_train')} }, "
              f"all-reduces {run['reduces']}")
        require(all(run["launches"].get(k, 0) > 0 for k in
                    (COUNTED_AS.get(n, n) for n in PARALLEL_KERNELS)),
                f"{backend} rank {run['rank']}: a kernel never ran: {run['launches']}")
        want = {k: v * DP_STEPS for k, v in DP_REDUCES_PER_STEP.items()}
        require(run["reduces"] == want, f"{backend} rank {run['rank']}: all-reduces "
                f"{run['reduces']}, want {want}")
        require(run["losses"] == ranks[0]["losses"]
                and all(torch.equal(a[n], b[n]) for a, b in zip(run["grads"], ranks[0]["grads"])
                        for n in a), f"{backend}: rank {run['rank']}'s averaged step differs "
                "from rank 0's")

    # one process at the global batch: float32 pallas-ct, and the plain path in float64
    dev = torch.device("cuda")
    x, y = (torch.from_numpy(a).to(dev) for a in dp_batch())
    ref = {}
    for tag, dt, frontend, attention in (("one f32", torch.float32, "ct", "flash"),
                                         ("f64", torch.float64, "xla", "full")):
        torch.cuda.reset_peak_memory_stats()
        model = dp_model(torch, dev, dt, frontend, attention)
        ref[tag] = dp_steps(torch, model, x.to(dt), y.to(dt))
        ref[tag]["peak"] = torch.cuda.max_memory_allocated() / 2**30
        del model
        torch.cuda.empty_cache()
    two, one, f64 = ranks[0], ref["one f32"], ref["f64"]

    def rel(run, i):
        return {n: ((run["grads"][i][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                for n, g in f64["grads"][i].items()}

    over = []
    for i in range(DP_STEPS):
        d2, d1 = rel(two, i), rel(one, i)
        l2, l1 = (abs(r["losses"][i] - f64["losses"][i]) / abs(f64["losses"][i])
                  for r in (two, one))
        worst = max(d2, key=lambda n: d2[n] / max(TRAIN_GRAD_TOL, CONTROL_FACTOR * d1[n]))
        print(f"[parallel] (c) step {i + 1} from float64: loss {DP_RANKS} ranks {l2:.3e}, one "
              f"process {l1:.3e}; gradients {DP_RANKS} ranks worst {max(d2.values()):.3e} / "
              f"median {statistics.median(d2.values()):.3e}, one process worst "
              f"{max(d1.values()):.3e} / median {statistics.median(d1.values()):.3e}; nearest "
              f"its bound: {worst} {d2[worst]:.3e} (one process {d1[worst]:.3e})")
        over += [(i + 1, n, d2[n], d1[n]) for n in d2
                 if d2[n] > max(TRAIN_GRAD_TOL, CONTROL_FACTOR * d1[n])]
        if l2 > max(TRAIN_LOSS_TOL, CONTROL_FACTOR * l1):
            over.append((i + 1, "loss", l2, l1))
    cards = len({run["device"] for run in ranks})
    print(f"[parallel] (c) {DP_RANKS} ranks over {backend} on {cards} card(s) in {wall:.1f} s "
          f"(processes started, kernels loaded, {DP_STEPS} steps); one process at batch "
          f"{DP_BATCH}: float32 pallas-ct step ms {[round(v, 1) for v in one['ms']]}, peak "
          f"{one['peak']:.2f} GiB; float64 plain peak {f64['peak']:.2f} GiB ({card})")
    require(not over, f"{DP_RANKS}-rank step further from float64 than max({TRAIN_GRAD_TOL}, "
            f"{CONTROL_FACTOR} x one process's): {over[:8]}")
    return two["launches"]


def cli_ranks(torch, card: str, pak: Path, fixture: dict) -> None:
    """(d), where more than one card is visible: the train CLI from the
    .seldpak as one nccl rank a card (the ``JAX_*`` variables) beside one
    process at the same global batch, one epoch, all at once: every rank
    logs the same lines, rank 0 alone writes the files; the one process's
    numbers printed beside (bf16, so not gated)."""
    import shutil

    n = torch.cuda.device_count()
    runs = ROOT / "chip_tmp" / "cli_ranks"
    shutil.rmtree(runs, ignore_errors=True)
    overrides = [o for o in fixture["overrides"] if not o.startswith("--training_predictors")]
    overrides.append(f"--training_predictors_path={pak}")
    port = free_port()
    started = []
    try:
        for r in range(n + 1):   # n ranks, then one process
            run_dir = runs / ("one" if r == n else "ranks")
            run_dir.mkdir(parents=True, exist_ok=True)
            env = {} if r == n else {"JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
                                     "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(r)}
            started.append(start_train_cli(run_dir, overrides, 1, runs / f"cli{r}.log", env))
        texts = [finish_train_cli(proc, 1, runs / f"cli{r}.log",
                                  f"[parallel] (d) {'rank ' + str(r) if r < n else 'one'}:")
                 for r, proc in enumerate(started)]
    finally:
        for proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    keep = ("epoch ", "TEST epoch", "train_loss ", "val_loss ", "test_loss ")
    logged = [[line.split(" (")[0] for line in t.splitlines() if line.startswith(keep)]
              for t in texts]
    writes = sorted(p.name for p in (runs / "ranks" / "RESULTS_Original").glob("Task2/*/*/*"))
    records = [len(p.read_text().splitlines())
               for p in (runs / "ranks" / "RESULTS_Original").glob("Task2/*/*/metrics.jsonl")]
    shutil.rmtree(runs, ignore_errors=True)
    print(f"[parallel] (d) train CLI as {n} nccl ranks, one a card: every rank logs alike "
          f"{all(lines == logged[0] for lines in logged[:n])}; files {writes} ({card})")
    require(all(lines == logged[0] for lines in logged[:n]), "the ranks logged apart")
    require(records == [1], f"metrics.jsonl lines per model directory: {records} (one "
            "epoch, rank 0 alone writes)")


def parallel_fixture(torch, card: str) -> dict:
    """``--parallel``'s stand-in for phase 6: its synthetic dataset and the
    CLI's first epoch from the pickles, in the fixture phase 11 reads."""
    import shutil

    from seld_tpu_torch.config import load_config
    from seld_tpu_torch.data.synthetic import gen_fake_task2_dataset

    cfg = load_config(str(FLAGSHIP_CONFIG))
    shutil.rmtree(CHECKPOINTS_DIR, ignore_errors=True)
    paths = gen_fake_task2_dataset(
        str(CHECKPOINTS_DIR / "data"), n_train=CT_CLIPS["train"], n_val=CT_CLIPS["validation"],
        n_test=CT_CLIPS["test"], channels=CHANNELS, freq=cfg.freq_dim, time_frames=4800,
        label_frames=600, sed_rate=CT_SED_RATE)
    flags = {"training": "train", "validation": "validation", "test": "test"}
    overrides = [f"--{k}_{kind}_path={paths[split][i]}" for k, split in flags.items()
                 for i, kind in enumerate(("predictors", "target"))]
    overrides += ["--results_path=results", "--frontend_impl=pallas-ct",
                  "--compute_dtype=bfloat16", f"--batch_size={CT_BATCH}", "--test_step=1",
                  "--checkpoint_step=1"]
    run_dir = ROOT / "chip_tmp" / "train_cli"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    try:
        run_train_cli(run_dir, overrides, 1, ROOT / "chip_tmp" / "train_cli_logs" / "run1.log")
        record = json.loads(next((run_dir / "RESULTS_Original").glob(
            "Task2/*/*/metrics.jsonl")).read_text().splitlines()[0])
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return {"overrides": overrides, "data_paths": paths, "epoch1": record}


def phase_parallel(torch, card: str, fixture: dict) -> dict:
    """Phase 11: training from a .seldpak container and across processes
    ((a) pack and read, (b) the train CLI from the file, (c) two ranks of one
    float32 pallas-ct step on the card; where more than one card is visible,
    (c) over nccl too, one rank a card, and (d) the CLI as one nccl rank a
    card). Returns rank 0's launches in (c), and (b)'s under the key 'pak'."""
    import shutil

    t0 = time.perf_counter()
    try:
        pak = pak_container(torch, card, fixture)
        pak_launches = pak_train_cli(torch, card, pak, fixture)
        launches = dp_two_ranks(torch, card, "gloo")
        if torch.cuda.device_count() >= DP_RANKS:
            dp_two_ranks(torch, card, "nccl")
            cli_ranks(torch, card, pak, fixture)
        else:
            print(f"[parallel] (c) nccl not run: {torch.cuda.device_count()} card visible, and "
                  "NCCL takes one rank a device")
    finally:
        shutil.rmtree(CHECKPOINTS_DIR, ignore_errors=True)
    print(f"[parallel] phase 11 took {time.perf_counter() - t0:.1f} s ({card})")
    return {**launches, "pak": pak_launches}


def parallel_only(torch) -> int:
    """``--parallel``: phases 1 and 2, a one-epoch stand-in for phase 6, and
    phase 11 (on several cards: its nccl legs), without the others."""
    sys.path.insert(0, str(ROOT))
    import seld_tpu_torch

    seld_tpu_torch.disable_tf32()
    try:
        card = phase_environment(torch)
        phase_build()
        phase_parallel(torch, card, parallel_fixture(torch, card))
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    print(card)
    return 0



def route_only(torch, package_root: Path) -> int:
    """``--k9-route [DIR]``: the environment and k9_route_times alone, on the
    package of DIR (an unpacked ``git archive`` of another commit; default
    this checkout), printing the times as one JSON line; its kernels build
    under DIR."""
    if not (package_root / "seld_tpu_torch" / "__init__.py").is_file():
        print(f"FAIL: {package_root} holds no seld_tpu_torch package")
        return 1
    sys.path.insert(0, str(package_root))
    import seld_tpu_torch
    from seld_tpu_torch.ops.kernels import conv2d_ct_train as k9

    seld_tpu_torch.disable_tf32()
    try:
        card = phase_environment(torch)
        print(f"[k9 route] package {Path(seld_tpu_torch.__file__).parent}")
        route = k9_route_times(torch, card, k9)
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    print(json.dumps({"k9_route": route}))
    print(card)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: torch is not importable: {e}")
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    if argv[:1] == ["--k9-route"]:
        return route_only(torch, Path(argv[1]).resolve() if len(argv) > 1 else ROOT)
    if argv[:1] == ["--dp-rank"] and len(argv) == 5:   # one of phase 11's ranks
        return dp_rank(torch, int(argv[1]), int(argv[2]), Path(argv[3]), argv[4])
    if argv == ["--parallel"]:
        return parallel_only(torch)
    if argv:
        print(f"FAIL: unknown arguments {argv}; run with none, --parallel or --k9-route [DIR]")
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
        serving = phase_main_path(torch, card)
        training = phase_training(torch, card)
        fixture = {}   # what phases 6 and 7 leave for phase 10
        entry = phase_entry(torch, card, fixture)
        predicted = phase_predict(torch, card, fixture)
        variants = phase_frontend_paths(torch, card)
        configs = phase_configs(torch, card)
        k5_b1 = k5_b1_device_times(torch, card)
        checkpoints = phase_checkpoints(torch, card, fixture)
        parallel = phase_parallel(torch, card, fixture)
        require("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    from seld_tpu_torch.utils.profiling import CAPTURES
    print(f"[profile] torch.profiler captures: {CAPTURES['whole']} whole, "
          f"{CAPTURES['retaken']} taken again (a bracket kernel missing)")
    paths = {"serving": (SERVING_KERNELS, serving), "training": (TRAINING_KERNELS, training),
             "training entry, pallas-ct": (CT_TRAIN_KERNELS, entry),
             "predict": (PREDICT_KERNELS, predicted), **variants,
             "configs": (CONFIG_KERNELS, configs),
             "checkpoints": (CHECKPOINT_KERNELS, checkpoints),
             "training entry, .seldpak": (CT_TRAIN_KERNELS, parallel.pop("pak")),
             "two ranks, pallas-ct f32": (PARALLEL_KERNELS, parallel)}
    extra = {"conv3x3_widecin": {"stage1_cin16": K3_CIN16_ROWS},
             "conv_train_sel_stats": {"device": k5_b1}}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "path": path,
         "launches": counts.get(name, counts.get(COUNTED_AS.get(name, name), 0)),
         **summary[name],
         **({"f32": F32_ROWS[name]} if name in F32_ROWS else {}),
         **(extra.get(name, {}) if path == "configs" else {})}
        for path, (names, counts) in paths.items()
        for name, (src, rep) in names.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
