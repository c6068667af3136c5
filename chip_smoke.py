"""Drive the PyTorch/CUDA port's serving and training paths (DCNN, with and
without its fused mid blocks, LCNN and AST, the CNNs also in bf16,
post-training int8 scoring, the serving export, seed sweeps and resident
data) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure propagates and the script exits non-zero
(there is no CPU fallback):

1. device: require CUDA, print ``nvidia-smi``'s card name and power limit;
2. build: compile ``csrc/wpt_cascade.cu``, ``csrc/fused_conv1.cu``,
   ``csrc/fused_pool.cu``, ``csrc/fused_conv2.cu``, ``csrc/flash_mha.cu``
   and ``csrc/int8_conv.cu`` for sm_90a from this checkout, all at once;
3. kernel vs plain: the wavelet-packet kernel against the plain PyTorch
   cascade on the card, at the serving shapes (B = 1, 8, 64, 128), a few
   other geometries and frames longer than one CTA holds (2 s of sym5,
   coif4, haar and db8, 1 s at 32 kHz, level-14 haar at T = 131,072), each
   on the plan its geometry picks (split depth, top route; logged), its
   launches counted, raw packets 0.0 from plain, a repeat the same bits;
   then every split depth and top route forced on one geometry, each the
   same bits as the automatic plan;
4. serve: a seeded full-width DCNN snapshot behind ``service_from_snapshot``
   on ``cuda``, answering concurrent HTTP uploads; scores checked against
   the same snapshot scored on the CPU, and the kernel's launch count read
   over exactly this run; then the same behind ``use_kernel=False``
   (serve's ``--no-kernel``): no kernel-1 launch, its scores against the
   kernel service's;
5. time: the wavelet-packet kernel through its launcher (CUDA-event
   medians) and on the device (profile) against the plain cascade at batch
   1, 8, 64 and 128, and the whole scorer (device audio -> P(fake)) with
   each at batch 64 and 128;
6. fused first block vs plain: forward, moments and ``dW/db/dalpha`` of
   the conv+PReLU+pool kernels against the plain PyTorch version, at the
   training shape (B=128, 95x256, C=64; fp32 and bf16), smaller geometries
   and a plane of an odd number of windows at C = 256; out and code NCHW
   memory; two runs compared bit for bit;
7. train: a seeded wav corpus through ``run_experiment`` on ``cuda``
   (packets-sym5 level 8, full-width DCNN with the fused first block, batch
   128, 2 epochs with validation, test and snapshot), the kernels' launch
   counts read over exactly this run; the same training with and without
   the fused block compared loss by loss; the snapshot served and its
   score held against the trainer's own;
8. time: the fused kernels alone vs plain (through the launchers, and
   their device time from a profile), the whole train step fused vs
   unfused, and the eval step, at batch 128;
9. profile: ``torch.profiler`` over a few fused train steps, device time
   by kernel; the copies of the step: none of the block's
   [128, 64, 48, 129] output or its cotangent into another layout;
10. fused LCNN block vs plain: forward, ``dW`` and ``db`` of the conv 5x5 +
    MaxFeatureMap + pool kernels against the plain PyTorch version at the
    LCNN's shape (B=128, 101x256, C=64; fp32 and bf16), the packet and LFCC
    images, an odd and a wide geometry and a case full of ties; every
    selection the kernel made is held against the plain conv values, its
    gradients are rebuilt from its own code in float64, and two runs are
    compared bit for bit;
11. train the LCNN: the same corpus through ``run_experiment`` on ``cuda``
    (stft, hop 220, log scale, full-width LCNN with the fused first block,
    batch 128, 2 epochs with validation, test and snapshot), the kernels'
    launch counts read over exactly this run; the same training fused
    against unfused loss by loss (dropout 0); a few steps each of
    packets-sym5 + LCNN and stft + LFCC + LCNN;
12. serve the trained LCNN snapshot on ``cuda`` over HTTP, scores against
    the same snapshot on the CPU;
13. time: the LCNN kernels alone vs plain, the LCNN train step fused (with
    either memory layout behind the block) vs unfused, the eval step and
    the two BLSTMs alone at batch 128; a profile of the fused LCNN step;
14. fused mid blocks vs plain: PReLU + pool (forward, moments, ``dx``,
    ``dalpha``) and conv 3x3 + PReLU + pool (forward, moments, ``dx``,
    ``dw``, ``dcorr``, ``dalpha``) against their plain PyTorch versions at
    the DCNN's shapes (B=128: [96, 48, 129] and [64, 24, 64] for the pool,
    64 -> 96 channels at 48x129 for the conv; fp32 and bf16), odd heights
    and widths, a negative and a zero slope and a case full of ties; two
    runs compared bit for bit; the pool's ``dx`` without moments bit-equal
    to plain at both pool shapes, a zero slope and ties; the conv's fp32
    forward at its headline shape
    must read 0.0 against plain (cuDNN's summation order); its fp32 dx and
    dw there are held against a float64 rebuild from its own code, under a
    cap that one TF32 pass (modelled on the same inputs) must exceed; its
    bf16 route (the tensor cores throughout): every selection code against
    the first maximum of plain's fp32 convolution, a code or a stored value
    differing only at a near-tie (and where one does, plain's gradients
    taken at the kernel's selection and stored values), ties in bf16 too,
    and its bf16 dx / dw against a float64 rebuild from its own code with
    the cotangent rounded to bf16, under caps the unrounded rebuild must
    exceed; the tensor-core (HMMA) instructions of its kernels are counted
    in the built library (``cuobjdump -sass``: dx / dw > 0 in both types,
    the bf16 forward > 0, the fp32 forward 0);
15. train with the fused mid blocks: the corpus through ``run_experiment``
    on ``cuda`` with (a) ``fused_layer1`` + ``fused_pool`` and (b) those +
    ``fused_layer2`` (2 epochs with validation, test and snapshot, dropout
    0), the kernels' launch counts read over exactly each run, each run
    against phase 7's unfused one loss by loss; the snapshot of (b) served
    over HTTP and its score held against the trainer's own;
16. time: the mid-block kernels alone vs plain (kernel 6's backward also
    as its dx, dw and dcorr / dalpha kernels' device time in a profile),
    the train step at
    batch 128 unfused, with ``fused_layer1`` only, (a) and (b), the eval
    step; a profile of step (b);
17. fused attention vs plain: forward and ``dqkv`` of kernel 4 (one route
    for every N) against the plain PyTorch version at the AST's shape
    (B=32, N=227, 12 heads of 64; fp32 and bf16), at phase 20's N=477 and
    at N = 1, 18, 99, 256 and 300, and on a qkv or a cotangent that does
    not start on a 16-byte boundary; two runs compared bit for bit; the
    tensor-core (HMMA) instructions of each of its 12 kernels counted in
    the built library (``cuobjdump -sass``);
18. train the AST: the corpus through ``run_experiment`` on ``cuda`` (stft,
    hop 220, log scale, base384 AST with the fused attention, batch 32, 2
    epochs with validation, test and snapshot), the kernel's launch counts
    read over exactly this run; the same training unfused, loss by loss; an
    epoch in bf16 with bf16 Adam moments; the trained AST behind
    ``ScoringService`` (batch 64, the whole batch at once) over HTTP, scores
    against the same model on the CPU;
19. time: kernel 4 alone vs plain and vs ``scaled_dot_product_attention``
    (the library yardstick, timed only) at N = 18, 99, 227, 256 and 477
    (B=32, 12 heads),
    the AST train step fused, unfused and bf16, the eval step, the scorer
    at batch 64, 128 and 512 with chunks of 0 (whole batch), 8, 16 and 32;
    profiles of the fused fp32 and the bf16 steps;
20. 2 s frames: the corpus cut into 2 s frames and trained through
    ``run_experiment`` on ``cuda`` with packets + DCNN (the WPT's subtrees
    on chip, no level through device memory: its launch counts read over
    exactly this run) and with stft + AST (477 tokens through kernel 4,
    counted likewise); the WPT on 2 s frames timed against plain at B=64;
21. the CNNs in bf16 (``dtype: bfloat16``): the DCNN with all three flags
    and the LCNN with its fused block trained through ``run_experiment`` on
    ``cuda``, each against the same model unfused in bf16 loss by loss,
    launches of kernels 2, 3, 5 and 6 counted and the type each was given
    read (bf16 only); ``make_score_fn`` on the bf16 DCNN object against its
    eval step; the four kernels against plain in bf16 at the path's shapes
    and argument types (kernel 6 with phase 14's code check and near-tie
    rule), timed through their launchers and as device time (kernel 6's
    backward also kernel by kernel, beside cuDNN's bf16 convolution of the
    same conv alone, a yardstick);
    the DCNN step (b) and the LCNN step in float32 and bf16, the scorer at
    B = 64 and 128 on a float32 and a bf16 DCNN object; profiles of the
    bf16 steps;
22. post-training int8: the int8 site kernel against its plain version (a
    float64 convolution of the codes) at every DCNN site shape (B = 64 and
    128), every LCNN site shape (B = 128), the dilated sites and an odd
    plane: whole sites (quantized on load, map and bias in the epilogue)
    in float32 and bf16, and the codes-in mode's int32 accumulators and
    float32 / bf16 outputs, each bit-equal, repeats the same bits; the IMMA
    instructions of its MMA variants and the IDP (dp4a) of its Cin = 1
    variants counted; phase 7's DCNN snapshot behind
    ``service_from_snapshot(int8=True, calibrate=<corpus clips>)`` over
    HTTP, the WPT's and the site kernel's launches (per site; every one
    with the baked layout) read over exactly the requests, the scores
    against the same int8 model on the CPU and against float32 on the
    card; phase 11's LCNN through ``score_files(int8=True)``; phase 18's AST
    quantized, baked and scored at B = 64, kernel 4's launches read; each
    DCNN site at B = 64 and 128 through its launcher, as device time, as
    the layer runs it, and as the codes-in composition it replaced, against
    its fused bound, plain and cuDNN's fp32 / bf16 convolutions (a
    yardstick); the DCNN and LCNN scorers at B = 64 and 128 and the AST
    scorer at B = 64 in fp32, bf16 and int8;
23. the serving export: phase 7's DCNN scorer, the same int8-baked, a DCNN
    with all three fused flags, phase 11's LCNN with its fused block and
    phase 18's AST exported with ``torch.export`` on ``cuda`` (symbolic
    batch), saved and reloaded; each graph's ``adfd`` ops asserted, its
    scores at B = 1, 64 and 128 against the eager scorer, each op's launch
    counter read over one call of the artifact; the fp32 and int8 DCNN
    artifacts timed against eager at B = 64 and 128; the dispatch of an op
    against its direct launcher (kernel 1 at B = 64, kernel 4 at N = 227);
24. sweeps and resident data: (a) a grid of 3 seeds through ``main`` with
    ``--vmap-seeds`` (full-width DCNN, all three fused flags, batch 128, 2
    epochs with validation, test and snapshots): the sweep runs ``"scan"``
    (its seed axis unless ``"vmap"`` is asked for), kernels 2, 5 and 6
    launch once per step and seed, kernel 1 once per step at 384 frames;
    each seed's losses and test metrics against its serial
    ``run_experiment``; (b) ``run_experiment_vectorized`` with
    ``seed_axis="vmap"`` (unfused, dropout 0, one epoch) against serial
    runs, kernel 1 once per step at 384 frames; (c) a
    fused model asked for ``"vmap"`` refused before any launch; (d)
    ``device_data`` with ``steps_per_call = 4`` through ``run_experiment``
    against (a)'s streamed run of seed 0, launches counted; 55,504 int16
    frames (the LJSpeech split at 1 s) parked by ``ResidentData`` with
    ``mem_get_info`` read around it, and a set over 60 % of the card
    refused before any allocation; (e) the fused step at B = 128 resident
    (G = 4), streamed through ``device_prefetch`` and on a fixed batch, with
    its host enqueue time; three seeds as serial runs, ``"scan"`` (fused),
    and serial and ``"vmap"`` (unfused); ``FrameLoader`` decoding against a
    warm frame cache (float32 and int16); a [128, 1, 22050] H2D copy;
25. analysis: level-14 haar fingerprints of the corpus through kernel 1,
    ``--only-ig`` through kernels 5 and 6, block-norm statistics, the CWT
    and the energy, against plain or the CPU, and timed;
26. data parallelism (one card: NCCL on one rank, or gloo processes on
    ``cuda:0``): (a) the headline DCNN (all three fused flags, batch 128, 2
    epochs with validation, test and snapshot) through ``main`` with
    ``--ddp`` and with ``--fsdp`` under a one-rank torchrun environment,
    loss by loss against phase 15's run without a group, kernels 1, 2, 5
    and 6 counted; one FSDP step of the base384 AST (kernel 4 in each
    block); (b) two gloo ranks on the card (``--mesh-rank``), the
    full-width DCNN at 64 frames a rank, fused (kernels 1, 2, 5, 6 on each
    rank) and unfused, and the LCNN with kernel 3, against one process at
    B = 128 (loss, the update of one SGD step, running buffers; ranks bit
    for bit; launches per rank); (c) level-14 haar fingerprints of the
    corpus sharded over the two ranks against kernel 1 and the plain
    cascade; (d) the fused step at B = 128 plain / DDP / FSDP on one NCCL
    rank, the two-rank step and the sharded cascade (host-staged), beside
    the card's name and power limit; and which collectives gloo runs on
    CUDA tensors here (``tools/dist_probe.py``);
27. the AST's model parallelism (two gloo ranks on ``cuda:0``,
    ``--mp-rank``) and ``remat_policy``: kernel 4 against plain at a rank's
    6 local heads and at one microbatch; (a) base384 tensor-parallel over
    ``("data", "model") = (1, 2)`` at B = 8 (logits, gathered gradients
    and state against one process, kernel 4's launches and head counts);
    (b) the GPipe pipeline over ``("data", "stage") = (1, 2)`` at B = 32 in
    4 microbatches (logits and gradients against one process, kernel 4's
    launches with the bubble ticks), two Trainer steps with the mesh
    against a one-process Trainer, ranks bit for bit, rank 0's snapshot in
    one process; (c) one base384 step under no remat, ``remat_blocks`` and
    each supported policy (loss, gradients, kernel 4's launches, peak
    memory); (d) the TP forward and the PP step (host-staged) against one
    process, beside the card's name and power limit.

The last lines are the kernels' JSON record, the measurements with the
card's name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import torch

SR = 22050
MAIN = ("sym5", 8)  # the serving path: level-8 sym5 packets of 1 s frames
# raw packets of unit-variance input: both sides are fp32 FIR sums of the
# same taps; peaks reach ~17, where one ulp is ~2e-6
RAW_ATOL = 2e-5
# log(|x|^2 + 1e-12) amplifies roundoff near zero coefficients
LOG_RTOL, LOG_ATOL = 1e-3, 5e-3
# P(fake) on the card vs the CPU: fp32 everywhere (TF32 off) but other
# summation orders in the transform and every convolution
SCORE_ATOL = 1e-4
WINDOWS = 7

# ---- the training path (phases 6-9)
TRAIN_SHAPE = (128, 95, 256, 64)  # B, H (time), W (packets), C of the first block
# forward of the fused block: 9 fp32 FMAs per conv value on both sides
FUSED_FWD_ATOL = 2e-5
# moments and gradients, relative to each tensor's largest entry: fp32 sums
# of up to 792,576 terms per channel (B=128) in another order than cuDNN's;
# and the two sides round the conv differently, so of 50.7 M pool windows
# the few whose two best phases lie within an ulp select another phase,
# each moving one g*x term of dW (measured 3e-4 at B=128, 3e-7 at B=2)
FUSED_SUM_RTOL = 1e-3
# bf16 gradients come back in bf16 on both sides (2**-8 of the largest)
FUSED_BF16_RTOL = 1e-2
# per-step loss, fused vs unfused training from the same seed: BatchNorm
# moments one-pass vs centred, gradient sums reordered, then Adam
LOSS_RTOL = 2e-3
# ---- the LCNN path (phases 10-13)
LCNN_SHAPE = (128, 101, 256, 64)  # B, H (time), W (frequency), C of the first block
# forward of the LCNN block: 25 fp32 FMAs per conv value on both sides
MFM_FWD_ATOL = 2e-5
# dW / db against the plain version's autograd, relative to each tensor's
# largest entry.  Nearly all of it is the plain side's: cuDNN sums 3.3 M fp32
# terms per tap at B=128 (measured 5.9e-4 and 2.9e-3 on two seeds, 1e-7 at
# B=2), while the kernel lies 2.2e-7 from the float64 rebuild below and only
# 2 of its 26 M selections differ from the plain conv's, both near-ties
MFM_SUM_RTOL = 1e-2
# a selection that differs from the plain conv's first maximum must be a
# near-tie: the two values within this many fp32 ulps of the larger
MFM_TIE_ULPS = 8
# dW / db rebuilt in float64 from the kernel's own code: what is left is the
# kernel's fp32 summation (64 terms a thread, 8 threads, 1664 blocks)
MFM_CODE_RTOL = 2e-5
# ---- the fused mid blocks (phases 14-16)
POOL2_SHAPE = (128, 96, 48, 129)  # B, C, H, W in front of the second pool
POOL3_SHAPE = (128, 64, 24, 64)  # ... and of the third
CONV2_SHAPE = (128, 64, 96, 48, 129)  # B, Cin, Cout, H, W of the second block
# PReLU + pool is elementwise: the same fp32 value on both sides; one ulp of
# room for a product the compiler may contract into a fused multiply-add
POOL_ATOL = 1e-6
# forward of the conv block: 576 fp32 FMAs per conv value on both sides
# (cuDNN's implicit-GEMM kernel happens to sum in the same order: 0.0 read)
CONV2_FWD_ATOL = 2e-5
# moments, dalpha, dw, dcorr and dx of the mid blocks, relative to each
# tensor's largest entry: fp32 sums in another order than the plain ops'
# (read: at most 3e-5, dw at B=16; 7e-6 for the pool's dalpha over 75 M terms)
MID_SUM_RTOL = 1e-3
# kernel 6's fp32 dx and dw against a float64 rebuild from its own code, of
# the largest entry: split TF32 is ~2**-22 a product, the rest the kernels'
# fp32 sums (read: dx 5.7e-6, dw 6.3e-7; cuDNN's fp32 4e-7 to 7e-7); one
# TF32 pass (~2**-11 a product; read: 3e-4) must read above this cap, and
# the check asserts that it does on the same inputs
SPLIT_TF32_RTOL = 5e-5
# bf16 dalpha of the conv block: the kernel takes the conv value back from the
# stored bf16 output (out / alpha: 2**-9 per term) and the terms cancel
MID_BF16_DALPHA_RTOL = 3e-2
# kernel 6's bf16 codes against the plain version's fp32 convolution of the
# same bf16 values: each side's conv value is 576 exact products plus corr
# (577 terms) summed in fp32, in two orders -- cuDNN's rounded sum, within
# 577 * 2**-24 * S of the exact value, and the tensor core's truncating one,
# within 577 * 2**-23 * S (S: the sum of the terms' magnitudes).  A window
# whose code differs must be a near-tie: its two values, after the PReLU
# (which scales a gap by at most max(1, |alpha|)), within the four bounds
# together, CONV2_TIE_UNITS * (S_kernel's + S_plain's); a sign bit alone may
# differ only where the value lies within CONV2_TIE_UNITS * S of zero.  The
# same bound holds the stored bf16 values: where the two sides store other
# bf16 values at the same selection, the kernel's must lie within half its
# own bf16 ulp plus max(1, |alpha|) * CONV2_TIE_UNITS * S of the plain
# side's fp32 value (a rounding near-tie; a value far below S, where the
# sum cancels, may then lie several bf16 ulps off)
CONV2_TIE_UNITS = 577 * (2.0 ** -24 + 2.0 ** -23)
# kernel 6's bf16 dw against a float64 rebuild from its own code with the
# conv-output cotangent rounded to bf16 as the kernels round it, of the
# largest entry: bf16 products are exact in fp32, so what is left is the
# kernels' fp32 sums (~1e-7 to 5e-7 in the numpy model of
# tests/test_torch_fused_conv2.py); the rebuild from the unrounded cotangent
# lies ~1.6e-3 away (the same model), and the check asserts that it reads
# above this cap on the same inputs
CONV2_BF16_D_RTOL = 1e-4
# its bf16 dx is stored in bf16, whose rounding (2**-9 of each value) hides
# the cotangent's; so dx is held by the share of its elements that differ
# from the rebuild rounded to bf16: the fp32 sums move a value across a bf16
# rounding boundary rarely (the model: 1e-4 to 2e-4 of the elements), the
# unrounded cotangent often (0.43 of them); the check asserts both sides
CONV2_BF16_DX_SHARE = 1e-2
# ---- the AST path (phases 17-19)
AST_SHAPE = (32, 227, 12)  # B, N (25 x 9 patches + cls + dist), heads of 64 (base384)
STREAM_SHAPE = (32, 477, 12)  # the same AST on 2 s frames (25 x 19 patches + 2), phase 20
# kernel 4 also timed at these token counts (B=32, 12 heads), phase 19
MHA_SWEEP_SHAPES = ((32, 18, 12), (32, 99, 12), (32, 256, 12))
AST_BATCH = 32
AST_STEPS_PER_EPOCH = 12  # 392 training frames // 32
AST_BLOCKS = 12
# kernel 4 forward, fp32: 64-term dot products and 227-term softmax sums in
# another order than cuBLAS's; the outputs are O(1)
MHA_FWD_ATOL = 1e-5
# dqkv, fp32, relative to each tensor's largest entry: sums over 227 keys or
# queries of products of such sums
MHA_GRAD_RTOL = 1e-4
# bf16: the output rounds to bf16 on both sides (2**-8 relative) and a
# probability that rounds the other way moves it by about one more ulp; the
# gradients come back in bf16 after fp32 sums in another order
MHA_BF16_FWD_RTOL = 2.0 ** -7
MHA_BF16_GRAD_RTOL = 1e-2
# per-step loss, fused vs unfused base384 training from the same seed: the
# attention's fp32 sums reordered in each of 12 blocks, then Adam
AST_LOSS_RTOL = 5e-3
# ---- the CNNs in bf16 (phase 21)
# per-step loss, the bf16 DCNN with all three flags (or the bf16 LCNN with
# its fused block) against the same model unfused in bf16, one seed, dropout
# 0: the two round to bf16 at other points (a fused block once, the layers
# after the convolution and again after the PReLU) and Adam carries that
# on; the bf16 AST's precedent
BF16_LOSS_RTOL = 2e-2
# kernel 5 on the bf16 path takes the model's float32 slope (not
# representable in bf16, so a rounded one would show)
PATH_SLOPE = 0.2371
# ---- post-training int8 (phase 22)
# (Cin, Cout, k, padding, dilation, H, W) of each int8 site's input: the DCNN
# on 1 s packets-sym5 ([B, 1, 95, 256] after the permute), the LCNN on the
# stft image ([B, 1, 101, 256])
INT8_DCNN_SITES = {
    "cnn_0": (1, 64, 3, 2, 1, 95, 256), "cnn_4": (64, 64, 1, 0, 1, 48, 129),
    "cnn_7": (64, 96, 3, 1, 1, 48, 129), "cnn_11": (96, 128, 3, 1, 1, 24, 64),
    "cnn_14": (128, 32, 3, 1, 1, 24, 64), "cnn_17": (32, 64, 3, 1, 1, 24, 64),
}
INT8_LCNN_SITES = {
    "lcnn_0": (1, 64, 5, 2, 1, 101, 256), "lcnn_3": (32, 64, 1, 0, 1, 50, 128),
    "lcnn_6": (32, 96, 3, 1, 1, 50, 128), "lcnn_10": (48, 96, 1, 0, 1, 25, 64),
    "lcnn_13": (48, 128, 3, 1, 1, 25, 64), "lcnn_16": (64, 128, 1, 0, 1, 12, 32),
    "lcnn_19": (64, 64, 3, 1, 1, 12, 32), "lcnn_22": (32, 64, 1, 0, 1, 12, 32),
    "lcnn_25": (32, 64, 3, 1, 1, 12, 32),
}
# the sites with no BatchNorm in front: bias only, no map
INT8_UNFOLDED = ("cnn_0", "lcnn_0", "lcnn_3", "lcnn_16")
# the first sites: the models hand them the transform's [B, 1, F, T] image
# permuted to [B, 1, T, F] (time on H), a view
INT8_TRANSPOSED = ("cnn_0", "lcnn_0")
INT8_EXTRA_CASES = {  # name: (B, Cin, Cout, k, padding, dilation, H, W)
    "odd-plane": (3, 16, 40, 3, 1, 1, 7, 13),
    "dil_1": (64, 12, 12, 3, 1, 1, 64, 32), "dil_4": (64, 12, 12, 5, 2, 2, 64, 32),
    "dil_7": (64, 12, 12, 7, 2, 4, 60, 28),
}
# JAX's int8 budget for served P(fake) (tests/test_int8_quality.py:105-127):
# every int8 score within 0.05 of its fp32 score, and the fp32 decision kept
# wherever the fp32 score lies more than 0.05 from 0.5
INT8_DRIFT = 0.05
# P(fake), the same int8 model (the card's scales, its weights baked on each
# side) on the card against the CPU: the float layers sum in another order
# (SCORE_ATOL), and an activation whose fp32 value lands within that
# roundoff of a code's rounding boundary takes the neighbouring code on the
# other side, moving one input of a site by one quantization step; a few
# such codes in a frame's ~10^6 move P(fake) by far less than this
INT8_CPU_ATOL = 2e-3
INT8_FLOP_PER_S = 1979e12  # dense int8 tensor-core rate, H100 SXM data sheet
# ---- the serving export (phase 23)
# P(fake), the reloaded artifact against the eager scorer on the same card:
# both run the same ops on the same inputs, so anything but the same bits
# is reported with its size; this bound takes a changed summation order in
# one layer, not a wrong kernel or a wrong weight
EXPORT_ATOL = 2e-6
EXPORT_BATCHES = (1, 64, 128)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense tensor-core rate, H100 SXM data sheet
TF32_FLOP_PER_S = 495e12  # the same, TF32
BATCH = 128
STEPS_PER_EPOCH = 3
EPOCHS = 2


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header (``[n ...]``) also gets the seconds
    since the script started."""
    if msg[:1] == "[" and msg[1:2].isdigit():
        head, sep, rest = msg.partition("\n")
        msg = f"{head} (t = {time.perf_counter() - _T0:.1f} s){sep}{rest}"
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


LONG_CASES = (  # B, T, wavelet, level: frames longer than one CTA holds;
    # the first is phase 20's DCNN batch of 2 s frames, the row of the long route
    (64, 2 * SR, "sym5", 8), (2, 2 * SR, "coif4", 8), (2, 2 * SR, "haar", 8),
    (2, 2 * SR, "db8", 8), (3, 32000, "sym5", 8), (2, 8 * 2 ** 14, "haar", 14),
)


def wpt_counts(wpt_cuda):
    """(subtree kernel calls, top-level kernel launches) so far."""
    return wpt_cuda.LAUNCHES, wpt_cuda.LEVEL_LAUNCHES


def kernel_vs_plain(wpt_cuda, wpt):
    """Phase 3: every listed geometry, raw and with the log, on the plan its
    geometry picks (split depth k, top route); each launch counted; raw
    packets 0.0 from plain (the same fmaf chains), a repeat the same bits;
    then every split depth and top route forced on one geometry, each the
    same bits as the automatic plan."""
    gen = torch.Generator().manual_seed(0)
    # (wavelet, level, B, T, exact): exact where the first kernel's run read
    # 0.0 against plain (every geometry it had), RAW_ATOL for the others
    cases = [
        (*MAIN, 64, SR, True), (*MAIN, 128, SR, True), (*MAIN, 1, SR, True),
        (*MAIN, 8, SR, False), ("haar", 8, 3, 4096, True), ("db4", 5, 5, 2048, True),
        ("coif4", 4, 4, 2048, True), ("db2", 6, 300, 4096, False),
    ] + [(name, level, b, t, True) for b, t, name, level in LONG_CASES]
    errs, splits = {}, set()
    for name, level, b, t, exact in cases:
        x = torch.randn(b, t, generator=gen).cuda()
        plan = wpt_cuda.launch_args(name, b, t, level, False, 2.0, x.device.index)[1]
        before = wpt_counts(wpt_cuda)
        got = wpt_cuda.wpt_packets_cuda(x, name, level)
        want = wpt.wpt_analysis(x, name, level)
        again = wpt_cuda.wpt_packets_cuda(x, name, level)
        torch.cuda.synchronize()
        moved = tuple(v - w for v, w in zip(wpt_counts(wpt_cuda), before))
        if moved != (2, 2 * plan.in_level):
            raise AssertionError(f"{name} L={level} B={b} T={t}: launches {moved} for {plan}")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} L={level} B={b} T={t}: a repeat differs")
        splits.add(plan.split)
        err = (got - want).abs().max().item()
        errs[f"{name}-L{level}-B{b}-T{t}"] = err
        log(f"  raw {name} L={level} B={b} T={t} (k={plan.split}, top {plan.top}, "
            f"{plan.threads} threads, {plan.smem_bytes} B): max|err| {err:.3e} "
            f"(peak {want.abs().max().item():.3f})")
        if not (err == 0.0 if exact else err <= RAW_ATOL):
            raise AssertionError(f"kernel vs plain {name} L={level} B={b} T={t}: {err}")
        if (name, level) == MAIN or t > SR:
            got = wpt_cuda.wpt_packets_cuda(x, name, level, log_scale=True)
            want = wpt.log_power(want, 2.0)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=LOG_RTOL, atol=LOG_ATOL)
            lerr = (got - want).abs().max().item()
            errs[f"log-{name}-L{level}-B{b}-T{t}"] = lerr
            log(f"  log {name} L={level} B={b} T={t}: max|err| {lerr:.3e}")
    # every split depth and top route on one geometry: the same bits
    x = torch.randn(3, SR, generator=gen).cuda()
    ref = wpt_cuda.wpt_packets_cuda(x, *MAIN, log_scale=True)
    lengths = wpt_cuda.level_lengths(SR, 10, MAIN[1])
    limit = wpt_cuda.device_limits(x.device.index)[1]
    forced = []
    for k in range(MAIN[1]):
        for top in ("frame", "path", "levels", "levels-all"):
            plan = wpt_cuda.make_plan(lengths, 10, k, top, 3, smem_limit=limit)
            if plan in forced or plan.smem_bytes > limit:
                continue
            forced.append(plan)
            before = wpt_counts(wpt_cuda)
            got = wpt_cuda.wpt_packets_cuda(x, *MAIN, log_scale=True, plan=plan)
            torch.cuda.synchronize()
            moved = tuple(v - w for v, w in zip(wpt_counts(wpt_cuda), before))
            if moved != (1, plan.in_level) or not torch.equal(got, ref):
                raise AssertionError(f"forced {plan}: launches {moved}, "
                                     f"max|diff| {(got - ref).abs().max().item()}")
    splits |= {p.split for p in forced}
    log(f"  {len(forced)} forced plans (k = 0 .. {MAIN[1] - 1}, each top route) at B=3: "
        f"the same bits as the automatic plan; split depths reached {sorted(splits)}")
    if splits != set(range(MAIN[1])):
        raise AssertionError(f"split depths reached: {sorted(splits)}")
    return errs


def write_snapshot(root: str) -> str:
    """Seeded full-width DCNN with random BN stats, config-encoded name,
    and a ``.norm.pkl`` sidecar."""
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.utils.config import default_config
    from audiodeepfake_detection_tpu_torch.utils.naming import experiment_model_file

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DCNN(time_dim=12)
    gen = torch.Generator().manual_seed(1)
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            c = mod.num_features
            mod.running_mean.copy_(torch.rand(c, generator=gen) - 0.5)
            mod.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
            if mod.affine:
                mod.weight.data.copy_(0.5 + torch.rand(c, generator=gen))
                mod.bias.data.copy_(0.4 * torch.rand(c, generator=gen) - 0.2)
    args = default_config()
    args.update(
        data_prefix="x/fake_22050_22050_0.7_fbmelgan", transform="packets",
        wavelet=MAIN[0], num_of_scales=2 ** MAIN[1],
        only_use=["ljspeech", "fbmelgan"],
    )
    os.makedirs(os.path.join(root, "models"))
    path = experiment_model_file(args, root, "DCNN") + ".pt"
    torch.save(model.state_dict(), path)
    with open(path + ".norm.pkl", "wb") as fh:
        pickle.dump([np.asarray([-5.0], np.float32), np.asarray([4.0], np.float32)], fh)
    return path


def keep_snapshot(snapshot: str, where: str) -> str:
    """Copy a config-encoded snapshot and its ``.norm.pkl`` to ``where``/models
    under the same name (the name carries its configuration)."""
    import shutil

    os.makedirs(os.path.join(where, "models"), exist_ok=True)
    kept = os.path.join(where, "models", os.path.basename(snapshot))
    for suffix in ("", ".norm.pkl"):
        shutil.copy(snapshot + suffix, kept + suffix)
    return kept


def wav_bytes(pcm: np.ndarray, rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def http(url: str, body: bytes | None = None):
    req = urllib.request.Request(url, data=body, method="POST" if body else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def serve(wpt_cuda, snapshot: str, kernel_on_path: bool = True):
    """Phases 4 and 12: HTTP uploads scored on the card.  The DCNN snapshot's
    transform is the wavelet-packet kernel (``kernel_on_path``); the LCNN
    snapshot's is the STFT, and its fused block is for training only."""
    from audiodeepfake_detection_tpu_torch.train.predict import (
        build_scorer_from_snapshot,
        make_score_fn,
    )
    from audiodeepfake_detection_tpu_torch.train.serve import service_from_snapshot

    rng = np.random.RandomState(7)
    clips = [  # (seconds, rate): 1 s, 2.5 s and 5 s at 22050 Hz; 2 s at 44100
        (1.0, SR), (2.5, SR), (5.0, SR), (2.0, 2 * SR),
    ]
    pcms = [rng.randint(-12000, 12000, int(s * r)).astype(np.int16) for s, r in clips]
    svc = service_from_snapshot(snapshot, device="cuda", batch_size=64)
    model, transform, _ = build_scorer_from_snapshot(snapshot)
    cpu_score = make_score_fn(model, transform, "cpu")

    def reset():
        wpt_cuda.LAUNCHES = 0

    def read():
        return wpt_cuda.LAUNCHES

    return serve_service(svc, cpu_score, clips, pcms, reset, read, kernel_on_path)


def serve_plain_cascade(wpt_cuda, snapshot: str, kernel_served: dict) -> dict:
    """Phase 4, last: the snapshot behind ``service_from_snapshot(...,
    use_kernel=False)`` (serve's ``--no-kernel``): the same uploads, no
    kernel-1 launch over them, the scores against the CPU and against the
    kernel service's within the serving tolerance."""
    from audiodeepfake_detection_tpu_torch.train.predict import (
        build_scorer_from_snapshot, make_score_fn)
    from audiodeepfake_detection_tpu_torch.train.serve import service_from_snapshot

    rng = np.random.RandomState(7)  # phase 4's clips
    clips = [(1.0, SR), (2.5, SR), (5.0, SR), (2.0, 2 * SR)]
    pcms = [rng.randint(-12000, 12000, int(s * r)).astype(np.int16) for s, r in clips]
    svc = service_from_snapshot(snapshot, device="cuda", batch_size=64, use_kernel=False)
    model, transform, _ = build_scorer_from_snapshot(snapshot)
    cpu_score = make_score_fn(model, transform, "cpu")

    def reset():
        wpt_cuda.LAUNCHES = wpt_cuda.LEVEL_LAUNCHES = 0

    def read():
        return wpt_cuda.LAUNCHES + wpt_cuda.LEVEL_LAUNCHES

    out = serve_service(svc, cpu_score, clips, pcms, reset, read, kernel_on_path=False)
    diff = max(float(np.abs(np.asarray(a["frame_scores"]) - np.asarray(b["frame_scores"])).max())
               for a, b in zip(out["clips"], kernel_served["clips"]))
    out["max_abs_diff_vs_kernel_service"] = diff
    log(f"  --no-kernel service: {out['launches']} kernel-1 launches, max |plain - kernel "
        f"service| {diff:.3e} (limit {SCORE_ATOL})")
    if out["launches"] != 0 or not diff <= SCORE_ATOL:
        raise AssertionError(f"--no-kernel service: {out['launches']} launches, diff {diff}")
    return out


def serve_service(svc, cpu_score, clips, pcms, reset, read, kernel_on_path: bool = True,
                  atol: float = SCORE_ATOL):
    """Concurrent HTTP uploads (and one garbage body) scored by ``svc`` on the
    card, held against ``cpu_score`` within ``atol``; ``reset`` / ``read``
    zero and read the launch count of the kernel on the serving path."""
    server = svc.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    url = f"http://127.0.0.1:{server.server_port}"
    results = [None] * (len(clips) + 1)

    def client(i):
        body = wav_bytes(pcms[i], clips[i][1]) if i < len(clips) else b"\x00garbage" * 64
        results[i] = http(url + "/score", body)

    with svc:
        thread.start()
        try:
            d0 = svc.n_dispatches
            reset()
            t0 = time.perf_counter()
            workers = [threading.Thread(target=client, args=(i,)) for i in range(len(results))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=300)
            health = http(url + "/healthz")
            torch.cuda.synchronize()
            launches = read()
            wall = time.perf_counter() - t0
            dispatches = svc.n_dispatches - d0
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
    if any(w.is_alive() for w in workers) or thread.is_alive():
        raise RuntimeError("a client or the server thread did not finish")

    code, payload = results[-1]
    if code != 400:
        raise AssertionError(f"garbage body: expected 400, got {code} {payload}")
    code, payload = health
    if code != 200 or payload["status"] != "ok" or not payload["device"].startswith("cuda"):
        raise AssertionError(f"/healthz: {code} {payload}")
    log(f"  /healthz: {payload}")

    worst, served = 0.0, []
    for (sec, rate), pcm, (code, payload) in zip(clips, pcms, results):
        if code != 200:
            raise AssertionError(f"{sec} s clip at {rate} Hz: {code} {payload}")
        frames = svc.frame_clip(pcm.astype(np.float32) / 32768.0, rate)
        want_n = int(sec * SR) // SR
        p = np.asarray(payload["frame_scores"])
        if payload["frames"] != want_n or len(frames) != want_n:
            raise AssertionError(f"{sec} s clip: {payload['frames']} frames, want {want_n}")
        if not (np.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()
                and 0 <= payload["p_fake"] <= 1):
            raise AssertionError(f"{sec} s clip: scores out of range {payload}")
        ref = cpu_score(torch.from_numpy(frames[:, None, :])).numpy()
        err = float(np.abs(p - ref).max())
        worst = max(worst, err)
        served.append({"p_fake": payload["p_fake"], "frame_scores": p.tolist()})
        log(f"  {sec} s @ {rate} Hz: {payload['frames']} frames, p_fake "
            f"{payload['p_fake']:.6f}, max|cuda - cpu| {err:.3e}")
    if not worst <= atol:
        raise AssertionError(f"cuda vs cpu scores: {worst} > {atol}")
    if kernel_on_path and launches < max(dispatches, 1):
        raise AssertionError(
            f"kernel launched {launches} times for {dispatches} dispatches"
        )
    log(f"  {dispatches} dispatches, {launches} kernel launches, "
        f"{wall:.3f} s wall for {len(results)} requests")
    return {"dispatches": dispatches, "launches": launches,
            "max_abs_err_cuda_vs_cpu": worst, "clips": served}


def median_ms(fns: dict, reps: int) -> dict:
    """Median over WINDOWS windows of CUDA-event ms per call; the order of
    the functions alternates between windows."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    names = list(fns)
    for w in range(WINDOWS):
        for name in names if w % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[name]()
            stop.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(stop) / reps)
    return {name: statistics.median(v) for name, v in times.items()}


def back_to_back_ms(fn, n: int) -> float:
    """Device ms per call of ``fn`` by CUDA events over ``n`` calls queued
    behind a spin of the card (``torch.cuda._sleep``, ~10 ms), so that no
    host gap lies between them.  It holds every kernel the call launches,
    so it is logged when CUPTI kept no record of a kernel, and never stands
    in for that kernel's own device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def ms_or_not(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def wpt_device_ms(wpt_cuda, fn, n: int = 20) -> float | None:
    """Device ms per call of ``fn`` in the WPT kernels: their mean duration
    in a profile of ``n`` calls times the launches one call makes (read
    from the launch counters), so a profile that lost a few records still
    reads right.  None: not measured (eight profiles kept no record)."""
    from torch.profiler import ProfilerActivity, profile

    before = wpt_counts(wpt_cuda)
    fn()
    torch.cuda.synchronize()
    launches = sum(wpt_counts(wpt_cuda)) - sum(before)
    fn()
    torch.cuda.synchronize()
    for _ in range(8):  # a profile that lost every record is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "wpt_" in e.key]
        count = sum(e.count for e in rows)
        if count:
            break
    else:
        # the kernels' device time is then not measured; the whole call's
        # time is logged, and read as no kernel's
        ms = back_to_back_ms(fn, n)
        log(f"  eight profiles kept no WPT record: the kernels' device time is not "
            f"measured (the whole call, back to back by CUDA events: {ms:.4f} ms)")
        return None
    return sum(e.self_device_time_total for e in rows) / count / 1e3 * launches


def wpt_times(wpt_cuda, wpt, x, reps: int = 20) -> dict:
    """The cascade with the log on ``x``: through the launcher against the
    plain version (CUDA events), and the kernels' device time from a
    profile (the launcher's host work is not in it)."""
    def kernel():
        return wpt_cuda.wpt_packets_cuda(x, *MAIN, log_scale=True)

    ms = median_ms({"plain": lambda: wpt.log_power(wpt.wpt_analysis(x, *MAIN), 2.0),
                    "kernel": kernel}, reps=reps)
    device = wpt_device_ms(wpt_cuda, kernel)
    plan = wpt_cuda.launch_args(MAIN[0], *x.shape, MAIN[1], True, 2.0, x.device.index)[1]
    return {"wpt_kernel_ms": ms["kernel"], "wpt_plain_ms": ms["plain"],
            "wpt_device_ms": device, "split": plan.split, "top": plan.top,
            "threads": plan.threads, "smem_bytes": plan.smem_bytes}


def timing(wpt_cuda, wpt, snapshot: str, card_line: str):
    """Phase 5: the cascade (launcher, device time) against plain at B = 1,
    8, 64 and 128, and the whole scorer with each at B = 64 and 128."""
    from audiodeepfake_detection_tpu_torch.train.predict import (
        build_scorer_from_snapshot,
        make_score_fn,
    )

    scorers = {}
    for use_kernel in (True, False):
        model, transform, _ = build_scorer_from_snapshot(snapshot, use_kernel=use_kernel)
        scorers[use_kernel] = make_score_fn(model, transform, "cuda")
    out = {}
    gen = torch.Generator().manual_seed(3)
    for b in (1, 8, 64, 128):
        x = torch.randn(b, SR, generator=gen).cuda()
        out[b] = wpt_times(wpt_cuda, wpt, x)
        bound, _ = wpt_bound(wpt, b, SR)
        log(f"  B={b} [{card_line}]: WPT kernel {out[b]['wpt_kernel_ms']:.4f} ms through "
            f"the launcher, {ms_or_not(out[b]['wpt_device_ms'])} ms on the device (k="
            f"{out[b]['split']}, top {out[b]['top']}, {out[b]['threads']} threads, "
            f"{out[b]['smem_bytes']} B), plain {out[b]['wpt_plain_ms']:.4f} ms, "
            f"bound {bound:.5f} ms")
        if b < 64:
            continue
        audio = (0.3 * x)[:, None, :].contiguous()
        sms = median_ms(
            {
                "plain": lambda: scorers[False](audio),
                "kernel": lambda: scorers[True](audio),
            },
            reps=5,
        )
        out[b].update({
            "scorer_kernel_ms": sms["kernel"], "scorer_plain_ms": sms["plain"],
            "scorer_kernel_frames_per_s": b / sms["kernel"] * 1e3,
            "scorer_plain_frames_per_s": b / sms["plain"] * 1e3,
        })
        log(f"  B={b}: scorer kernel {sms['kernel']:.3f} ms "
            f"({out[b]['scorer_kernel_frames_per_s']:.1f} frames/s), plain "
            f"{sms['plain']:.3f} ms ({out[b]['scorer_plain_frames_per_s']:.1f} frames/s)")
    return out


def bound_ms(n_bytes: float, n_flops: float, flop_per_s: float = FP32_FLOP_PER_S):
    """Least time the card could take: (ms, "bytes" or "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / flop_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def wpt_bound(wpt, b: int, t: int, wavelet: str = MAIN[0], level: int = MAIN[1]):
    """The frame read once and the last level written once; 2 flops per tap
    per output of every level (either route: the long-frame route's level
    round trips are its own cost, not the function's)."""
    filt_len = wpt.dec_kernel(wavelet, "cpu").shape[-1]
    flops, n = 0, t
    for lvl in range(level):
        n = (n + filt_len - 1) // 2
        flops += (2 << lvl) * n * 2 * filt_len
    return bound_ms(4 * b * (t + (2 ** level) * n), b * flops)


def fused_bounds(b, h, w, c, itemsize=4, flop_per_s=FP32_FLOP_PER_S):
    """Training forward: x and the parameters read, out, code and moments
    written; 36 FMAs per output.  Backward: g, code, x, the parameters and
    the moments' cotangents read (not out: the kernel rebuilds it from x
    and the code), dW/db/dalpha written; 9 FMAs per output for dW, one add
    for db."""
    n_out = b * ((h + 2) // 2) * ((w + 2) // 2) * c
    params = 4 * (9 * c + c + 1)
    fwd = bound_ms(itemsize * b * h * w + params + n_out * (itemsize + 1) + 8 * c,
                   n_out * 72, flop_per_s)
    bwd = bound_ms(itemsize * b * h * w + params + n_out * (itemsize + 1) + 8 * c
                   + params, n_out * 20, flop_per_s)
    return fwd, bwd


def fused_case(fc, b, h, w, c, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    make = lambda *shape, scale=1.0: (  # noqa: E731
        scale * torch.randn(*shape, generator=gen)).cuda().to(dtype)
    x = make(b, h, w)
    params = [make(9, c, scale=0.3), make(c, scale=0.1),
              torch.tensor([0.25]).cuda().to(dtype)]
    params = [p.requires_grad_() for p in params]
    h2, w2 = fc.pad_geometry(h, w)
    # the output's cotangent as cuDNN hands it back: NCHW memory
    cot = [make(b, c, h2, w2).permute(0, 2, 3, 1), make(c, scale=0.01).float(),
           make(c, scale=0.001).float()]
    return x, params, cot


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def fused_vs_plain(fc):
    """Phase 6: kernel 2 against its plain version, and against itself."""
    out = {}
    # (3, 101, 256, 256): a 51 x 129 plane, not a multiple of four windows
    # (the backward copies its g and codes element by element), and the
    # most channels
    cases = [(*TRAIN_SHAPE, torch.float32), (*TRAIN_SHAPE, torch.bfloat16),
             (2, 95, 256, 16, torch.float32), (2, 101, 256, 8, torch.float32),
             (2, 87, 256, 4, torch.float32), (2, 87, 256, 4, torch.bfloat16),
             (3, 101, 256, 256, torch.float32)]
    for i, (b, h, w, c, dtype) in enumerate(cases):
        x, params, cot = fused_case(fc, b, h, w, c, dtype, seed=10 + i)
        runs = []
        for _ in range(2):
            y, s, q = fc.fused_conv1_prelu_pool_stats(x, *params)
            runs.append((y, s, q, *torch.autograd.grad([y, s, q], params, cot)))
        torch.cuda.synchronize()
        py, ps, pq = fc.plain_conv1_prelu_pool_stats(x, *params)
        pgrads = torch.autograd.grad([py, ps, pq], params, cot)
        torch.cuda.synchronize()
        y, s, q, *grads = runs[0]
        if not y.permute(0, 3, 1, 2).is_contiguous():
            raise AssertionError(f"fused conv1 at B{b}-H{h}-W{w}-C{c}: out is not NCHW memory")
        bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
        fp32 = dtype == torch.float32
        fwd_err = (y.float() - py.float()).abs().max().item()
        fwd_tol = FUSED_FWD_ATOL if fp32 else py.float().abs().max().item() * 2.0 ** -7
        sums = {"sum": rel_err(s, ps), "sumsq": rel_err(q, pq)}
        gerr = {n: rel_err(g, pg) for n, g, pg in zip(("dW", "db", "dalpha"), grads, pgrads)}
        key = f"B{b}-H{h}-W{w}-C{c}-{str(dtype).split('.')[-1]}"
        out[key] = {
            "fwd_max_abs_err": fwd_err, "moments_rel_err": sums, "grad_rel_err": gerr,
            "dW_max_abs_err": (grads[0].float() - pgrads[0].float()).abs().max().item(),
            "dW_max_abs": pgrads[0].float().abs().max().item(), "bitwise_repeat": bitwise,
        }
        log(f"  {key}: out max|err| {fwd_err:.3e} (tol {fwd_tol:.1e}), moments rel "
            f"{max(sums.values()):.2e}, grads rel {gerr}, repeat bit-equal {bitwise}")
        grad_tol = FUSED_SUM_RTOL if fp32 else FUSED_BF16_RTOL
        if not (fwd_err <= fwd_tol and max(sums.values()) <= FUSED_SUM_RTOL
                and max(gerr.values()) <= grad_tol):
            raise AssertionError(f"fused conv1 vs plain at {key}: {out[key]}")
        if not bitwise:
            raise AssertionError(f"fused conv1 at {key}: two runs differ")
    return out


def write_corpus(root: str) -> str:
    """Seeded wav corpus: ``A_ljspeech`` (harmonics in noise) and
    ``B_fbmelgan`` (the same plus a weak comb of high tones), 28 clips of
    10 s each per directory: 280 one-second frames per label, so the 70 %
    training split holds 392 frames = 3 steps of 128."""
    rng = np.random.RandomState(11)
    t = np.arange(10 * SR) / SR
    for dirname, fake in (("A_ljspeech", False), ("B_fbmelgan", True)):
        os.makedirs(os.path.join(root, "data", dirname))
        for i in range(28):
            f0 = 110.0 + 8.0 * i
            x = sum(np.sin(2 * np.pi * f0 * k * t + rng.rand() * 6.28) / k for k in range(1, 6))
            x = 0.15 * x + 0.02 * rng.randn(t.size)
            if fake:
                x = x + 0.01 * sum(np.sin(2 * np.pi * f * t) for f in (7350.0, 8820.0, 10290.0))
            with open(os.path.join(root, "data", dirname, f"clip{i:02d}.wav"), "wb") as fh:
                fh.write(wav_bytes(np.clip(x, -1, 1) * 32767, SR))
    return os.path.join(root, "data")


def train_args(root: str, data: str, log_dir: str, **extra):
    from audiodeepfake_detection_tpu_torch.utils.config import default_config

    args = default_config()
    args.update(
        data_path=data, save_path=os.path.join(root, "meta"),
        data_prefix=data + "/fake_22050_22050_0.7_fbmelgan",
        log_dir=os.path.join(root, log_dir), transform="packets", wavelet=MAIN[0],
        num_of_scales=2 ** MAIN[1], log_scale=True, batch_size=BATCH, epochs=EPOCHS,
        learning_rate=4e-4, weight_decay=1e-3, model="modules", module="DCNN",
        flattend_size=320, time_dim_add=1, calc_normalization=True,
        only_use=["ljspeech", "fbmelgan"], fused_layer1=True, seed=0, device="cuda",
    )
    args.update(extra)
    return args


def served_vs_trainer(trainer) -> float:
    """The snapshot behind the serving path scores like the trainer itself."""
    from audiodeepfake_detection_tpu_torch.train.serve import service_from_snapshot

    clip = (0.3 * np.tanh(np.random.RandomState(13).randn(3 * SR))).astype(np.float32)
    frames = torch.from_numpy(clip.reshape(3, 1, SR)).cuda()
    own = trainer.eval_step(
        {"audio": frames, "label": torch.zeros(3, dtype=torch.int32, device="cuda")}
    )["scores"].cpu().numpy()
    with service_from_snapshot(trainer.snapshot_path, device="cuda", batch_size=64) as svc:
        p_fake, served = svc.score_clip(clip, SR)
    err = float(np.abs(np.asarray(served) - own).max())
    log(f"  snapshot served on cuda: p_fake {p_fake:.6f}, max|served - trainer| {err:.3e}")
    if not err <= SCORE_ATOL:
        raise AssertionError(f"served vs trainer scores: {err} > {SCORE_ATOL}")
    return err


def train(wpt_cuda, fused_cuda, root: str, data: str):
    """Phase 7: the training path through ``run_experiment`` on the card."""
    from audiodeepfake_detection_tpu_torch.train.experiment import run_experiment

    # the main path: the reference's defaults (dropout 0.6 / 0.3) with both
    # augmentations on
    wpt_cuda.LAUNCHES = fused_cuda.FWD_LAUNCHES = fused_cuda.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer = run_experiment(
        train_args(root, data, "log_main", aug_contrast=True, aug_noise=True))
    torch.cuda.synchronize()
    counts = {"wpt": wpt_cuda.LAUNCHES, "fwd": fused_cuda.FWD_LAUNCHES,
              "bwd": fused_cuda.BWD_LAUNCHES}
    wall = time.perf_counter() - t0
    steps = EPOCHS * STEPS_PER_EPOCH
    eval_steps = len(trainer.validation_list)  # one batch per loop on this corpus
    losses = [row[2] for row in trainer.loss_list]
    log(f"  main run: {steps} steps, losses {['%.4f' % v for v in losses]}, test "
        f"{trainer.test_results}, launches {counts}, {wall:.1f} s wall")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"main run losses: {losses}")
    if not (counts["fwd"] == counts["bwd"] == steps and counts["wpt"] >= steps + eval_steps):
        raise AssertionError(f"launch counts {counts} for {steps} train / {eval_steps} eval steps")
    if trainer.model.fused_layer1 is not True or trainer.device.type != "cuda":
        raise AssertionError("the main run left the fused path or the card")
    acc, eer = trainer.test_results[:2]
    if not (0.0 <= acc <= 1.0 and 0.0 <= eer <= 1.0):  # NaN fails too
        raise AssertionError(f"test results {trainer.test_results}")

    # fused vs unfused from the same seed, dropout 0 on both sides
    pair = {}
    for name, flag in (("fused", True), ("unfused", False)):
        run = run_experiment(train_args(
            root, data, f"log_{name}", fused_layer1=flag, dropout_cnn=0.0, dropout_lstm=0.0))
        pair[name] = [row[2] for row in run.loss_list]
    worst = max(abs(a - b) / abs(b) for a, b in zip(pair["fused"], pair["unfused"]))
    log(f"  fused   losses {['%.6f' % v for v in pair['fused']]}")
    log(f"  unfused losses {['%.6f' % v for v in pair['unfused']]} (worst rel diff {worst:.2e})")
    if not worst <= LOSS_RTOL:
        raise AssertionError(f"fused vs unfused losses differ by {worst} > {LOSS_RTOL}")

    err = served_vs_trainer(trainer)
    return {"launches": counts, "steps": steps, "eval_steps": eval_steps,
            "losses": losses, "fused_losses": pair["fused"],
            "unfused_losses": pair["unfused"], "loss_rel_diff": worst,
            "served_vs_trainer": err, "wall_s": wall, "snapshot": trainer.snapshot_path,
            "norm": [np.asarray(v).tolist() for v in trainer.norm_stats]}


def step_fns(norm, fused: bool, dtype=None, **flags):
    """A train step and an eval step at full width on a fixed device batch;
    ``flags``: the DCNN's ``fused_pool`` / ``fused_layer2``; ``dtype``: its
    compute type (``None``: float32)."""
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.train.steps import (
        make_eval_step, make_optimizer, make_train_step)
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    args = train_args("", "", "")
    transform = normalized_transform(make_transform(args), *[np.asarray(v) for v in norm])
    torch.manual_seed(0)
    model = DCNN(time_dim=12, fused_layer1=fused, dtype=dtype, **flags).cuda()
    optimizer = make_optimizer(model.parameters(), 4e-4, 1e-3)
    gen = torch.Generator().manual_seed(5)
    batch = {"audio": (0.3 * torch.randn(BATCH, 1, SR, generator=gen)).cuda(),
             "label": torch.randint(0, 2, (BATCH,), generator=gen).cuda()}
    train_step = make_train_step(model, transform, optimizer)
    eval_step = make_eval_step(model, transform)
    return (lambda: train_step(batch)), (lambda: eval_step(batch))


def train_timing(fc, fused_cuda, norm, card_line: str):
    """Phase 8: kernel 2 alone vs plain, train step fused vs unfused, eval.

    The kernels are timed through their launchers (``fused_conv1_cuda.
    forward`` / ``backward``: allocation, launch and the ``torch.sum`` that
    finishes the reduction).  Through ``torch.autograd.grad`` the host takes
    longer to enqueue the ~0.2 ms backward than the card to run it, and the
    events would time the host."""
    x, params, cot = fused_case(fc, *TRAIN_SHAPE, torch.float32, seed=20)
    raw = [p.detach() for p in params]
    _, code, _, _ = fused_cuda.forward(x, *raw, True, True)
    plain_graph = fc.plain_conv1_prelu_pool_stats(x, *params)

    def forward():
        return fused_cuda.forward(x, *raw, True, True)

    def backward():
        return fused_cuda.backward(x, *raw, cot[0], code, cot[1], cot[2])

    fwd = median_ms({
        "plain": lambda: fc.plain_conv1_prelu_pool_stats(x, *params),
        "kernel": forward,
    }, reps=10)
    bwd = median_ms({
        "plain": lambda: torch.autograd.grad(plain_graph, params, cot, retain_graph=True),
        "kernel": backward,
    }, reps=10)
    with torch.no_grad():
        infer = median_ms({
            "plain": lambda: fc.plain_conv1_prelu_pool(x, *params),
            "kernel": lambda: fused_cuda.forward(x, *raw, False, False),
        }, reps=10)
    # the kernels' own device time, without the launchers' host work
    dev = kernel_device_ms(forward, {"fwd": "fused_conv1_fwd_kernel"})
    dev.update(kernel_device_ms(backward, {"bwd": "fused_conv1_bwd_kernel"}))
    b2b = kernel_device_ms(forward, {"fwd": "fused_conv1_fwd_kernel"}, back_to_back=True)
    b2b.update(kernel_device_ms(backward, {"bwd": "fused_conv1_bwd_kernel"}, back_to_back=True))
    del plain_graph, code
    fused_train, fused_eval = step_fns(norm, True)
    plain_train, _ = step_fns(norm, False)
    steps = median_ms({"unfused": plain_train, "fused": fused_train}, reps=3)
    evals = median_ms({"eval": fused_eval}, reps=3)
    out = {
        "fwd_kernel_ms": fwd["kernel"], "fwd_plain_ms": fwd["plain"],
        "bwd_kernel_ms": bwd["kernel"], "bwd_plain_ms": bwd["plain"],
        "fwd_device_ms": dev["fwd"], "bwd_device_ms": dev["bwd"],
        "fwd_device_back_to_back_ms": b2b["fwd"], "bwd_device_back_to_back_ms": b2b["bwd"],
        "infer_fwd_kernel_ms": infer["kernel"], "infer_fwd_plain_ms": infer["plain"],
        "train_step_fused_ms": steps["fused"], "train_step_unfused_ms": steps["unfused"],
        "train_fused_frames_per_s": BATCH / steps["fused"] * 1e3,
        "train_unfused_frames_per_s": BATCH / steps["unfused"] * 1e3,
        "eval_step_ms": evals["eval"], "eval_frames_per_s": BATCH / evals["eval"] * 1e3,
    }
    (fb, _), (bb, _) = fused_bounds(*TRAIN_SHAPE)
    log(f"  B={BATCH} [{card_line}]: fused block fwd (train) kernel {fwd['kernel']:.4f} ms, "
        f"{ms_or_not(dev['fwd'])} ms on the device ({ms_or_not(b2b['fwd'])} back to "
        f"back), plain {fwd['plain']:.4f} ms, bound {fb:.4f} ms; bwd kernel "
        f"{bwd['kernel']:.4f} ms, {ms_or_not(dev['bwd'])} ms on the device "
        f"({ms_or_not(b2b['bwd'])} back to back), plain "
        f"{bwd['plain']:.4f} ms, bound {bb:.4f} ms; fwd (no grad) kernel "
        f"{infer['kernel']:.4f} ms, plain {infer['plain']:.4f} ms")
    log(f"  train step fused {steps['fused']:.3f} ms ({out['train_fused_frames_per_s']:.1f} "
        f"frames/s), unfused {steps['unfused']:.3f} ms "
        f"({out['train_unfused_frames_per_s']:.1f} frames/s); eval step "
        f"{evals['eval']:.3f} ms ({out['eval_frames_per_s']:.1f} frames/s)")
    return out, fused_train


# kernel-name fragments (lower case) -> group, first match wins
KERNEL_GROUPS = (
    ("fused_conv2", ("fused_conv2",)),
    ("fused_pool", ("fused_pool",)),
    ("fused_conv_mfm", ("fused_conv_mfm",)),
    ("fused_conv1", ("fused_conv1",)),
    ("wpt_cascade", ("wpt_cascade",)),
    ("lstm_cell", ("lstm", "rnn")),
    ("convolution", ("fft", "gemm", "wgrad", "dgrad", "fprop", "pointwise_mult_and_sum",
                     "region_transform", "nhwctonchw", "nchwtonhwc", "cudnn::engines",
                     "implicit", "conv")),
    ("batch_norm", ("batch_norm", "bn_")),
    ("max_pool", ("max_pool",)),
    ("maximum", ("maximum",)),
    ("optimizer", ("multi_tensor",)),
    ("reduce", ("reduce_kernel",)),
    ("softmax_loss", ("softmax", "nll_loss")),
)


def call_device_ms(fn, keys: dict) -> float | None:
    """Device ms per call of ``fn`` in all of ``keys``' kernels together
    (None: not measured)."""
    dev = kernel_device_ms(fn, keys)
    return None if None in dev.values() else sum(dev.values())


def kernel_device_ms(fn, keys: dict, n: int = 5, back_to_back: bool = False) -> dict:
    """Device ms per call of ``fn`` of the kernels whose names hold each of
    ``keys``' values (each launched once a call), from ``torch.profiler``
    over ``n`` calls: the mean duration of their records, so a profile that
    lost some records still reads right (their sum over ``n`` calls would
    read low by the share lost, as ``wpt_device_ms`` found).  Logs the
    records each key got.

    ``back_to_back``: the calls queue behind a spin of the card
    (``torch.cuda._sleep``, ~10 ms) and so run with no host gap between
    them.  Without it a launcher whose host work outlasts its kernel leaves
    the card idle between calls, long enough for the L2 to write back the
    up to 50 MB of output a kernel leaves dirty when it ends; back to back,
    each kernel pays for the write-back of the one before, as in a stream of
    work."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    # a profile that lost every record of a key is taken again: CUPTI drops
    # records now and then (a fifth to two fifths of them in a profile, read
    # all through one run), and three profiles in a row lost every record of
    # kernel 2's bf16 forward once
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)  # the tracer's start on the host, before the first call
            if back_to_back:
                torch.cuda._sleep(20_000_000)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        counts = {k: sum(e.count for e in rows if v in e.key) for k, v in keys.items()}
        if all(counts.values()):
            break
    else:
        # CUPTI kept no record of some key in eight profiles (whole stretches
        # of a run can go without one): no kernel's device time is measured
        # then (None).  The whole call's time is logged, and read as no
        # kernel's: it holds the launcher's other work too
        ms = back_to_back_ms(fn, n)
        log(f"  profile records (of {n} calls): {counts}; eight profiles lost some key: "
            f"the kernels' device time is not measured (the whole call, back to back by "
            f"CUDA events: {ms:.4f} ms)")
        return {k: None for k in keys}
    out = {k: sum(e.self_device_time_total for e in rows if v in e.key) / 1e3 / counts[k]
           for k, v in keys.items()}
    log(f"  profile records (of {n} calls{', back to back' if back_to_back else ''}): "
        f"{counts}")
    return out


def profile_train(train_step, n: int = 5, kernel_groups=KERNEL_GROUPS):
    """Phases 9 and 13: device time by kernel over ``n`` fused train steps.
    (cuDNN's LSTM runs its matrix products through GEMM kernels that the
    names cannot tell from a convolution's: ``lstm_cell`` holds the cell
    kernels only, and phase 13 times the BLSTMs alone.)"""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        train_step()
    torch.cuda.synchronize()
    # a profile that kept no kernel record is taken again: CUPTI loses
    # records now and then (kernel_device_ms), once all of a 2 s AST step's
    for _ in range(8):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                train_step()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        # kernel rows only: an operator's row repeats its kernels' device
        # time, and a user range (``Optimizer.step#...``) spans kernels and
        # host gaps
        rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation and e.self_device_time_total > 0]
        if rows:
            break
    else:
        raise AssertionError("eight profiles of the step kept no kernel record")
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    log(f"  wall {wall_ms:.3f} ms/step (profiler on), device kernels {device_ms:.3f} ms/step "
        f"({100 * device_ms / wall_ms:.1f} % busy)")
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["other"] = 0.0
    for name, ms, _ in rows:
        low = name.lower()
        hit = next((g for g, keys in kernel_groups if any(k in low for k in keys)), "other")
        groups[hit] += ms
    log("  by group (ms/step): " + ", ".join(f"{g} {ms:.3f}" for g, ms in groups.items()))
    ours = [r for r in rows if any(k in r[0] for k in (
        "fused_conv", "fused_pool", "wpt_cascade", "flash_mha"))]
    for name, ms, count in ours + rows[:12]:
        log(f"    {ms:8.3f} ms  x{count:<3d} {name[:100]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "groups": groups,
            "top": [{"name": n_[:100], "ms": ms, "calls": c}
                    for n_, ms, c in ours + rows[:12]]}


# ------------------------------------------------ the LCNN path (10-13)


def mfm_bounds(b, h, w, c, itemsize=4, flop_per_s=FP32_FLOP_PER_S):
    """Training forward: x and the parameters read, out and code written;
    8 candidates x 25 FMAs per output.  Backward: g, code and x read, dW/db
    written; 25 FMAs and one add per output."""
    n_out = b * (h // 2) * (w // 2) * (c // 2)
    params = 4 * (25 * c + c)
    fwd = bound_ms(itemsize * b * h * w + params + n_out * (itemsize + 1), n_out * 400,
                   flop_per_s)
    bwd = bound_ms(itemsize * b * h * w + n_out * (itemsize + 1) + params, n_out * 51,
                   flop_per_s)
    return fwd, bwd


def mfm_case(b, h, w, c, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    make = lambda *shape, scale=1.0: (  # noqa: E731
        scale * torch.randn(*shape, generator=gen)).cuda().to(dtype)
    x = make(b, h, w)
    params = [make(25, c, scale=0.1).requires_grad_(), make(c, scale=0.1).requires_grad_()]
    # the cotangent in NCHW memory, as cuDNN hands it back behind the block
    return x, params, make(b, c // 2, h // 2, w // 2).permute(0, 2, 3, 1)


def mfm_tie_case():
    """Silence, duplicated rows and equal channel halves: ties across
    phases and halves in every window of frames 0 and 1."""
    gen = torch.Generator().manual_seed(40)
    x = torch.zeros(3, 12, 16)
    x[1] = torch.randn(6, 16, generator=gen).repeat_interleave(2, 0)
    x[2] = torch.randn(12, 16, generator=gen)
    w = 0.1 * torch.randn(25, 6, generator=gen)
    w[:, 3:] = w[:, :3]
    params = [w.cuda().requires_grad_(), torch.zeros(6).cuda().requires_grad_()]
    return x.cuda(), params, torch.randn(3, 6, 8, 3, generator=gen).cuda()


def mfm_code_check(fc, fcc, x, params, g):
    """Hold every selection of the kernel against the plain fp32 conv, and
    its gradients against a float64 rebuild from its own code."""
    import torch.nn.functional as F

    w, bias = [p.detach() for p in params]
    c, c_half = w.shape[1], w.shape[1] // 2
    b, h, win = x.shape
    h2, w2 = h // 2, win // 2
    out, code = fcc.mfm_forward(x, w, bias, True)
    dw, db = fcc.mfm_backward(x, g, code, c)
    conv = F.conv2d(x[:, None], w.t().reshape(c, 1, 5, 5), bias, padding=2)
    cands = torch.stack([  # [8, B, C/2, h2, w2], the kernel's candidate order
        conv[:, half * c_half:(half + 1) * c_half, a:2 * h2:2, q:2 * w2:2]
        for a in (0, 1) for q in (0, 1) for half in (0, 1)])
    del conv
    code_nchw = code.permute(0, 3, 1, 2).long()
    first = cands.argmax(dim=0)  # the first of several maxima
    differ = code_nchw != first
    v_kernel = cands.gather(0, code_nchw[None])[0][differ]
    v_plain = cands.gather(0, first[None])[0][differ]
    del cands, first
    n_differ = int(differ.sum())
    ulps = 0.0
    if n_differ:
        ulp = torch.maximum(v_plain.abs(), v_kernel.abs()).clamp(min=2.0 ** -126) * 2.0 ** -23
        ulps = ((v_plain - v_kernel).abs() / ulp).max().item()
    # float64 gradients from the kernel's own code: scatter g to the selected
    # candidate's conv position, then the convolution's weight gradient
    d_conv = torch.zeros(b, c, h, win, dtype=torch.float64, device=x.device)
    g_nchw = g.permute(0, 3, 1, 2).double()
    for idx in range(8):
        ph, half = idx >> 1, idx & 1
        d_conv[:, half * c_half:(half + 1) * c_half, (ph >> 1):2 * h2:2, (ph & 1):2 * w2:2] = (
            torch.where(code_nchw == idx, g_nchw, 0.0))
    want_dw = torch.nn.grad.conv2d_weight(
        x[:, None].double(), (c, 1, 5, 5), d_conv, padding=2).reshape(c, 25).t()
    want_db = d_conv.sum(dim=(0, 2, 3))
    torch.cuda.synchronize()
    return {"windows": differ.numel(), "selections_differ": n_differ,
            "worst_near_tie_ulps": ulps,
            "dW_from_code_rel_err": rel_err(dw, want_dw), "db_from_code_rel_err": rel_err(db, want_db)}


def mfm_vs_plain(fc, fcc):
    """Phase 10: kernel 3 against its plain version, and against itself."""
    out = {}
    cases = [(*LCNN_SHAPE, torch.float32), (*LCNN_SHAPE, torch.bfloat16),
             (128, 95, 256, 64, torch.float32), (8, 101, 20, 64, torch.float32),
             (3, 7, 5, 12, torch.float32), (2, 40, 700, 64, torch.float32), "ties"]
    for i, case in enumerate(cases):
        if case == "ties":
            x, params, g = mfm_tie_case()
            dtype, key = torch.float32, "ties-B3-H12-W16-C6-float32"
        else:
            b, h, w, c, dtype = case
            x, params, g = mfm_case(b, h, w, c, dtype, seed=30 + i)
            key = f"B{b}-H{h}-W{w}-C{c}-{str(dtype).split('.')[-1]}"
        runs = []
        for _ in range(2):
            y = fc.fused_conv_mfm_pool(x, *params)
            runs.append((y, *torch.autograd.grad(y, params, g)))
        torch.cuda.synchronize()
        py = fc.plain_conv_mfm_pool(x, *params)
        pgrads = torch.autograd.grad(py, params, g)
        torch.cuda.synchronize()
        y, *grads = runs[0]
        bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
        fp32 = dtype == torch.float32
        fwd_err = (y.float() - py.float()).abs().max().item()
        fwd_tol = MFM_FWD_ATOL if fp32 else py.float().abs().max().item() * 2.0 ** -7
        gerr = {n: rel_err(gr, pg) for n, gr, pg in zip(("dW", "db"), grads, pgrads)}
        out[key] = {
            "fwd_max_abs_err": fwd_err, "grad_rel_err": gerr,
            "dW_max_abs_err": (grads[0].float() - pgrads[0].float()).abs().max().item(),
            "dW_max_abs": pgrads[0].float().abs().max().item(), "bitwise_repeat": bitwise,
        }
        log(f"  {key}: out max|err| {fwd_err:.3e} (tol {fwd_tol:.1e}), grads rel {gerr}, "
            f"repeat bit-equal {bitwise}")
        # ties are exact on both sides (equal sums of equal terms): no flips
        grad_tol = 1e-5 if case == "ties" else MFM_SUM_RTOL if fp32 else FUSED_BF16_RTOL
        if not (fwd_err <= fwd_tol and max(gerr.values()) <= grad_tol):
            raise AssertionError(f"fused conv mfm vs plain at {key}: {out[key]}")
        if not bitwise:
            raise AssertionError(f"fused conv mfm at {key}: two runs differ")
        if case == "ties" and not torch.all(grads[1][3:] == 0):
            raise AssertionError("a tie's gradient reached the upper channel half")
        if fp32 and case != "ties" and (b, h, w, c) in (LCNN_SHAPE, (8, 101, 20, 64)):
            chk = mfm_code_check(fc, fcc, x, params, g)
            out[key]["code_check"] = chk
            log(f"    code: {chk['selections_differ']} of {chk['windows']} selections differ "
                f"from the plain conv's first maximum (worst {chk['worst_near_tie_ulps']:.2f} "
                f"ulp apart); dW / db from the code, float64: rel "
                f"{chk['dW_from_code_rel_err']:.2e} / {chk['db_from_code_rel_err']:.2e}")
            if not (chk["worst_near_tie_ulps"] <= MFM_TIE_ULPS
                    and chk["dW_from_code_rel_err"] <= MFM_CODE_RTOL
                    and chk["db_from_code_rel_err"] <= MFM_CODE_RTOL):
                raise AssertionError(f"fused conv mfm code check at {key}: {chk}")
    return out


def lcnn_args(root: str, data: str, log_dir: str, **extra):
    """stft (n_fft 511, hop 220, log power) + LCNN with the fused block."""
    args = train_args(root, data, log_dir)
    args.update(transform="stft", hop_length=220, model="lcnn", module=None,
                learning_rate=1e-4, weight_decay=0.01)
    args.update(extra)
    return args


def train_lcnn(wpt_cuda, fused_cuda, root: str, data: str):
    """Phase 11: the LCNN path through ``run_experiment`` on the card."""
    import shutil

    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
    from audiodeepfake_detection_tpu_torch.train.experiment import run_experiment

    def reset():
        wpt_cuda.LAUNCHES = fused_cuda.FWD_LAUNCHES = fused_cuda.BWD_LAUNCHES = 0
        fused_cuda.MFM_FWD_LAUNCHES = fused_cuda.MFM_BWD_LAUNCHES = 0

    def read():
        torch.cuda.synchronize()
        return {"wpt": wpt_cuda.LAUNCHES, "mfm_fwd": fused_cuda.MFM_FWD_LAUNCHES,
                "mfm_bwd": fused_cuda.MFM_BWD_LAUNCHES,
                "conv1": fused_cuda.FWD_LAUNCHES + fused_cuda.BWD_LAUNCHES}

    # the main path: the reference's dropout 0.7, both augmentations on
    reset()
    t0 = time.perf_counter()
    trainer = run_experiment(
        lcnn_args(root, data, "log_lcnn", aug_contrast=True, aug_noise=True))
    counts = read()
    wall = time.perf_counter() - t0
    steps = EPOCHS * STEPS_PER_EPOCH
    losses = [row[2] for row in trainer.loss_list]
    log(f"  main run: input {trainer.args.input_dim}, {steps} steps, losses "
        f"{['%.4f' % v for v in losses]}, test {trainer.test_results}, launches {counts}, "
        f"{wall:.1f} s wall")
    if trainer.args.input_dim != [BATCH, 1, 256, 101]:
        raise AssertionError(f"LCNN input {trainer.args.input_dim}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"LCNN main run losses: {losses}")
    if not (counts["mfm_fwd"] == counts["mfm_bwd"] == steps and counts["wpt"] == 0
            and counts["conv1"] == 0):
        raise AssertionError(f"launch counts {counts} for {steps} LCNN train steps")
    if (trainer.model.get_name() != "LCNN" or trainer.model.fused_layer1 is not True
            or trainer.device.type != "cuda"):
        raise AssertionError("the LCNN main run left the fused path or the card")
    acc, eer = trainer.test_results[:2]
    if not (0.0 <= acc <= 1.0 and 0.0 <= eer <= 1.0):  # NaN fails too
        raise AssertionError(f"LCNN test results {trainer.test_results}")

    # fused vs unfused from the same seed; the reference hard-codes the
    # LCNN's dropout, so a dropout-free one comes in as a "modules" callable
    pair = {}
    for name, flag in (("fused", True), ("unfused", False)):
        run = run_experiment(lcnn_args(
            root, data, f"log_lcnn_{name}", model="modules",
            module=lambda _args, flag=flag: LCNN(fused_layer1=flag, dropout=0.0)))
        pair[name] = [row[2] for row in run.loss_list]
    worst = max(abs(a - b) / abs(b) for a, b in zip(pair["fused"], pair["unfused"]))
    log(f"  fused   losses {['%.6f' % v for v in pair['fused']]}")
    log(f"  unfused losses {['%.6f' % v for v in pair['unfused']]} (worst rel diff {worst:.2e})")
    if not worst <= LOSS_RTOL:
        raise AssertionError(f"LCNN fused vs unfused losses differ by {worst} > {LOSS_RTOL}")

    # the other two front-ends, one epoch each: packets-sym5 (kernels 1 and
    # 3 in one step, x [B, 95, 256]) and stft + LFCC (x [B, 101, 20])
    others = {}
    for name, extra, dim in (
        ("packets", dict(transform="packets"), [BATCH, 1, 256, 95]),
        ("lfcc", dict(features="lfcc"), [BATCH, 1, 20, 101]),
    ):
        reset()
        run = run_experiment(lcnn_args(root, data, f"log_lcnn_{name}", epochs=1, **extra))
        got = read()
        run_losses = [row[2] for row in run.loss_list]
        log(f"  {name} + LCNN: input {run.args.input_dim}, losses "
            f"{['%.4f' % v for v in run_losses]}, launches {got}")
        n = STEPS_PER_EPOCH
        if not (run.args.input_dim == dim and len(run_losses) == n
                and np.isfinite(run_losses).all()
                and got["mfm_fwd"] == got["mfm_bwd"] == n
                and (got["wpt"] >= n if name == "packets" else got["wpt"] == 0)):
            raise AssertionError(f"{name} + LCNN: {run.args.input_dim} {run_losses} {got}")
        others[name] = {"losses": run_losses, "launches": got}

    # run_experiment names every non-"modules" model customModel; to serve
    # the trained LCNN its snapshot takes a name whose model token is LCNN
    served = trainer.snapshot_path.replace("_customModel_", "_LCNN_")
    if served == trainer.snapshot_path:
        raise AssertionError(f"unexpected snapshot name {trainer.snapshot_path}")
    for suffix in ("", ".norm.pkl"):
        shutil.copy(trainer.snapshot_path + suffix, served + suffix)
    return {"launches": counts, "steps": steps, "losses": losses,
            "fused_losses": pair["fused"], "unfused_losses": pair["unfused"],
            "loss_rel_diff": worst, "others": others, "wall_s": wall, "snapshot": served,
            "norm": [np.asarray(v).tolist() for v in trainer.norm_stats]}


def lcnn_step_fns(norm, fused: bool, dtype=None):
    """An LCNN train step and eval step at full width on a fixed batch;
    ``dtype``: its compute type (``None``: float32)."""
    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
    from audiodeepfake_detection_tpu_torch.train.steps import (
        make_eval_step, make_optimizer, make_train_step)
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    args = lcnn_args("", "", "")
    transform = normalized_transform(make_transform(args), *[np.asarray(v) for v in norm])
    torch.manual_seed(0)
    model = LCNN(fused_layer1=fused, dtype=dtype).cuda()
    optimizer = make_optimizer(model.parameters(), args.learning_rate, args.weight_decay)
    gen = torch.Generator().manual_seed(5)
    batch = {"audio": (0.3 * torch.randn(BATCH, 1, SR, generator=gen)).cuda(),
             "label": torch.randint(0, 2, (BATCH,), generator=gen).cuda()}
    train_step = make_train_step(model, transform, optimizer)
    eval_step = make_eval_step(model, transform)
    return (lambda: train_step(batch)), (lambda: eval_step(batch))


def copy_profile(step, numel: int, n: int = 3) -> dict:
    """Phases 9 and 13: the copies of ``n`` train steps, from
    ``torch.profiler``.
    A copy of ``numel`` elements into new memory (``contiguous``, ``clone``,
    ``to``) is a transposing copy of the block's output or of its cotangent;
    a deliberate one is counted first, so a profiler that records no shapes
    fails here instead of reading 0.  Also the device time of every copy
    kernel (``direct_copy``) a step."""
    from torch.profiler import ProfilerActivity, profile

    def run(fn, reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        layout = [e for e in prof.events()
                  if e.name == "aten::copy_" and e.input_shapes and e.input_shapes[0]
                  and int(np.prod(e.input_shapes[0])) == numel and e.cpu_parent is not None
                  and e.cpu_parent.name in ("aten::clone", "aten::_to_copy")]
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "direct_copy" in e.key]
        return layout, kernels

    probe = torch.empty(numel, device="cuda")
    if len(run(lambda: probe.reshape(-1, 32).t().contiguous(), 1)[0]) != 1:
        raise AssertionError("the profiler did not show a deliberate copy of the block's size")
    step()
    torch.cuda.synchronize()
    layout, kernels = run(step, n)
    out = {
        "transposing_copies_per_step": len(layout) / n,
        "transposing_copy_ms_per_step": sum(e.device_time_total for e in layout) / 1e3 / n,
        "copy_kernels_per_step": sum(e.count for e in kernels) / n,
        "copy_kernels_ms_per_step": sum(e.self_device_time_total for e in kernels) / 1e3 / n,
    }
    log(f"  copies a fused step: {out['transposing_copies_per_step']:.0f} of the block's "
        f"{numel} elements into another layout ({out['transposing_copy_ms_per_step']:.4f} ms); "
        f"all copy kernels x{out['copy_kernels_per_step']:.0f}, "
        f"{out['copy_kernels_ms_per_step']:.4f} ms")
    if layout:
        raise AssertionError(f"the fused step copies its first block's output: {out}")
    return out


def lcnn_timing(fc, fused_cuda, norm, card_line: str):
    """Phase 13: kernel 3 alone vs plain (through its launchers, as phase 8
    times kernel 2), the LCNN train step unfused and fused, its copies, the
    eval step, and the two BLSTMs alone."""
    from audiodeepfake_detection_tpu_torch.models.layers import BLSTMLayer

    x, params, g = mfm_case(*LCNN_SHAPE, torch.float32, seed=50)
    raw = [p.detach() for p in params]
    _, code = fused_cuda.mfm_forward(x, *raw, True)
    plain_graph = fc.plain_conv_mfm_pool(x, *params)
    fwd = median_ms({
        "plain": lambda: fc.plain_conv_mfm_pool(x, *params),
        "kernel": lambda: fused_cuda.mfm_forward(x, *raw, True),
    }, reps=10)
    bwd = median_ms({
        "plain": lambda: torch.autograd.grad(plain_graph, params, g, retain_graph=True),
        "kernel": lambda: fused_cuda.mfm_backward(x, g, code, LCNN_SHAPE[3]),
    }, reps=10)
    with torch.no_grad():
        infer = median_ms({
            "plain": lambda: fc.plain_conv_mfm_pool(x, *params),
            "kernel": lambda: fused_cuda.mfm_forward(x, *raw, False),
        }, reps=10)
    del plain_graph, code
    fused_train, fused_eval = lcnn_step_fns(norm, True)
    plain_train, _ = lcnn_step_fns(norm, False)
    steps = median_ms({"unfused": plain_train, "fused": fused_train}, reps=3)
    evals = median_ms({"eval": fused_eval}, reps=3)
    b, h, w, c = LCNN_SHAPE
    copies = copy_profile(fused_train, b * (c // 2) * (h // 2) * (w // 2))

    # the two BLSTMs alone, forward and backward, at the step's shape
    torch.manual_seed(1)
    lstm = torch.nn.Sequential(BLSTMLayer(512, 512), BLSTMLayer(512, 512)).cuda()
    seq = torch.randn(BATCH, 6, 512, device="cuda", requires_grad=True)

    def lstm_fwd_bwd():
        lstm(seq).sum().backward()

    blstm = median_ms({"blstm": lstm_fwd_bwd}, reps=5)
    out = {
        "fwd_kernel_ms": fwd["kernel"], "fwd_plain_ms": fwd["plain"],
        "bwd_kernel_ms": bwd["kernel"], "bwd_plain_ms": bwd["plain"],
        "infer_fwd_kernel_ms": infer["kernel"], "infer_fwd_plain_ms": infer["plain"],
        "train_step_fused_ms": steps["fused"], "train_step_unfused_ms": steps["unfused"],
        **copies,
        "train_fused_frames_per_s": BATCH / steps["fused"] * 1e3,
        "train_unfused_frames_per_s": BATCH / steps["unfused"] * 1e3,
        "eval_step_ms": evals["eval"], "eval_frames_per_s": BATCH / evals["eval"] * 1e3,
        "blstm_fwd_bwd_ms": blstm["blstm"],
    }
    log(f"  B={BATCH} [{card_line}]: LCNN block fwd (train) kernel {fwd['kernel']:.4f} ms, "
        f"plain {fwd['plain']:.4f} ms; bwd kernel {bwd['kernel']:.4f} ms, plain "
        f"{bwd['plain']:.4f} ms; fwd (no grad) kernel {infer['kernel']:.4f} ms, plain "
        f"{infer['plain']:.4f} ms")
    log(f"  LCNN train step fused {steps['fused']:.3f} ms "
        f"({out['train_fused_frames_per_s']:.1f} frames/s), unfused {steps['unfused']:.3f} ms "
        f"({out['train_unfused_frames_per_s']:.1f} frames/s); eval step "
        f"{evals['eval']:.3f} ms ({out['eval_frames_per_s']:.1f} frames/s); the two BLSTMs "
        f"alone, fwd + bwd, {blstm['blstm']:.3f} ms")
    return out, fused_train


# ------------------------------------------- the fused mid blocks (14-16)


def pool_bounds(b, c, h, w, n_negative, itemsize=4, flop_per_s=FP32_FLOP_PER_S):
    """Training forward: x read, out, code and the per-plane moments written;
    4 compare-selects per output.  Backward: g, code and out read, dx
    written, and x read at the selected negative elements (counted from this
    run's code); 2 operations per element of dx."""
    n_out = b * c * (h // 2) * (w // 2)
    n_in = b * c * h * w
    fwd = bound_ms(itemsize * n_in + n_out * (itemsize + 1) + 8 * b * c, 8 * n_out, flop_per_s)
    bwd = bound_ms(n_out * (2 * itemsize + 1) + itemsize * (n_in + n_negative), 2 * n_in,
                   flop_per_s)
    return fwd, bwd


def conv2_bounds(b, c_in, c_out, h, w, itemsize=4, flop_per_s=FP32_FLOP_PER_S):
    """Training forward: x, the weights and corr read, out, code and moments
    written; a max over four conv values needs all of them: 2 * 9 * Cin flops
    for each of the 4 * n_out conv values.  Backward: x, g, out, code and the
    weights read, dx, dw and dcorr written; the conv-output cotangent is zero
    at three of a window's four positions, so dx and dw need 2 * 9 * Cin
    flops per pooled element each.  Third: the backward's dense route, the
    ms of the two dense products the kernels run (each 2 * B*H*W * 9 * Cin *
    Cout flops) as split TF32, three tensor-core products each, at 495
    TFLOP/s: beside the bound, not in its place."""
    n_out = b * c_out * (h // 2) * (w // 2)
    n_x = b * c_in * h * w
    small = 4 * (9 * c_in * c_out + c_out * h * w)
    fwd = bound_ms(itemsize * n_x + small + n_out * (itemsize + 1), 4 * n_out * 18 * c_in,
                   flop_per_s)
    bwd = bound_ms(2 * itemsize * n_x + n_out * (2 * itemsize + 1) + 2 * small,
                   2 * n_out * 18 * c_in, flop_per_s)
    dense_3xtf32_ms = 3 * 2 * (2 * b * h * w * 9 * c_in * c_out) / TF32_FLOP_PER_S * 1e3
    return fwd, bwd, dense_3xtf32_ms


def _maker(seed):
    gen = torch.Generator().manual_seed(seed)
    return lambda *shape, scale=1.0, dtype=torch.float32: (
        scale * torch.randn(*shape, generator=gen)).cuda().to(dtype)


def pool_case(b, c, h, w, dtype, alpha, seed):
    make = _maker(seed)
    args = [make(b, c, h, w, dtype=dtype), torch.tensor([alpha]).cuda().to(dtype)]
    cot = [make(b, c, h // 2, w // 2, dtype=dtype), make(c, scale=0.01), make(c, scale=0.001)]
    return [a.requires_grad_() for a in args], cot


def conv2_case(b, c_in, c_out, h, w, dtype, alpha, seed):
    make = _maker(seed)
    args = [make(b, c_in, h, w, dtype=dtype), make(9 * c_in, c_out, scale=0.05, dtype=dtype),
            make(c_out, h, w, scale=0.1), torch.tensor([alpha]).cuda().to(dtype)]
    cot = [make(b, c_out, h // 2, w // 2, dtype=dtype), make(c_out, scale=0.01),
           make(c_out, scale=0.001)]
    return [a.requires_grad_() for a in args], cot


def tie_cases(slope, dtype=torch.float32):
    """Windows whose four values are equal: a constant negative plane for
    the pool, and for the conv a channel with zero weights under a constant
    negative ``corr`` (at a zero slope every such window also ties at 0)."""
    (x, alpha), pool_cot = pool_case(3, 4, 8, 10, dtype, slope, seed=70)
    with torch.no_grad():
        x[0] = -1.5
        x[1] = x[1, :, ::2, ::2].repeat_interleave(2, 1).repeat_interleave(2, 2)
    conv_args, conv_cot = conv2_case(3, 3, 4, 8, 10, dtype, slope, seed=71)
    with torch.no_grad():
        conv_args[1][:, 0] = 0.0
        conv_args[2][0] = -0.75
    return ([x, alpha], pool_cot), (conv_args, conv_cot)


def mid_vs_plain(fp, f2):
    """Phase 14: kernels 5 and 6 against their plain versions, and against
    themselves.  Every case runs the ``_stats`` variant with cotangents on
    all three outputs, so the moments' share of the gradients is held too."""
    pool2, pool3 = ("B{}-C{}-H{}-W{}".format(*s) for s in (POOL2_SHAPE, POOL3_SHAPE))
    conv2 = "B{}-Cin{}-Cout{}-H{}-W{}".format(*CONV2_SHAPE)
    f32, bf16 = torch.float32, torch.bfloat16
    blocks = (
        ("pool", fp.fused_prelu_pool_stats, fp.plain_prelu_pool_stats, ("dx", "dalpha"), [
            (lambda: pool_case(*POOL2_SHAPE, f32, 0.25, 60), pool2),
            (lambda: pool_case(*POOL2_SHAPE, bf16, 0.25, 61), pool2),
            (lambda: pool_case(*POOL3_SHAPE, f32, 0.25, 62), pool3),
            (lambda: pool_case(3, 5, 7, 9, f32, -0.5, 63), "odd-B3-C5-H7-W9-negative-slope"),
            (lambda: pool_case(3, 4, 51, 8, bf16, -0.5, 64), "odd-B3-C4-H51-W8-negative-slope"),
            (lambda: pool_case(2, 3, 6, 701, f32, 0.0, 65), "odd-B2-C3-H6-W701-zero-slope"),
            (lambda: tie_cases(0.0)[0], "ties-zero-slope-B3-C4-H8-W10"),
            (lambda: tie_cases(0.25)[0], "ties-B3-C4-H8-W10"),
        ]),
        ("conv2", f2.fused_conv2_prelu_pool_stats, f2.plain_conv2_prelu_pool_stats,
         ("dx", "dw", "dcorr", "dalpha"), [
            (lambda: conv2_case(*CONV2_SHAPE, f32, 0.25, 80), conv2),
            (lambda: conv2_case(*CONV2_SHAPE, bf16, 0.25, 81), conv2),
            (lambda: conv2_case(2, 3, 5, 7, 9, f32, -0.3, 82),
             "odd-B2-Cin3-Cout5-H7-W9-negative-slope"),
            (lambda: conv2_case(2, 8, 12, 25, 33, bf16, -0.3, 83),
             "odd-B2-Cin8-Cout12-H25-W33-negative-slope"),
            (lambda: conv2_case(2, 40, 160, 51, 70, f32, 0.0, 84),
             "odd-B2-Cin40-Cout160-H51-W70-zero-slope"),
            (lambda: tie_cases(0.0)[1], "ties-zero-slope-B3-Cin3-Cout4-H8-W10"),
            (lambda: tie_cases(0.25)[1], "ties-B3-Cin3-Cout4-H8-W10"),
            (lambda: tie_cases(0.0, bf16)[1], "ties-zero-slope-B3-Cin3-Cout4-H8-W10"),
            (lambda: tie_cases(0.25, bf16)[1], "ties-B3-Cin3-Cout4-H8-W10"),
        ]),
    )
    out = {}
    for block, fused_fn, plain_fn, names, cases in blocks:
        for make_case, label in cases:
            args, cot = make_case()
            dtype = args[0].dtype
            key = f"{block}-{label}-{str(dtype).split('.')[-1]}"
            runs = []
            for _ in range(2):
                y, s, q = fused_fn(*args)
                runs.append((y, s, q, *torch.autograd.grad([y, s, q], args, cot)))
            torch.cuda.synchronize()
            py, ps, pq = plain_fn(*args)
            pgrads = torch.autograd.grad([py, ps, pq], args, cot)
            torch.cuda.synchronize()
            y, s, q, *grads = runs[0]
            bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
            fp32 = dtype == f32
            codes = None
            if block == "conv2" and not fp32:  # check (a), and check (c)'s near-tie rule
                codes, pgrads = conv2_near_tie_rule(f2, args, cot, pgrads)
            fwd_err = (y.float() - py.float()).abs().max().item()
            fwd_tol = py.float().abs().max().item() * 2.0 ** -7 if not fp32 else (
                POOL_ATOL if block == "pool" else CONV2_FWD_ATOL)
            sums = {"sum": rel_err(s, ps), "sumsq": rel_err(q, pq)}
            gerr = {n: rel_err(g, pg) for n, g, pg in zip(names, grads, pgrads)}
            out[key] = {
                "fwd_max_abs_err": fwd_err, "moments_rel_err": sums, "grad_rel_err": gerr,
                "dx_max_abs_err": (grads[0].float() - pgrads[0].float()).abs().max().item(),
                "dalpha": grads[-1].item(), "bitwise_repeat": bitwise,
            }
            if block == "conv2":
                out[key]["dw_max_abs_err"] = (
                    grads[1].float() - pgrads[1].float()).abs().max().item()
            if codes is not None:
                out[key]["codes"] = codes
            log(f"  {key}: out max|err| {fwd_err:.3e} (tol {fwd_tol:.1e}), moments rel "
                f"{max(sums.values()):.2e}, grads rel {gerr}, repeat bit-equal {bitwise}"
                + ("" if codes is None else f"; codes {codes}"))
            # float32 corr keeps a float32 dcorr under bf16 inputs as well
            tols = {n: MID_SUM_RTOL if fp32 or n == "dcorr" else FUSED_BF16_RTOL for n in names}
            if block == "conv2" and not fp32:
                tols["dalpha"] = MID_BF16_DALPHA_RTOL
            if not (fwd_err <= fwd_tol and max(sums.values()) <= MID_SUM_RTOL
                    and all(gerr[n] <= tols[n] for n in names)):
                raise AssertionError(f"fused {block} vs plain at {key}: {out[key]}")
            if not bitwise:
                raise AssertionError(f"fused {block} at {key}: two runs differ")
            if "zero-slope" in key and not abs(grads[-1].item()) > 0:
                raise AssertionError(f"fused {block} at {key}: dalpha is 0 at a zero slope")
            if "ties" in key:
                # all of a tied window's gradient sits at position (0, 0) (a
                # zero slope passes none on)
                tied = grads[0][0] if block == "pool" else grads[2][0]
                if (tied[..., 1::2, :].any() or tied[..., 1::2].any()
                        or tied[..., ::2, ::2].all() == ("zero-slope" in key)):
                    raise AssertionError(f"fused {block} at {key}: a tie left position (0, 0)")
            del runs, grads, pgrads, y, py, args, cot
    out.update(pool_dx_bitwise(fp))
    # kernel 6's forward keeps cuDNN's summation order: bit-equal to plain
    fwd_err = out[f"conv2-{conv2}-float32"]["fwd_max_abs_err"]
    log(f"  kernel 6 forward at {conv2}, float32, against plain: max|err| {fwd_err!r}")
    if fwd_err != 0.0:
        raise AssertionError(f"kernel 6 forward left the plain summation order: {fwd_err}")
    return out


def pool_dx_bitwise(fp) -> dict:
    """Phase 14: kernel 5 without moments (``fused_prelu_pool``, as the
    DCNN's last pool runs it) at both pool shapes, a zero slope and ties.
    A window's cotangent is then g itself on both sides, times alpha at a
    negative selection, so ``dx`` must equal plain's bit for bit; ``dalpha``
    within the tolerances above; two runs bit-equal.  (With moments the
    kernel forms g + gs + 2 out gq in its own order and autograd sums the
    three in another: those cases above hold ``dx`` to ``MID_SUM_RTOL``.)"""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        (lambda: pool_case(*POOL2_SHAPE, f32, 0.25, 66), "B{}-C{}-H{}-W{}".format(*POOL2_SHAPE)),
        (lambda: pool_case(*POOL3_SHAPE, f32, 0.25, 67), "B{}-C{}-H{}-W{}".format(*POOL3_SHAPE)),
        (lambda: pool_case(*POOL2_SHAPE, bf16, -0.5, 68), "B{}-C{}-H{}-W{}".format(*POOL2_SHAPE)),
        (lambda: pool_case(2, 3, 7, 701, f32, 0.0, 69), "odd-B2-C3-H7-W701-zero-slope"),
        (lambda: tie_cases(0.0)[0], "ties-zero-slope-B3-C4-H8-W10"),
    ]
    out = {}
    for make_case, label in cases:
        (x, alpha), cot = make_case()
        key = f"pool-no-moments-{label}-{str(x.dtype).split('.')[-1]}"
        runs = [torch.autograd.grad(fp.fused_prelu_pool(x, alpha), (x, alpha), cot[0])
                for _ in range(2)]
        want = torch.autograd.grad(fp.plain_prelu_pool(x, alpha), (x, alpha), cot[0])
        torch.cuda.synchronize()
        bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
        dx_equal = torch.equal(runs[0][0], want[0])
        da_rel = rel_err(runs[0][1], want[1])
        out[key] = {"dx_bit_equal_to_plain": dx_equal, "dalpha_rel_err": da_rel,
                    "dalpha": runs[0][1].item(), "bitwise_repeat": bitwise}
        log(f"  {key}: dx bit-equal to plain {dx_equal}, dalpha rel {da_rel:.2e}, repeat "
            f"bit-equal {bitwise}")
        tol = MID_SUM_RTOL if x.dtype == f32 else FUSED_BF16_RTOL
        if not (dx_equal and bitwise and da_rel <= tol):
            raise AssertionError(f"kernel 5 backward at {key}: {out[key]}")
        if "zero-slope" in key and not abs(runs[0][1].item()) > 0:
            raise AssertionError(f"kernel 5 at {key}: dalpha is 0 at a zero slope")
        del runs, want, x, alpha, cot
    return out


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does, via the int32 view."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def conv2_dense_grads(x, w, d):
    """float64 ``dx`` and ``dw`` of the conv 3x3 from its output's
    cotangent ``d [B, Cout, H, W]``, tap by tap: the two products that
    kernel 6's dx and dw kernels run."""
    import torch.nn.functional as F

    b, c_in, h, win = x.shape
    c_out = w.shape[1]
    w9 = w.double().view(9, c_in, c_out)
    d = d.double()
    xp, dp = F.pad(x.double(), (1, 1, 1, 1)), F.pad(d, (1, 1, 1, 1))
    dx = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    dw = torch.empty((9, c_in, c_out), dtype=torch.float64, device=x.device)
    for tap in range(9):
        dh, dc = divmod(tap, 3)
        dx += torch.einsum("bkhw,ik->bihw", dp[:, :, 2 - dh:2 - dh + h, 2 - dc:2 - dc + win],
                           w9[tap])
        dw[tap] = torch.einsum("bihw,bkhw->ik", xp[:, :, dh:dh + h, dc:dc + win], d)
    return dx, dw.view(9 * c_in, c_out)


def conv2_cotangent(y, code, g, gs, gq, alpha, h, win):
    """float64 cotangent of the conv output ``[B, Cout, H, W]`` from the
    pooled output's (``g``) and the moments' (``gs``, ``gq``), scattered to
    the positions ``code`` selects, as kernel 6's backward rebuilds it."""
    b, c_out, h2, w2 = y.shape
    gt = g.double() + gs.double()[:, None, None] + 2 * y.double() * gq.double()[:, None, None]
    pooled = torch.where(code >= 4, alpha.double() * gt, gt)
    d = torch.zeros((b, c_out, h, win), dtype=torch.float64, device=y.device)
    for ph in range(4):
        d[:, :, ph >> 1:2 * h2:2, ph & 1:2 * w2:2] = torch.where((code & 3) == ph, pooled, 0.0)
    return d


def conv2_code_check(conv2_cuda, x, w, corr, alpha):
    """Check (a): every selection code of kernel 6's bf16 forward on these
    arguments against the first maximum of the plain version's fp32
    convolution of the same bf16 values (TF32 off); a code may differ only
    at a near-tie (``CONV2_TIE_UNITS``), and where the codes agree a stored
    bf16 value may differ from the plain version's only at a rounding
    near-tie (the same bound, plus half a bf16 ulp).  Returns the counts,
    the worst gaps (a selection's in fp32 ulps of the larger value; each as
    a share of its bound), and the kernel's ``(out, code)``."""
    import torch.nn.functional as F

    x, w, corr, alpha = (t.detach() for t in (x, w, corr, alpha))
    wq, aq = w.to(x.dtype).float().contiguous(), alpha.to(x.dtype).float().contiguous()
    c32 = corr.float().contiguous()
    y, code, _, _ = conv2_cuda.forward(x, wq, c32, aq, True, False)
    b, c_in, h, win = x.shape
    c_out = w.shape[1]
    weight = wq.view(3, 3, c_in, c_out).permute(3, 2, 0, 1)
    phases = [(p >> 1, p & 1) for p in range(4)]

    def by_phase(t):  # [4, B, Cout, H // 2, W // 2]
        return torch.stack([t[:, :, r:2 * (h // 2):2, c:2 * (win // 2):2] for r, c in phases])

    pre = by_phase(F.conv2d(x.float(), weight, padding=1) + c32)
    mag = by_phase(F.conv2d(x.float().abs(), weight.abs(), padding=1) + c32.abs())
    act = torch.where(pre >= 0, pre, aq * pre)
    first = act.argmax(dim=0)  # the first of several maxima
    plain_code = first | (pre.gather(0, first[None])[0] < 0).long() << 2
    kph = (code & 3).long()
    differ = code.long() != plain_code
    n_differ = int(differ.sum())
    worst_ulps = worst_share = 0.0
    if n_differ:
        def at(t, idx):
            return t.gather(0, idx[None])[0][differ]

        a_p, a_k, pre_k = at(act, first), at(act, kph), at(pre, kph)
        s_p, s_k = at(mag, first), at(mag, kph)
        sign_only = (first == kph)[differ]
        gap = torch.where(sign_only, pre_k.abs(), a_p - a_k)
        bound = CONV2_TIE_UNITS * torch.where(
            sign_only, s_k, max(1.0, abs(aq.item())) * (s_k + s_p))
        ulp = torch.maximum(a_p.abs(), a_k.abs()).clamp(min=2.0 ** -126) * 2.0 ** -23
        worst_ulps = (gap / ulp).max().item()
        worst_share = (gap / bound).max().item()
    # the stored values where the selections agree: the kernel's within half
    # its ulp plus the bound of the plain side's fp32 value
    v_p = act.gather(0, first[None])[0]
    rounding = ~differ & (y != v_p.to(y.dtype))
    n_rounding = int(rounding.sum())
    worst_rounding = 0.0
    if n_rounding:
        k = y[rounding].float()
        half_ulp = torch.where(k == 0, 0.0,
                               torch.ldexp(torch.ones_like(k), torch.frexp(k)[1] - 9))
        bound = CONV2_TIE_UNITS * max(1.0, abs(aq.item())) * mag.gather(0, first[None])[0]
        gap = ((k - v_p[rounding]).abs() - half_ulp).clamp(min=0.0)
        worst_rounding = (gap / bound[rounding]).max().item()
    result = {"windows": differ.numel(), "codes_differ": n_differ,
              "worst_gap_ulps": worst_ulps, "worst_gap_of_bound": worst_share,
              "stored_differ": n_rounding, "worst_rounding_gap_of_bound": worst_rounding}
    if not (worst_share <= 1.0 and worst_rounding <= 1.0):
        raise AssertionError(f"kernel 6 bf16 codes or stored values beyond a near-tie: {result}")
    return result, y, code


def conv2_near_tie_rule(f2, args, cot, pgrads):
    """Checks (a) and (c) on a bf16 case: the kernel's codes and stored
    values against plain (``conv2_code_check``); where some differ
    (near-ties of a selection or of a rounding), the plain side's gradients
    are taken at the kernel's selection and stored values
    (``plain_conv2_grads_from_code``: the moments' share of the cotangent,
    2 out gq, reads the stored output), else ``pgrads`` stand.  Returns
    ``(the code check with "near_tie_rule", the plain gradients)``."""
    from audiodeepfake_detection_tpu_torch.ops import fused_conv2_cuda

    codes, y, code = conv2_code_check(fused_conv2_cuda, *args)
    codes["near_tie_rule"] = codes["codes_differ"] + codes["stored_differ"] > 0
    if codes["near_tie_rule"]:
        g, gs, gq = cot
        pgrads = f2.plain_conv2_grads_from_code(*(a.detach() for a in args), code, y, g, gs, gq)
        torch.cuda.synchronize()
    return codes, pgrads


def conv2_split_tf32_check(conv2_cuda):
    """Phase 14: kernel 6's fp32 ``dx`` and ``dw`` at ``CONV2_SHAPE``
    against a float64 rebuild from its own code, and the same rebuild from
    operands rounded to TF32 (one tensor-core pass, summed exactly) and
    cuDNN's fp32 gradients beside it; all of the largest entry."""
    (x, w, corr, alpha), (g, gs, gq) = conv2_case(*CONV2_SHAPE, torch.float32, 0.25, 80)
    x, w, corr, alpha = (t.detach() for t in (x, w, corr, alpha))
    y, code, _, _ = conv2_cuda.forward(x, w, corr, alpha, True, True)
    dx, dw, _, _ = conv2_cuda.backward(x, w, corr, alpha, g, y, code, gs, gq)
    d = conv2_cotangent(y, code, g, gs, gq, alpha, *x.shape[2:])
    c_in, c_out = w.shape[0] // 9, w.shape[1]
    want = conv2_dense_grads(x, w, d)
    one_pass = conv2_dense_grads(tf32(x), tf32(w), tf32(d.float()))
    weight = w.view(3, 3, c_in, c_out).permute(3, 2, 0, 1)
    d32 = d.float()
    cudnn = (torch.nn.grad.conv2d_input(x.shape, weight, d32, padding=1),
             torch.nn.grad.conv2d_weight(x, weight.shape, d32, padding=1)
             .permute(2, 3, 1, 0).reshape(9 * c_in, c_out))
    del d, d32
    torch.cuda.synchronize()

    def of_largest(got, ref):
        return ((got.double() - ref).abs().max() / ref.abs().max()).item()

    out = {name: {"kernel": of_largest(k, ref), "one_tf32_pass": of_largest(o, ref),
                  "cudnn_fp32": of_largest(c, ref)}
           for name, k, o, c, ref in zip(("dx", "dw"), (dx, dw), one_pass, cudnn, want)}
    log(f"  kernel 6 fp32 dx / dw at {CONV2_SHAPE} against float64 from its code, of the "
        f"largest entry (cap {SPLIT_TF32_RTOL:.0e}): {out}")
    for name, r in out.items():
        if not r["kernel"] <= SPLIT_TF32_RTOL:
            raise AssertionError(f"kernel 6 {name} is not fp32-accurate: {r}")
        if not r["one_tf32_pass"] > SPLIT_TF32_RTOL:
            raise AssertionError(f"the cap cannot tell one TF32 pass from split TF32: {r}")
    return out


def conv2_bf16_grads_check(conv2_cuda):
    """Check (b): kernel 6's bf16 ``dx``, ``dw``, ``dcorr`` and ``dalpha``
    at ``CONV2_SHAPE`` against a float64 rebuild from its own code: the
    conv-output cotangent as the kernels form it (float32 operations, one
    rounding each), rounded to bf16 for ``dx`` (the share of its bf16
    elements off the rebuild's, ``CONV2_BF16_DX_SHARE``) and ``dw`` (of the
    largest entry, ``CONV2_BF16_D_RTOL``), each cap exceeded by the rebuild
    from the unrounded cotangent; unrounded for ``dcorr``, and ``dalpha``
    from the stored output (``out / alpha``, the kernels' arithmetic), both
    within ``MID_SUM_RTOL`` of the largest entry (``rel_err``)."""
    (x, w, corr, alpha), (g, gs, gq) = conv2_case(*CONV2_SHAPE, torch.bfloat16, 0.25, 81)
    x, w, corr = x.detach(), w.detach().float(), corr.detach()
    alpha = alpha.detach().float()
    y, code, _, _ = conv2_cuda.forward(x, w, corr, alpha, True, True)
    dx, dw, dcorr, da = conv2_cuda.backward(x, w, corr, alpha, g, y, code, gs, gq)
    h, win = x.shape[2:]
    # the kernels' d before its rounding, operation by operation in float32
    gt = (g.float() + gs[:, None, None]) + (2 * y.float()) * gq[:, None, None]
    sel = torch.where(code >= 4, alpha * gt, gt)
    d64 = conv2_cotangent(y, code, g, gs, gq, alpha, h, win)  # float64, unrounded
    d_r = conv2_cotangent(y, code, sel.bfloat16(), torch.zeros_like(gs), torch.zeros_like(gq),
                          torch.ones_like(alpha), h, win)  # the same at the kernels' bf16 values
    neg = code >= 4
    want_dalpha = torch.where(neg, y.double() / alpha.double() * gt.double(), 0.0).sum()
    (dx_r, dw_r), (dx_u, dw_u) = conv2_dense_grads(x, w, d_r), conv2_dense_grads(x, w, d64)
    dx_r = dx_r.bfloat16()

    def share(got):  # of dx's elements off the rounded rebuild, in bf16
        return (got.bfloat16() != dx_r).double().mean().item()

    out = {"dx": {"kernel_share": share(dx), "unrounded_rebuild_share": share(dx_u),
                  "kernel": rel_err(dx, dx_r)},
           "dw": {"kernel": rel_err(dw, dw_r), "unrounded_rebuild": rel_err(dw_u, dw_r)}}
    out["dcorr"] = {"kernel": rel_err(dcorr, d64.sum(dim=0))}
    out["dalpha"] = {"kernel": rel_err(da, want_dalpha.reshape(1))}
    del d64, d_r, dx_r, dw_r, dx_u, dw_u
    torch.cuda.synchronize()
    log(f"  kernel 6 bf16 grads at {CONV2_SHAPE} against float64 from its code (dx: share "
        f"of elements off the rebuild in bf16, cap {CONV2_BF16_DX_SHARE:.0e}; dw of the "
        f"largest entry, cap {CONV2_BF16_D_RTOL:.0e}; dcorr / dalpha {MID_SUM_RTOL:.0e}): "
        f"{out}")
    caps = (("dx", "kernel_share", "unrounded_rebuild_share", CONV2_BF16_DX_SHARE),
            ("dw", "kernel", "unrounded_rebuild", CONV2_BF16_D_RTOL))
    for name, kernel, unrounded, cap in caps:
        if not out[name][kernel] <= cap:
            raise AssertionError(f"kernel 6 bf16 {name} off its rebuild: {out[name]}")
        if not out[name][unrounded] > cap:
            raise AssertionError(f"the cap cannot tell a rounded d from an unrounded one: "
                                 f"{out[name]}")
    for name in ("dcorr", "dalpha"):
        if not out[name]["kernel"] <= MID_SUM_RTOL:
            raise AssertionError(f"kernel 6 bf16 {name} off its rebuild: {out[name]}")
    return out


def train_mid(wpt_cuda, fused_cuda, pool_cuda, conv2_cuda, root: str, data: str, unfused_losses):
    """Phase 15: the training path with the fused mid blocks, through
    ``run_experiment`` on the card; ``unfused_losses``: phase 7's unfused
    run from the same seed (dropout 0 there and here)."""
    from audiodeepfake_detection_tpu_torch.train.experiment import run_experiment

    steps = EPOCHS * STEPS_PER_EPOCH
    out = {"steps": steps}
    # per train step: (a) kernel 5 behind cnn[7] (with moments) and cnn[17];
    # (b) kernel 6 takes cnn[6:10], kernel 5 is left with cnn[18:20]
    runs = (("a", dict(fused_pool=True), 2, 0),
            ("b", dict(fused_pool=True, fused_layer2=True), 1, 1))
    for name, flags, pool_per_step, conv2_per_step in runs:
        wpt_cuda.LAUNCHES = fused_cuda.FWD_LAUNCHES = fused_cuda.BWD_LAUNCHES = 0
        pool_cuda.POOL_FWD_LAUNCHES = pool_cuda.POOL_BWD_LAUNCHES = 0
        conv2_cuda.CONV2_FWD_LAUNCHES = conv2_cuda.CONV2_BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        trainer = run_experiment(train_args(
            root, data, f"log_mid_{name}", dropout_cnn=0.0, dropout_lstm=0.0, **flags))
        torch.cuda.synchronize()
        counts = {"wpt": wpt_cuda.LAUNCHES, "conv1_fwd": fused_cuda.FWD_LAUNCHES,
                  "conv1_bwd": fused_cuda.BWD_LAUNCHES,
                  "pool_fwd": pool_cuda.POOL_FWD_LAUNCHES, "pool_bwd": pool_cuda.POOL_BWD_LAUNCHES,
                  "conv2_fwd": conv2_cuda.CONV2_FWD_LAUNCHES,
                  "conv2_bwd": conv2_cuda.CONV2_BWD_LAUNCHES}
        wall = time.perf_counter() - t0
        losses = [row[2] for row in trainer.loss_list]
        worst = max(abs(u - v) / abs(v) for u, v in zip(losses, unfused_losses))
        log(f"  run ({name}) {flags}: losses {['%.6f' % v for v in losses]} (worst rel diff "
            f"to unfused {worst:.2e}), test {trainer.test_results}, launches {counts}, "
            f"{wall:.1f} s wall")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"run ({name}) losses: {losses}")
        want = {"conv1_fwd": steps, "conv1_bwd": steps,
                "pool_fwd": pool_per_step * steps, "pool_bwd": pool_per_step * steps,
                "conv2_fwd": conv2_per_step * steps, "conv2_bwd": conv2_per_step * steps}
        if any(counts[k] != v for k, v in want.items()) or counts["wpt"] < steps:
            raise AssertionError(f"run ({name}) launch counts {counts}, want {want}")
        model = trainer.model
        if ((model.fused_layer1, model.fused_pool, bool(model.fused_layer2))
                != (True, True, "fused_layer2" in flags) or trainer.device.type != "cuda"):
            raise AssertionError(f"run ({name}) left the fused path or the card")
        if not worst <= LOSS_RTOL:
            raise AssertionError(
                f"run ({name}) vs unfused losses differ by {worst} > {LOSS_RTOL}")
        acc, eer = trainer.test_results[:2]
        if not (0.0 <= acc <= 1.0 and 0.0 <= eer <= 1.0):  # NaN fails too
            raise AssertionError(f"run ({name}) test results {trainer.test_results}")
        out[name] = {"launches": counts, "losses": losses, "loss_rel_diff": worst,
                     "wall_s": wall}
    out["served_vs_trainer"] = served_vs_trainer(trainer)
    out["snapshot"] = trainer.snapshot_path
    return out


def mid_timing(fp, pool_cuda, f2, conv2_cuda, norm, card_line: str):
    """Phase 16: kernels 5 and 6 alone vs plain (through their launchers, as
    phase 8 times kernel 2), the DCNN train step with each set of flags, and
    the eval step."""
    out = {}
    for name, shape, dtype in (("pool2", POOL2_SHAPE, torch.float32),
                               ("pool3", POOL3_SHAPE, torch.float32),
                               ("pool2_bf16", POOL2_SHAPE, torch.bfloat16)):
        (x, alpha), cot = pool_case(*shape, dtype, 0.25, seed=90)
        raw = (x.detach(), alpha.detach().float())  # the slope as the autograd glue passes it
        y, code, _, _ = pool_cuda.forward(*raw, True, True)
        graph = fp.plain_prelu_pool_stats(x, alpha)
        fwd = median_ms({
            "plain": lambda: fp.plain_prelu_pool_stats(x, alpha),
            "kernel": lambda: pool_cuda.forward(*raw, True, True),
        }, reps=10)
        bwd = median_ms({
            "plain": lambda: torch.autograd.grad(graph, (x, alpha), cot, retain_graph=True),
            "kernel": lambda: pool_cuda.backward(*raw, cot[0], y, code, cot[1], cot[2]),
        }, reps=10)
        n_negative = int((code >= 4).sum())
        (fb, _), (bb, _) = pool_bounds(*shape, n_negative, x.element_size())
        # the kernels' own device time: at the small shape the launcher's
        # host work (checks, allocations, the partials' sum) outlasts them
        dev, b2b = {}, {}
        for key, call, kernel in (
                ("fwd", lambda: pool_cuda.forward(*raw, True, True), "fused_pool_fwd_kernel"),
                ("bwd", lambda: pool_cuda.backward(*raw, cot[0], y, code, cot[1], cot[2]),
                 "fused_pool_bwd_kernel")):
            dev.update(kernel_device_ms(call, {key: kernel}))
            b2b.update(kernel_device_ms(call, {key: kernel}, back_to_back=True))
        out[name] = {"fwd_kernel_ms": fwd["kernel"], "fwd_plain_ms": fwd["plain"],
                     "bwd_kernel_ms": bwd["kernel"], "bwd_plain_ms": bwd["plain"],
                     "fwd_device_ms": dev["fwd"], "bwd_device_ms": dev["bwd"],
                     "fwd_device_back_to_back_ms": b2b["fwd"],
                     "bwd_device_back_to_back_ms": b2b["bwd"],
                     "fwd_bound_ms": fb, "bwd_bound_ms": bb, "n_negative": n_negative}
        log(f"  kernel 5 at {name} [{card_line}]: bwd {bwd['kernel']:.4f} ms through the "
            f"launcher, {ms_or_not(dev['bwd'])} ms of device time "
            f"({ms_or_not(b2b['bwd'])} back to back), against its byte bound {bb:.4f} ms "
            f"({100 * bb / bwd['kernel']:.1f} % of the launcher's); fwd {fwd['kernel']:.4f} "
            f"ms, {ms_or_not(dev['fwd'])} ms device ({ms_or_not(b2b['fwd'])} back to back), "
            f"against {fb:.4f} ms")
        del graph, y, code, x, raw
    (x, w, corr, alpha), cot = conv2_case(*CONV2_SHAPE, torch.float32, 0.25, seed=91)
    raw = tuple(t.detach() for t in (x, w, corr, alpha))
    y, code, _, _ = conv2_cuda.forward(*raw, True, True)
    graph = f2.plain_conv2_prelu_pool_stats(x, w, corr, alpha)
    fwd = median_ms({
        "plain": lambda: f2.plain_conv2_prelu_pool_stats(x, w, corr, alpha),
        "kernel": lambda: conv2_cuda.forward(*raw, True, True),
    }, reps=5)
    backward = lambda: conv2_cuda.backward(*raw, cot[0], y, code, cot[1], cot[2])  # noqa: E731
    bwd = median_ms({
        "plain": lambda: torch.autograd.grad(graph, (x, w, corr, alpha), cot, retain_graph=True),
        "kernel": backward,
        "kernel_without_dx": lambda: conv2_cuda.backward(
            *raw, cot[0], y, code, cot[1], cot[2], need_dx=False),
    }, reps=5)
    # the backward's three kernels apart: their device time in a profile
    apart = kernel_device_ms(backward, {"dx": "fused_conv2_dx_kernel",
                                        "dw": "fused_conv2_dw_kernel",
                                        "small": "fused_conv2_small_kernel"})
    out["conv2"] = {"fwd_kernel_ms": fwd["kernel"], "fwd_plain_ms": fwd["plain"],
                    "bwd_kernel_ms": bwd["kernel"], "bwd_plain_ms": bwd["plain"],
                    "bwd_kernel_without_dx_ms": bwd["kernel_without_dx"],
                    "bwd_dx_ms": apart["dx"], "bwd_dw_ms": apart["dw"],
                    "bwd_small_ms": apart["small"],
                    # computed, not measured: beside the bound, not in its place
                    "dense_3xtf32_floor_ms_computed": conv2_bounds(*CONV2_SHAPE)[2]}
    del graph, y, code, x, raw, backward
    c2 = out["conv2"]
    log(f"  B={BATCH} [{card_line}]: " + "; ".join(
        f"{k} fwd kernel {v['fwd_kernel_ms']:.4f} ms, plain {v['fwd_plain_ms']:.4f} ms, bwd "
        f"kernel {v['bwd_kernel_ms']:.4f} ms, plain {v['bwd_plain_ms']:.4f} ms"
        for k, v in out.items()) + f"; conv2 bwd without dx {c2['bwd_kernel_without_dx_ms']:.4f}"
        f" ms; its kernels' device time (profiler): dx {ms_or_not(c2['bwd_dx_ms'])}, dw "
        f"{ms_or_not(c2['bwd_dw_ms'])}, small {ms_or_not(c2['bwd_small_ms'])} ms; the dense "
        f"split-TF32 "
        f"floor, computed at 495 TFLOP/s: {c2['dense_3xtf32_floor_ms_computed']:.4f} ms")

    variants = {"unfused": (False, {}), "layer1": (True, {}),
                "a_layer1_pool": (True, dict(fused_pool=True)),
                "b_layer1_pool_layer2": (True, dict(fused_pool=True, fused_layer2=True))}
    fns = {name: step_fns(norm, fused, **flags) for name, (fused, flags) in variants.items()}
    steps = median_ms({name: fn[0] for name, fn in fns.items()}, reps=3)
    evals = median_ms({"eval": fns["b_layer1_pool_layer2"][1]}, reps=3)
    out["train_step_ms"] = steps
    out["train_frames_per_s"] = {k: BATCH / v * 1e3 for k, v in steps.items()}
    out["eval_step_ms"] = evals["eval"]
    log("  train step: " + ", ".join(
        f"{k} {v:.3f} ms ({BATCH / v * 1e3:.1f} frames/s)" for k, v in steps.items())
        + f"; eval step {evals['eval']:.3f} ms")
    return out, fns["b_layer1_pool_layer2"][0]


# --------------------------------------------------- the AST path (17-19)


def mha_bounds(b, n, heads, itemsize=4, flop_per_s=FP32_FLOP_PER_S):
    """Forward: qkv read, out and the row statistics written; q.k^T and p.v,
    2 N^2 D flops each per head.  Backward: qkv, dout and the statistics
    read, dqkv written; five such products (q.k^T, dO.v^T, p^T.dO, dS.k,
    dS^T.q)."""
    product = 2 * n * n * 64 * heads * b
    qkv = itemsize * b * n * 3 * heads * 64
    out = itemsize * b * n * heads * 64
    stats = 4 * b * heads * n * 2
    return (bound_ms(qkv + out + stats, 2 * product, flop_per_s),
            bound_ms(2 * qkv + out + stats, 5 * product, flop_per_s))


def mha_case(b, n, heads, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * heads * 64, generator=gen).cuda().to(dtype)
    return qkv.requires_grad_(), torch.randn(b, n, heads * 64, generator=gen).cuda().to(dtype)


def mha_counts(fa_cuda):
    return fa_cuda.MHA_FWD_LAUNCHES, fa_cuda.MHA_BWD_LAUNCHES


def misaligned(t):
    """A copy of ``t`` whose data starts one element (4 bytes in fp32, 2 in
    bf16) past a 16-byte boundary: the kernels' element-wise variant."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view_as(t)
    view.copy_(t.detach())
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def mha_run(fa, fa_cuda, qkv, g, heads):
    """Output and ``dqkv`` through the autograd Function; fails unless the
    kernels launched once each way."""
    before = mha_counts(fa_cuda)
    y = fa.flash_mha_packed(qkv, heads, 0.125)
    result = y, torch.autograd.grad(y, qkv, g)[0]
    after = mha_counts(fa_cuda)
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
        raise AssertionError(f"kernel 4 at {tuple(qkv.shape)}: launches {before} -> {after}")
    return result


def mha_vs_plain(fa, fa_cuda):
    """Phase 17: kernel 4 against the plain version under autograd, and
    against itself, at every token count a user reaches (1 s frames: 227;
    2 s frames: ``STREAM_SHAPE``; short and ragged ones), and at views whose
    qkv or cotangent does not start on a 16-byte boundary."""
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(AST_SHAPE, ""), (STREAM_SHAPE, ""), ((2, 99, 3), ""), ((3, 18, 3), ""),
              ((1, 1, 1), ""), ((1, 256, 2), ""), ((1, 300, 2), ""),
              ((2, 99, 3), "misaligned-qkv-"), ((1, 300, 2), "misaligned-dout-")]
    out = {}
    cases = [(s, d) for s in shapes for d in (f32, bf16)]
    for i, (((b, n, heads), view), dtype) in enumerate(cases):
        qkv, g = mha_case(b, n, heads, dtype, seed=100 + i)
        want = fa.plain_mha_packed(qkv, heads, 0.125)
        (wgrad,) = torch.autograd.grad(want, qkv, g)
        x, gx = qkv, g
        if view == "misaligned-qkv-":
            x = misaligned(qkv).requires_grad_()
        elif view == "misaligned-dout-":
            gx = misaligned(g)
        runs = [mha_run(fa, fa_cuda, x, gx, heads) for _ in range(2)]
        torch.cuda.synchronize()
        y, dqkv = runs[0]
        bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
        fp32 = dtype == f32
        fwd_err = (y.float() - want.float()).abs().max().item()
        fwd_tol = MHA_FWD_ATOL if fp32 else want.float().abs().max().item() * MHA_BF16_FWD_RTOL
        grad_rel = rel_err(dqkv, wgrad)
        key = f"{view}B{b}-N{n}-H{heads}-{str(dtype).split('.')[-1]}"
        out[key] = {"fwd_max_abs_err": fwd_err, "dqkv_rel_err": grad_rel,
                    "dqkv_max_abs_err": (dqkv.float() - wgrad.float()).abs().max().item(),
                    "bitwise_repeat": bitwise}
        log(f"  {key}: out max|err| {fwd_err:.3e} (tol {fwd_tol:.1e}), dqkv rel "
            f"{grad_rel:.2e}, repeat bit-equal {bitwise}")
        if not (fwd_err <= fwd_tol
                and grad_rel <= (MHA_GRAD_RTOL if fp32 else MHA_BF16_GRAD_RTOL)):
            raise AssertionError(f"kernel 4 vs plain at {key}: {out[key]}")
        if not bitwise:
            raise AssertionError(f"kernel 4 at {key}: two runs differ")
        del runs, y, dqkv, want, wgrad, qkv, g, x, gx
    return out


def sass_opcodes(lib) -> dict:
    """The instructions of each kernel of a built library by opcode, from
    ``cuobjdump -sass``: ``{mangled name: Counter(opcode: count)}`` (static
    counts of the compiled code, not of a run)."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib._name], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            counts[name] = collections.Counter()
            continue
        op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name is not None and op:
            counts[name][op.group(1)] += 1
    return counts


def hmma_per_kernel(lib) -> dict:
    """Tensor-core instructions (HMMA) in each kernel of a built library:
    ``{mangled name: count}``."""
    return {name: ops["HMMA"] for name, ops in sass_opcodes(lib).items()}


def conv2_mma_count(conv2_cuda) -> dict:
    """Phase 14, last: HMMA instructions in kernel 6.  The float32 forward
    (the FMA pipe, in cuDNN's summation order; two variants) must have none,
    the bf16 forward (m16n8k16; four N tiles) some, and the dx and dw
    kernels (split TF32, or bf16) some in both types."""
    import re

    found = {}
    for mangled, n_mma in hmma_per_kernel(conv2_cuda._LIB).items():
        kind = re.search(r"fused_conv2_(fwd|dx|dw|small)(_bf16)?_kernel", mangled)
        if kind:
            dtype = "bfloat16" if kind.group(2) or "bfloat16" in mangled else "float32"
            n = re.search(r"Li(\d+)E", mangled)  # channels a thread, or n8 tiles a warp
            found[f"{kind.group(1)}-{dtype}" + (f"-{n.group(1)}" if n else "")] = n_mma
    log(f"  HMMA instructions per kernel-6 kernel: {found}")
    gemms = {k: v for k, v in found.items() if k.startswith(("dx-", "dw-"))}
    fwd32 = {k: v for k, v in found.items() if k.startswith("fwd-float32")}
    fwd16 = {k: v for k, v in found.items() if k.startswith("fwd-bfloat16")}
    if (len(gemms) != 4 or min(gemms.values()) <= 0 or len(fwd32) != 2 or any(fwd32.values())
            or len(fwd16) != 4 or min(fwd16.values()) <= 0):
        raise AssertionError(f"kernel 6 tensor-core instructions: {found}")
    return found


def mma_count(fa_cuda) -> dict:
    """Phase 17, last: tensor-core instructions (HMMA) in each kernel of the
    built library.  Every kernel (bf16 m16n8k16, fp32 split TF32 m16n8k8),
    in its cp.async and its element-wise variant, must have them: 12
    kernels, forward, dQ and dK/dV in two types and two load variants."""
    import re

    found, mix = {}, {}
    for mangled, ops in sass_opcodes(fa_cuda._LIB).items():
        kind = re.search(r"flash_mha_stream_(fwd|dq|dkv)_kernel", mangled)
        if kind:
            dtype = "bfloat16" if "bfloat16" in mangled else "float32"
            key = f"stream-{kind.group(1)}-{dtype}"  # template <T, bool kAligned>
            key += "-aligned" if "Lb1E" in mangled else "-elementwise"
            if key.endswith("-aligned"):  # what the kernels issue
                mix[key] = dict(ops.most_common(10), total=sum(ops.values()))
            found[key] = ops["HMMA"]
    log(f"  HMMA instructions per kernel-4 kernel: {found}")
    for key, ops in mix.items():
        log(f"  {key} instructions (static): {ops}")
    if len(found) != 12 or min(found.values()) <= 0:
        raise AssertionError(f"tensor-core instructions: {found}")
    return {"hmma": found, "stream_sass": mix}


def ast_args(root: str, data: str, log_dir: str, **extra):
    """stft (n_fft 511, hop 220, log power) + the base384 AST with the fused
    attention; ``flattend_size`` unset, so the time axis is the probed one."""
    args = train_args(root, data, log_dir)
    args.update(transform="stft", hop_length=220, module="AST", ast_model_size="base384",
                ast_fused_attention=True, flattend_size=None, fused_layer1=False,
                batch_size=AST_BATCH, learning_rate=1e-4, weight_decay=0.01)
    args.update(extra)
    return args


def train_ast(fa_cuda, root: str, data: str):
    """Phase 18: the AST path through ``run_experiment`` on the card."""
    from audiodeepfake_detection_tpu_torch.train.experiment import run_experiment

    def reset():
        fa_cuda.MHA_FWD_LAUNCHES = fa_cuda.MHA_BWD_LAUNCHES = 0

    def read():
        torch.cuda.synchronize()
        return {"fwd": fa_cuda.MHA_FWD_LAUNCHES, "bwd": fa_cuda.MHA_BWD_LAUNCHES}

    steps = EPOCHS * AST_STEPS_PER_EPOCH
    reset()
    t0 = time.perf_counter()
    trainer = run_experiment(ast_args(root, data, "log_ast"))
    counts = read()
    wall = time.perf_counter() - t0
    losses = [row[2] for row in trainer.loss_list]
    model = trainer.model
    log(f"  main run: input {trainer.args.input_dim}, {steps} steps, losses "
        f"{['%.4f' % v for v in losses]}, test {trainer.test_results}, launches {counts}, "
        f"{wall:.1f} s wall")
    if trainer.args.input_dim != [AST_BATCH, 1, 256, 101] or model.num_patches != 225:
        raise AssertionError(f"AST input {trainer.args.input_dim}, {model.num_patches} patches")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"AST main run losses: {losses}")
    # every block launches once per train step each way, and forward only
    # for each validation and test batch
    if not (counts["bwd"] == AST_BLOCKS * steps and counts["fwd"] > counts["bwd"]
            and counts["fwd"] % AST_BLOCKS == 0):
        raise AssertionError(f"launch counts {counts} for {steps} AST train steps")
    if (model.get_name() != "AST" or not model.fused_attention or model.dtype is not None
            or trainer.device.type != "cuda"):
        raise AssertionError("the AST main run left the fused path or the card")
    acc, eer = trainer.test_results[:2]
    if not (0.0 <= acc <= 1.0 and 0.0 <= eer <= 1.0):  # NaN fails too
        raise AssertionError(f"AST test results {trainer.test_results}")

    # the same training unfused (all drop rates are 0 by default)
    unfused = [row[2] for row in run_experiment(
        ast_args(root, data, "log_ast_unfused", ast_fused_attention=False)).loss_list]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, unfused))
    log(f"  fused   losses {['%.6f' % v for v in losses]}")
    log(f"  unfused losses {['%.6f' % v for v in unfused]} (worst rel diff {worst:.2e})")
    if len(unfused) != steps or not worst <= AST_LOSS_RTOL:
        raise AssertionError(f"AST fused vs unfused losses differ by {worst} > {AST_LOSS_RTOL}")

    # one epoch in bf16 with bf16 Adam moments; the launcher records the
    # types it was given
    seen = set()
    launch = fa_cuda.forward

    def spy(qkv, *rest):
        seen.add(str(qkv.dtype))
        return launch(qkv, *rest)

    reset()
    fa_cuda.forward = spy
    try:
        bf = run_experiment(ast_args(root, data, "log_ast_bf16", epochs=1, dtype="bfloat16",
                                     adam_moments_dtype="bfloat16"))
    finally:
        fa_cuda.forward = launch
    bf_counts = read()
    bf_losses = [row[2] for row in bf.loss_list]
    moments = bf.optimizer.state[next(bf.model.parameters())]
    log(f"  bf16 + bf16 moments: losses {['%.4f' % v for v in bf_losses]}, launches "
        f"{bf_counts}, kernel given {sorted(seen)}, moments {moments['exp_avg'].dtype}")
    if (len(bf_losses) != AST_STEPS_PER_EPOCH or not np.isfinite(bf_losses).all()
            or seen != {"torch.bfloat16"} or bf_counts["bwd"] != AST_BLOCKS * AST_STEPS_PER_EPOCH
            or moments["exp_avg"].dtype != torch.bfloat16):
        raise AssertionError(f"the bf16 AST run: {bf_losses}, {bf_counts}, {seen}")
    del bf
    return trainer, {"launches": counts, "steps": steps, "losses": losses,
                     "unfused_losses": unfused, "loss_rel_diff": worst, "wall_s": wall,
                     "bf16_losses": bf_losses, "bf16_launches": bf_counts,
                     "norm": [np.asarray(v).tolist() for v in trainer.norm_stats]}


def serve_ast(fa_cuda, trainer):
    """Phase 18, last: the trained AST as a model object behind
    ``ScoringService`` (batch 64, default chunk) over HTTP, scores against a
    copy of the model on the CPU."""
    import copy

    from audiodeepfake_detection_tpu_torch.train.predict import make_score_fn
    from audiodeepfake_detection_tpu_torch.train.serve import ScoringService

    cpu_score = make_score_fn(copy.deepcopy(trainer.model).cpu(), trainer.transform, "cpu")
    svc = ScoringService(trainer.model, trainer.transform, device="cuda", batch_size=64)
    if svc.chunk != 0:  # the whole batch: the fastest in phase 19's sweep
        raise AssertionError(f"default chunk at batch 64: {svc.chunk}")
    rng = np.random.RandomState(8)
    clips = [(1.0, SR), (2.5, SR), (5.0, SR), (2.0, 2 * SR)]
    pcms = [rng.randint(-12000, 12000, int(s * r)).astype(np.int16) for s, r in clips]

    def reset():
        fa_cuda.MHA_FWD_LAUNCHES = 0

    def read():
        return fa_cuda.MHA_FWD_LAUNCHES

    out = serve_service(svc, cpu_score, clips, pcms, reset, read)
    out["chunk"] = svc.chunk
    return out


def ast_step_fns(norm, fused: bool = True, bf16: bool = False, seconds: int = 1):
    """An AST train step and eval step at base384 on a fixed batch of 32
    frames of ``seconds`` s, and the model and transform."""
    from audiodeepfake_detection_tpu_torch.models.ast import ASTModel
    from audiodeepfake_detection_tpu_torch.train.steps import (
        make_eval_step, make_optimizer, make_train_step)
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    args = ast_args("", "", "")
    transform = normalized_transform(make_transform(args), *[np.asarray(v) for v in norm])
    gen = torch.Generator().manual_seed(6)
    batch = {"audio": (0.3 * torch.randn(AST_BATCH, 1, seconds * SR, generator=gen)).cuda(),
             "label": torch.randint(0, 2, (AST_BATCH,), generator=gen).cuda()}
    with torch.no_grad():
        tdim = transform(batch["audio"]).shape[-1]
    torch.manual_seed(0)
    model = ASTModel(input_tdim=tdim, fused_attention=fused,
                     dtype=torch.bfloat16 if bf16 else None).cuda()
    optimizer = make_optimizer(model.parameters(), args.learning_rate, args.weight_decay,
                               moment_dtype="bfloat16" if bf16 else None)
    train_step = make_train_step(model, transform, optimizer)
    eval_step = make_eval_step(model, transform)
    return (lambda: train_step(batch)), (lambda: eval_step(batch)), model, transform


def sdpa_packed(qkv, heads: int, scale: float):
    """The library yardstick for kernel 4 (timed only; the port never calls
    it): ``scaled_dot_product_attention`` on the permuted q, k and v views
    of the packed tensor, the result copied back to the packed layout."""
    import torch.nn.functional as F

    b, n, c = qkv.shape
    q, k, v = qkv.view(b, n, 3, heads, c // 3 // heads).permute(2, 0, 3, 1, 4)
    out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return out.transpose(1, 2).reshape(b, n, c // 3)


AST_KERNEL_GROUPS = (
    ("flash_mha", ("flash_mha",)),
    ("stft", ("fft",)),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90_", "sm80_", "nvjet")),
    ("patch_conv", ("conv", "implicit")),
    ("layer_norm", ("layer_norm",)),
    ("softmax", ("softmax",)),
    ("gelu", ("gelu",)),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "cat")),
)


CHUNK_BATCHES = (64, 128, 512)
CHUNKS = (0, 8, 16, 32)  # 0: the whole batch at once


def ast_timing(fa, fa_cuda, norm, card_line: str):
    """Phase 19: kernel 4 alone (through its launchers) vs plain and vs SDPA,
    fp32 and bf16, at ``AST_SHAPE``, ``STREAM_SHAPE`` (phase 20's geometry)
    and ``MHA_SWEEP_SHAPES``; the AST train step fused, unfused and bf16
    with bf16 moments, the eval step, and the scorer at batch 64, 128 and
    512 with each chunk."""
    out = {}
    for (b, n, heads), dtype in ((s, d) for s in (AST_SHAPE, STREAM_SHAPE) + MHA_SWEEP_SHAPES
                                 for d in (torch.float32, torch.bfloat16)):
        qkv, g = mha_case(b, n, heads, dtype, seed=120)
        raw = qkv.detach()
        y, stats = fa_cuda.forward(raw, heads, 0.125, True)
        plain_graph = fa.plain_mha_packed(qkv, heads, 0.125)
        lib_graph = sdpa_packed(qkv, heads, 0.125)
        lib_err = (lib_graph.float() - y.float()).abs().max().item()
        fwd = median_ms({
            "plain": lambda: fa.plain_mha_packed(qkv, heads, 0.125),
            "kernel": lambda: fa_cuda.forward(raw, heads, 0.125, True),
            "library": lambda: sdpa_packed(qkv, heads, 0.125),
        }, reps=10)
        bwd = median_ms({
            "plain": lambda: torch.autograd.grad(plain_graph, qkv, g, retain_graph=True),
            "kernel": lambda: fa_cuda.backward(raw, g, stats, heads, 0.125, out=y),
            "library": lambda: torch.autograd.grad(lib_graph, qkv, g, retain_graph=True),
        }, reps=10)
        name = str(dtype).split(".")[-1]
        itemsize = 2 if dtype == torch.bfloat16 else 4
        (fb, fby), (bb, bby) = mha_bounds(
            b, n, heads, itemsize, BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S)
        out[f"B{b}-N{n}-H{heads}-{name}"] = {
            "fwd_kernel_ms": fwd["kernel"], "bwd_kernel_ms": bwd["kernel"],
            "fwd_plain_ms": fwd["plain"], "fwd_library_ms": fwd["library"],
            "bwd_plain_ms": bwd["plain"], "bwd_library_ms": bwd["library"],
            "fwd_bound_ms": fb, "fwd_bound_by": fby,
            "bwd_bound_ms": bb, "bwd_bound_by": bby,
            "library_vs_kernel_max_abs": lib_err}
        log(f"  B={b} N={n} H={heads} {name} [{card_line}]: fwd " + ", ".join(
            f"{k} {fwd[k]:.4f} ms" for k in fwd) + f" (bound {fb:.4f}, {fby}); bwd "
            + ", ".join(f"{k} {bwd[k]:.4f} ms" for k in bwd) + f" (bound {bb:.4f}, {bby}) "
            f"(SDPA vs kernel max|diff| {lib_err:.2e})")
        del plain_graph, lib_graph, y, stats, qkv, raw, g

    variants = {"fused": dict(), "unfused": dict(fused=False), "bf16": dict(bf16=True)}
    fns = {name: ast_step_fns(norm, **kw) for name, kw in variants.items()}
    steps = median_ms({name: fn[0] for name, fn in fns.items()}, reps=3)
    evals = median_ms({"eval": fns["fused"][1]}, reps=3)
    _, _, model, transform = fns["fused"]
    from audiodeepfake_detection_tpu_torch.train.predict import make_score_fn

    gen = torch.Generator().manual_seed(7)
    scorer = {}
    for batch in CHUNK_BATCHES:
        audio = (0.3 * torch.randn(batch, 1, SR, generator=gen)).cuda()
        score = {c: make_score_fn(model, transform, "cuda", chunk=c) for c in CHUNKS}
        with torch.no_grad():
            ms = median_ms({f"chunk{c}": (lambda c=c: score[c](audio)) for c in CHUNKS},
                           reps=1 if batch > 128 else 3)
        scorer[batch] = ms
        log(f"  AST scorer at B={batch} [{card_line}]: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ms.items()))
        del audio, score
    out.update({
        "train_step_ms": steps,
        "train_frames_per_s": {k: AST_BATCH / v * 1e3 for k, v in steps.items()},
        "eval_step_ms": evals["eval"], "scorer_ms": scorer,
    })
    log("  AST train step at B=32: " + ", ".join(
        f"{k} {v:.3f} ms ({AST_BATCH / v * 1e3:.1f} frames/s)" for k, v in steps.items())
        + f"; eval step {evals['eval']:.3f} ms")
    steps = {name: fns[name][0] for name in ("fused", "bf16")}
    del fns, model
    return out, steps


def train_long(wpt, wpt_cuda, fa_cuda, root: str, data: str, card_line: str):
    """Phase 20: the corpus cut into 2 s frames.  Packets + DCNN (the WPT's
    subtrees on chip) and stft + AST (477 tokens through kernel 4), each
    through ``run_experiment`` with its launch counts read over exactly
    that run; then the WPT on 2 s frames timed against plain."""
    from audiodeepfake_detection_tpu_torch.train.experiment import run_experiment

    frame = 2 * SR
    # 196 training frames of 2 s: 3 steps of 64 (DCNN), 6 of 32 (AST)
    wpt_cuda.LAUNCHES = wpt_cuda.LEVEL_LAUNCHES = 0
    dcnn = run_experiment(train_args(root, data, "log_long", seconds=2, batch_size=64,
                                     epochs=1, time_dim_add=0))
    torch.cuda.synchronize()
    counts = dict(zip(("subtree", "level"), wpt_counts(wpt_cuda)))
    losses = [row[2] for row in dcnn.loss_list]
    log(f"  packets + DCNN, 2 s frames: input {dcnn.args.input_dim}, losses "
        f"{['%.4f' % v for v in losses]}, test {dcnn.test_results}, WPT launches {counts}")
    # every 2 s batch runs its subtrees on chip from the frame: no level
    # goes through device memory
    if (dcnn.args.input_dim[-1] != 181 or len(losses) != 3 or not np.isfinite(losses).all()
            or counts["subtree"] < len(losses) or counts["level"] != 0):
        raise AssertionError(f"2 s DCNN run: {dcnn.args.input_dim}, {losses}, {counts}")
    del dcnn

    fa_cuda.MHA_FWD_LAUNCHES = fa_cuda.MHA_BWD_LAUNCHES = 0
    ast = run_experiment(ast_args(root, data, "log_ast_long", seconds=2, epochs=1))
    torch.cuda.synchronize()
    mha = dict(zip(("fwd", "bwd"), mha_counts(fa_cuda)))
    ast_losses = [row[2] for row in ast.loss_list]
    tokens = ast.model.num_patches + 2
    log(f"  stft + AST, 2 s frames: input {ast.args.input_dim}, {tokens} tokens, losses "
        f"{['%.4f' % v for v in ast_losses]}, test {ast.test_results}, kernel-4 launches {mha}")
    if (tokens != STREAM_SHAPE[1] or len(ast_losses) != 6
            or not np.isfinite(ast_losses).all()
            or mha["bwd"] != AST_BLOCKS * len(ast_losses) or mha["fwd"] <= mha["bwd"]):
        raise AssertionError(f"2 s AST run: {tokens} tokens, {ast_losses}, {mha}")
    norm = ast.norm_stats
    del ast

    # the 2 s AST train step, fused fp32 and bf16 (bf16 moments), timed and
    # profiled: kernel 4's share of the step's device time
    fns = {name: ast_step_fns(norm, seconds=2, **kw)
           for name, kw in (("fused", {}), ("bf16", dict(bf16=True)))}
    if any(fn[2].num_patches + 2 != STREAM_SHAPE[1] for fn in fns.values()):
        raise AssertionError("the 2 s AST step is not at phase 20's token count")
    before = mha_counts(fa_cuda)
    step_ms = median_ms({name: fn[0] for name, fn in fns.items()}, reps=3)
    torch.cuda.synchronize()
    after = mha_counts(fa_cuda)
    if after[1] == before[1]:
        raise AssertionError(f"2 s AST steps launched no kernel-4 backward: {before} -> {after}")
    step_prof, share = {}, {}
    for name, fn in fns.items():
        log(f"  profile of the 2 s {name} AST step")
        step_prof[name] = profile_train(fn[0], kernel_groups=AST_KERNEL_GROUPS)
        share[name] = step_prof[name]["groups"]["flash_mha"] / step_prof[name]["device_ms"]
    log(f"  2 s AST train step at B={AST_BATCH} [{card_line}]: " + ", ".join(
        f"{k} {v:.3f} ms, kernel 4 {step_prof[k]['groups']['flash_mha']:.3f} ms "
        f"({100 * share[k]:.1f} % of device time)" for k, v in step_ms.items()))
    del fns

    b = LONG_CASES[0][0]  # the DCNN run's batch, held against plain in phase 3
    x = torch.randn(b, frame, generator=torch.Generator().manual_seed(9)).cuda()
    ms = wpt_times(wpt_cuda, wpt, x, reps=10)
    log(f"  WPT on 2 s frames at B={b}, T={frame}, with the log [{card_line}]: kernel "
        f"{ms['wpt_kernel_ms']:.4f} ms through the launcher, {ms_or_not(ms['wpt_device_ms'])} ms "
        f"on the device (k={ms['split']}, top {ms['top']}), plain {ms['wpt_plain_ms']:.4f} ms")
    return {"dcnn_losses": losses, "wpt_launches": counts, "ast_tokens": tokens,
            "ast_losses": ast_losses, "mha_launches": mha, "ast_step_ms": step_ms,
            "ast_step_profile": step_prof, "kernel4_share_of_device": share,
            "wpt_long": ms}


# ------------------------------------------------------ the CNNs in bf16 (21)


@contextlib.contextmanager
def launch_dtypes(targets):
    """Record the type of ``x``, the first argument, that each launcher of
    ``targets`` (``(module, function name, key)``) is given in the block."""
    seen = {key: set() for _, _, key in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def spy(fn, key):
        def call(x, *rest, **kw):
            seen[key].add(str(x.dtype).split(".")[-1])
            return fn(x, *rest, **kw)
        return call

    for (mod, name, fn), (_, _, key) in zip(saved, targets):
        setattr(mod, name, spy(fn, key))
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_bf16(wpt_cuda, fused_cuda, pool_cuda, conv2_cuda, root: str, data: str,
               fp32_unfused_losses):
    """Phase 21: the DCNN with all three flags and the LCNN with its fused
    block trained in bf16 (``dtype: bfloat16``, float32 Adam) through
    ``run_experiment`` on the card, each against the same model unfused in
    bf16, loss by loss; every launch counted and the type of every launch's
    ``x`` read over exactly each run.  ``fp32_unfused_losses``: phase 7's
    unfused float32 run from the same seed, beside which the bf16 losses
    are reported."""
    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
    from audiodeepfake_detection_tpu_torch.train.experiment import run_experiment
    from audiodeepfake_detection_tpu_torch.train.predict import make_score_fn

    counters = {
        "conv1_fwd": (fused_cuda, "FWD_LAUNCHES"), "conv1_bwd": (fused_cuda, "BWD_LAUNCHES"),
        "mfm_fwd": (fused_cuda, "MFM_FWD_LAUNCHES"), "mfm_bwd": (fused_cuda, "MFM_BWD_LAUNCHES"),
        "pool_fwd": (pool_cuda, "POOL_FWD_LAUNCHES"), "pool_bwd": (pool_cuda, "POOL_BWD_LAUNCHES"),
        "conv2_fwd": (conv2_cuda, "CONV2_FWD_LAUNCHES"),
        "conv2_bwd": (conv2_cuda, "CONV2_BWD_LAUNCHES"),
    }
    launchers = [(fused_cuda, "forward", "conv1_fwd"), (fused_cuda, "backward", "conv1_bwd"),
                 (fused_cuda, "mfm_forward", "mfm_fwd"), (fused_cuda, "mfm_backward", "mfm_bwd"),
                 (pool_cuda, "forward", "pool_fwd"), (pool_cuda, "backward", "pool_bwd"),
                 (conv2_cuda, "forward", "conv2_fwd"), (conv2_cuda, "backward", "conv2_bwd")]
    steps = EPOCHS * STEPS_PER_EPOCH

    def run(name, args, want, packets: bool):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        wpt_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        with launch_dtypes(launchers) as seen:
            trainer = run_experiment(args)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        losses = [row[2] for row in trainer.loss_list]
        dtypes = {k: sorted(v) for k, v in seen.items() if v}
        log(f"  {name}: losses {['%.6f' % v for v in losses]}, test {trainer.test_results}, "
            f"launches {counts}, kernels given {dtypes}, {wall:.1f} s wall")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"{name} losses: {losses}")
        if counts != {k: want.get(k, 0) for k in counters}:
            raise AssertionError(f"{name} launch counts {counts}, want {want}")
        if any(v != ["bfloat16"] for v in dtypes.values()) or set(dtypes) != set(want):
            raise AssertionError(f"{name}: the kernels were given {dtypes}")
        if packets and wpt_cuda.LAUNCHES < steps:
            raise AssertionError(f"{name}: {wpt_cuda.LAUNCHES} WPT launches")
        model = trainer.model
        if model.dtype != torch.bfloat16 or trainer.device.type != "cuda":
            raise AssertionError(f"{name} left the bf16 mode or the card")
        if any(v.dtype == torch.bfloat16 for v in model.state_dict().values()):
            raise AssertionError(f"{name}: a parameter or buffer is stored in bf16")
        acc, eer = trainer.test_results[:2]
        if not (0.0 <= acc <= 1.0 and 0.0 <= eer <= 1.0):  # NaN fails too
            raise AssertionError(f"{name} test results {trainer.test_results}")
        return trainer, {"launches": counts, "dtypes": dtypes, "losses": losses, "wall_s": wall}

    out = {"steps": steps}
    per_run = {k: steps for k in ("conv1_fwd", "conv1_bwd", "pool_fwd", "pool_bwd",
                                  "conv2_fwd", "conv2_bwd")}
    no_dropout = dict(dropout_cnn=0.0, dropout_lstm=0.0)
    trainer, out["dcnn"] = run("DCNN, bf16, all three flags", train_args(
        root, data, "log_bf16_dcnn", dtype="bfloat16", fused_pool=True, fused_layer2=True,
        **no_dropout), per_run, packets=True)
    # make_score_fn on the bf16 model object scores as the trainer's eval step
    clip = (0.3 * np.tanh(np.random.RandomState(17).randn(4, 1, SR))).astype(np.float32)
    audio = torch.from_numpy(clip).cuda()
    own = trainer.eval_step({"audio": audio, "label": torch.zeros(
        4, dtype=torch.int32, device="cuda")})["scores"]
    scored = make_score_fn(trainer.model, trainer.transform, "cuda")(audio)
    out["dcnn"]["scorer_vs_eval_step"] = (scored - own).abs().max().item()
    if out["dcnn"]["scorer_vs_eval_step"] != 0.0:
        raise AssertionError(f"bf16 scorer vs eval step: {out['dcnn']['scorer_vs_eval_step']}")
    del trainer
    _, out["dcnn_unfused"] = run("DCNN, bf16, unfused", train_args(
        root, data, "log_bf16_dcnn_unfused", dtype="bfloat16", fused_layer1=False,
        **no_dropout), {}, packets=True)
    _, out["lcnn"] = run("LCNN, bf16, fused block", lcnn_args(
        root, data, "log_bf16_lcnn", model="modules", dtype="bfloat16",
        module=lambda _args: LCNN(fused_layer1=True, dropout=0.0, dtype=torch.bfloat16)),
        {"mfm_fwd": steps, "mfm_bwd": steps}, packets=False)
    _, out["lcnn_unfused"] = run("LCNN, bf16, unfused", lcnn_args(
        root, data, "log_bf16_lcnn_unfused", model="modules", dtype="bfloat16",
        module=lambda _args: LCNN(fused_layer1=False, dropout=0.0, dtype=torch.bfloat16)),
        {}, packets=False)

    def worst(a, b):
        return max(abs(u - v) / abs(v) for u, v in zip(a, b))

    for model in ("dcnn", "lcnn"):
        diff = worst(out[model]["losses"], out[f"{model}_unfused"]["losses"])
        out[f"{model}_loss_rel_diff"] = diff
        log(f"  {model} bf16 fused vs unfused: worst rel diff {diff:.2e} (tol {BF16_LOSS_RTOL})")
        if not diff <= BF16_LOSS_RTOL:
            raise AssertionError(f"bf16 {model} fused vs unfused losses differ by {diff}")
    out["dcnn_unfused_vs_fp32_rel_diff"] = worst(out["dcnn_unfused"]["losses"],
                                                 fp32_unfused_losses)
    log(f"  DCNN unfused, bf16 against phase 7's float32 run: worst rel diff "
        f"{out['dcnn_unfused_vs_fp32_rel_diff']:.2e} (reported)")
    return out


def bf16_cases(fc, fp, f2):
    """The bf16 path's arguments to kernels 2, 3, 5 and 6 at its shapes, in
    the types the models hand over: ``{kernel: (fused fn, plain fn, args,
    the arguments with gradients, cotangents, gradient names)}``."""
    bf16 = torch.bfloat16
    x, params, cot = fused_case(fc, *TRAIN_SHAPE, bf16, seed=110)
    cases = {"conv1": (fc.fused_conv1_prelu_pool_stats, fc.plain_conv1_prelu_pool_stats,
                       [x, *params], params, cot, ("dW", "db", "dalpha"))}
    x, params, g = mfm_case(*LCNN_SHAPE, bf16, seed=111)
    cases["mfm"] = (fc.fused_conv_mfm_pool, fc.plain_conv_mfm_pool, [x, *params], params, [g],
                    ("dW", "db"))
    # the third pool (no moments: a dropout follows it) with the float32 slope
    (x, _), cot = pool_case(*POOL3_SHAPE, bf16, 0.25, seed=112)
    alpha = torch.tensor([PATH_SLOPE], device="cuda", requires_grad=True)
    cases["pool"] = (fp.fused_prelu_pool, fp.plain_prelu_pool, [x, alpha], [x, alpha],
                     cot[:1], ("dx", "dalpha"))
    args, cot = conv2_case(*CONV2_SHAPE, bf16, 0.25, seed=113)
    cases["conv2"] = (f2.fused_conv2_prelu_pool_stats, f2.plain_conv2_prelu_pool_stats, args,
                      args, cot, ("dx", "dw", "dcorr", "dalpha"))
    return cases


def bf16_vs_plain(fc, fp, f2):
    """Phase 21: kernels 2, 3, 5 and 6 against their plain versions in bf16
    at the bf16 path's shapes and argument types, and against themselves;
    the tolerances of phases 6, 10 and 14's bf16 cases."""
    out = {}
    for name, (fused_fn, plain_fn, args, wrt, cot, names) in bf16_cases(fc, fp, f2).items():
        def outs(fn):
            got = fn(*args)
            return got if isinstance(got, tuple) else (got,)

        runs = []
        for _ in range(2):
            got = outs(fused_fn)
            runs.append((*got, *torch.autograd.grad(got, wrt, cot)))
        want = outs(plain_fn)
        pgrads = torch.autograd.grad(want, wrt, cot)
        torch.cuda.synchronize()
        codes = None
        if name == "conv2":  # checks (a) and (c)'s near-tie rule, as phase 14
            codes, pgrads = conv2_near_tie_rule(f2, args, cot, pgrads)
        n_out = len(want)
        got, grads = runs[0][:n_out], runs[0][n_out:]
        bitwise = all(torch.equal(u, v) for u, v in zip(*runs))
        fwd_err = (got[0].float() - want[0].float()).abs().max().item()
        fwd_tol = want[0].float().abs().max().item() * 2.0 ** -7
        sums = {n: rel_err(u, v) for n, u, v in zip(("sum", "sumsq"), got[1:], want[1:])}
        gerr = {n: rel_err(u, v) for n, u, v in zip(names, grads, pgrads)}
        # float32 corr keeps a float32 dcorr; kernel 6's dalpha comes from
        # the stored bf16 output (phase 14)
        tols = {n: MID_SUM_RTOL if n == "dcorr" else FUSED_BF16_RTOL for n in names}
        if name == "conv2":
            tols["dalpha"] = MID_BF16_DALPHA_RTOL
        out[name] = {
            "fwd_max_abs_err": fwd_err, "moments_rel_err": sums, "grad_rel_err": gerr,
            # of dW (kernels 2 and 3) or dx (kernels 5 and 6)
            "grad_max_abs_err": (grads[0].float() - pgrads[0].float()).abs().max().item(),
            "bitwise_repeat": bitwise, "x": list(args[0].shape),
            "types": [str(a.dtype).split(".")[-1] for a in args],
        }
        if name == "conv2":
            out[name]["dw_max_abs_err"] = (grads[1].float() - pgrads[1].float()).abs().max().item()
            out[name]["codes"] = codes
        log(f"  {name} {out[name]['x']} {out[name]['types']}: out max|err| {fwd_err:.3e} (tol "
            f"{fwd_tol:.1e}), moments rel {sums}, grads rel {gerr}, repeat bit-equal {bitwise}"
            + ("" if codes is None else f"; codes {codes}"))
        if not (fwd_err <= fwd_tol and all(v <= MID_SUM_RTOL for v in sums.values())
                and all(gerr[n] <= tols[n] for n in names)):
            raise AssertionError(f"bf16 {name} vs plain: {out[name]}")
        if not bitwise:
            raise AssertionError(f"bf16 {name}: two runs differ")
        del runs, grads, pgrads, got, want
    return out


def bf16_timing(fc, fused_cuda, fp, pool_cuda, f2, conv2_cuda, norm, lcnn_norm, card_line: str):
    """Phase 21: kernels 2, 3, 5 and 6 in bf16 at the path's shapes through
    their launchers and as device time, against plain and their bf16
    bounds; the DCNN step (b) and the fused LCNN step in float32 and bf16;
    ``make_score_fn`` on a float32 and a bf16 DCNN object at B = 64 and
    128."""
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.train.predict import make_score_fn
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    cases = bf16_cases(fc, fp, f2)
    out = {}
    # conv1: x, w, b, alpha as the glue hands them to the launchers
    x, *params = cases["conv1"][2]
    cot = cases["conv1"][4]
    raw = [p.detach().float() for p in params]
    code = fused_cuda.forward(x, *raw, True, True)[1]
    kernels = {"conv1": dict(
        fwd=lambda: fused_cuda.forward(x, *raw, True, True),
        bwd=lambda: fused_cuda.backward(x, *raw, cot[0], code, cot[1], cot[2]),
        fwd_keys={"k": "fused_conv1_fwd_kernel"}, bwd_keys={"k": "fused_conv1_bwd_kernel"},
        bounds=fused_bounds(*TRAIN_SHAPE, itemsize=2, flop_per_s=BF16_FLOP_PER_S))}
    mx, *mparams = cases["mfm"][2]
    mg = cases["mfm"][4][0]
    mraw = [p.detach().float() for p in mparams]
    mcode = fused_cuda.mfm_forward(mx, *mraw, True)[1]
    kernels["mfm"] = dict(
        fwd=lambda: fused_cuda.mfm_forward(mx, *mraw, True),
        bwd=lambda: fused_cuda.mfm_backward(mx, mg, mcode, LCNN_SHAPE[3]),
        fwd_keys={"k": "fused_conv_mfm_fwd_kernel"},
        bwd_keys={"k": "fused_conv_mfm_bwd_kernel", "sum": "fused_conv_mfm_sum_kernel"},
        bounds=mfm_bounds(*LCNN_SHAPE, itemsize=2, flop_per_s=BF16_FLOP_PER_S))
    px, palpha = cases["pool"][2]
    pg = cases["pool"][4][0]
    praw = (px.detach(), palpha.detach())
    py, pcode, _, _ = pool_cuda.forward(*praw, True, False)
    kernels["pool"] = dict(
        fwd=lambda: pool_cuda.forward(*praw, True, False),
        bwd=lambda: pool_cuda.backward(*praw, pg, py, pcode, None, None),
        fwd_keys={"k": "fused_pool_fwd_kernel"}, bwd_keys={"k": "fused_pool_bwd_kernel"},
        bounds=pool_bounds(*POOL3_SHAPE, int((pcode >= 4).sum()), itemsize=2,
                           flop_per_s=BF16_FLOP_PER_S))
    cx, cw, ccorr, calpha = cases["conv2"][2]
    ccot = cases["conv2"][4]
    craw = (cx.detach(), cw.detach().float(), ccorr.detach().float(), calpha.detach().float())
    cy, ccode, _, _ = conv2_cuda.forward(*craw, True, True)
    conv2_bwd_keys = {"dx": "fused_conv2_dx_bf16_kernel", "dw": "fused_conv2_dw_bf16_kernel",
                      "small": "fused_conv2_small_kernel"}
    kernels["conv2"] = dict(
        fwd=lambda: conv2_cuda.forward(*craw, True, True),
        bwd=lambda: conv2_cuda.backward(*craw, ccot[0], cy, ccode, ccot[1], ccot[2]),
        fwd_keys={"k": "fused_conv2_fwd_bf16_kernel"}, bwd_keys=conv2_bwd_keys,
        bounds=conv2_bounds(*CONV2_SHAPE, itemsize=2, flop_per_s=BF16_FLOP_PER_S)[:2])
    for name, k in kernels.items():
        fused_fn, plain_fn, args, wrt, cot_, _ = cases[name]
        graph = plain_fn(*args)
        reps = 5 if name == "conv2" else 10
        fwd = median_ms({"plain": lambda: plain_fn(*args), "kernel": k["fwd"]}, reps=reps)
        bwd = median_ms({
            "plain": lambda: torch.autograd.grad(graph, wrt, cot_, retain_graph=True),
            "kernel": k["bwd"]}, reps=reps)
        dev_fwd, dev_bwd = (call_device_ms(k[way], k[f"{way}_keys"]) for way in ("fwd", "bwd"))
        (fb, fby), (bb, bby) = k["bounds"]
        out[name] = {"fwd_kernel_ms": fwd["kernel"], "fwd_plain_ms": fwd["plain"],
                     "fwd_device_ms": dev_fwd, "fwd_bound_ms": fb, "fwd_bound_by": fby,
                     "bwd_kernel_ms": bwd["kernel"], "bwd_plain_ms": bwd["plain"],
                     "bwd_device_ms": dev_bwd, "bwd_bound_ms": bb, "bwd_bound_by": bby}
        log(f"  kernel {name}, bf16 [{card_line}]: fwd {fwd['kernel']:.4f} ms through the "
            f"launcher, {ms_or_not(dev_fwd)} ms device, plain {fwd['plain']:.4f} ms, bound "
            f"{fb:.4f} ms ({fby}); bwd {bwd['kernel']:.4f} ms, {ms_or_not(dev_bwd)} ms device, "
            f"plain "
            f"{bwd['plain']:.4f} ms, bound {bb:.4f} ms ({bby})")
        del graph
    out["conv2"].update(conv2_bf16_yardstick(kernels["conv2"]["bwd"], conv2_bwd_keys, craw,
                                             ccot[0], card_line))
    del kernels, cases

    flags = dict(fused_pool=True, fused_layer2=True)
    fns = {"dcnn_b_fp32": step_fns(norm, True, **flags),
           "dcnn_b_bf16": step_fns(norm, True, dtype=torch.bfloat16, **flags),
           "lcnn_fp32": lcnn_step_fns(lcnn_norm, True),
           "lcnn_bf16": lcnn_step_fns(lcnn_norm, True, dtype=torch.bfloat16)}
    steps = median_ms({name: fn[0] for name, fn in fns.items()}, reps=3)
    evals = median_ms({name: fn[1] for name, fn in fns.items()}, reps=3)
    out["train_step_ms"] = steps
    out["eval_step_ms"] = evals
    out["train_frames_per_s"] = {k: BATCH / v * 1e3 for k, v in steps.items()}
    log(f"  [{card_line}] train step: " + ", ".join(
        f"{k} {v:.3f} ms ({BATCH / v * 1e3:.1f} frames/s)" for k, v in steps.items()))
    log("  eval step: " + ", ".join(f"{k} {v:.3f} ms" for k, v in evals.items()))

    args = train_args("", "", "")
    transform = normalized_transform(make_transform(args), *[np.asarray(v) for v in norm])
    scorers = {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        torch.manual_seed(0)
        scorers[name] = make_score_fn(DCNN(time_dim=12, dtype=dtype), transform, "cuda")
    gen = torch.Generator().manual_seed(19)
    out["scorer_ms"] = {}
    for b in (64, 128):
        audio = (0.3 * torch.randn(b, 1, SR, generator=gen)).cuda()
        sms = median_ms({name: (lambda fn=fn: fn(audio)) for name, fn in scorers.items()}, reps=5)
        diff = (scorers["bf16"](audio) - scorers["fp32"](audio)).abs().max().item()
        out["scorer_ms"][b] = {**sms, "p_fake_bf16_vs_fp32": diff,
                               **{f"{k}_frames_per_s": b / v * 1e3 for k, v in sms.items()}}
        log(f"  scorer B={b}: fp32 {sms['fp32']:.3f} ms, bf16 {sms['bf16']:.3f} ms "
            f"({b / sms['bf16'] * 1e3:.1f} frames/s); max |P(fake) bf16 - fp32| {diff:.3e}")
    return out, {"dcnn_b_bf16": fns["dcnn_b_bf16"][0], "lcnn_bf16": fns["lcnn_bf16"][0]}



def conv2_bf16_yardstick(backward, bwd_keys, raw, g, card_line: str) -> dict:
    """Phase 21: kernel 6's bf16 backward as its dx, dw and dcorr / dalpha
    kernels' device time (a profile), and, as a yardstick, cuDNN's bf16
    convolution of the same conv alone at ``CONV2_SHAPE``: forward,
    ``conv2d_input`` and ``conv2d_weight`` through ``median_ms``.  Not the
    same function (no corr, PReLU, pool, code, moments; a dense cotangent):
    a measure of what the card's library does with the same products."""
    import torch.nn.functional as F

    x, w = raw[0], raw[1]
    _, c_in, c_out, h, win = CONV2_SHAPE
    weight = w.view(3, 3, c_in, c_out).permute(3, 2, 0, 1).contiguous().bfloat16()
    d = F.interpolate(g.float(), scale_factor=2).bfloat16()
    d = F.pad(d, (0, win - d.shape[-1], 0, h - d.shape[-2]))
    lib = median_ms({
        "fwd": lambda: F.conv2d(x, weight, padding=1),
        "dgrad": lambda: torch.nn.grad.conv2d_input(x.shape, weight, d, padding=1),
        "wgrad": lambda: torch.nn.grad.conv2d_weight(x, weight.shape, d, padding=1),
    }, reps=5)
    apart = kernel_device_ms(backward, bwd_keys)
    log(f"  kernel 6 bf16 backward's kernels, device time [{card_line}]: " + ", ".join(
        f"{k} {ms_or_not(v)} ms" for k, v in apart.items()) + "; cuDNN bf16 conv alone "
        f"(yardstick, not the same function): fwd {lib['fwd']:.4f}, conv2d_input "
        f"{lib['dgrad']:.4f}, conv2d_weight {lib['wgrad']:.4f} ms")
    return {"bwd_device_apart_ms": apart, "cudnn_bf16_fwd_ms": lib["fwd"],
            "cudnn_bf16_dgrad_ms": lib["dgrad"], "cudnn_bf16_wgrad_ms": lib["wgrad"]}


def bf16_rows(run, errs, times):
    """The ``kernels`` rows of kernels 2, 3, 5 and 6 in bf16 on phase 21's
    path: launches from its bf16 runs, errors and times from its checks."""
    src = "audiodeepfake_detection_tpu_torch/csrc/"
    table = (
        ("fused_conv1", "conv1", "dcnn", "fused_conv1.cu", "fused_conv1.py:376",
         "fused_conv1.py:472"),
        ("fused_conv_mfm", "mfm", "lcnn", "fused_conv1.cu", "fused_conv1.py:756",
         "fused_conv1.py:806"),
        ("fused_pool", "pool", "dcnn", "fused_pool.cu", "fused_pool.py:197",
         "fused_pool.py:241"),
        ("fused_conv2", "conv2", "dcnn", "fused_conv2.cu", "fused_conv2.py:323",
         "fused_conv2.py:383"),
    )
    # kernel 6's bf16 route (PR 22): its own tensor-core kernels
    conv2_kernels = {
        "fwd": "fused_conv2_fwd_bf16_kernel (mma.sync m16n8k16, epilogue in registers)",
        "bwd": "fused_conv2_dx_bf16_kernel + fused_conv2_dw_bf16_kernel (mma.sync m16n8k16, "
               "d rounded to bf16) + fused_conv2_small_kernel"}
    rows = []
    for name, key, model, source, fwd_line, bwd_line in table:
        t = times[key]
        for way, line, err in (("fwd", fwd_line, errs[key]["fwd_max_abs_err"]),
                               ("bwd", bwd_line, errs[key]["grad_max_abs_err"])):
            rows.append({
                "name": f"{name}_{way}_bf16", "route": "cuda", "source": src + source,
                "replaces": f"audiodeepfake_detection_tpu/ops/{line}", "dtype": "bfloat16",
                "x": errs[key]["x"], "launches": run[model]["launches"][f"{key}_{way}"],
                "max_abs_err": err, "ms": t[f"{way}_kernel_ms"], "plain_ms": t[f"{way}_plain_ms"],
                "device_ms": t[f"{way}_device_ms"], "bound_ms": t[f"{way}_bound_ms"],
                "bound_by": t[f"{way}_bound_by"], "library_ms": None,
            })
            if key == "conv2":
                rows[-1]["kernel"] = conv2_kernels[way]
    return rows

# ---- phase 22: post-training int8


def int8_bound(b, cin, cout, k, pad, dil, h, w, itemsize=4, folded=True):
    """A whole int8 site's least time: the working-type activation read
    once, the weight codes and scales once, the map (folded sites) and the
    bias once, the output written once in the working type; 2 operations
    per product of the true K (no padding) at the int8 rate.  The codes
    never leave the chip."""
    ho, wo = h + 2 * pad - dil * (k - 1), w + 2 * pad - dil * (k - 1)
    n_bytes = (b * cin * h * w * itemsize + cout * cin * k * k + 4 * cout
               + (cout * ho * wo * itemsize if folded else 0) + cout * itemsize
               + b * cout * ho * wo * itemsize)
    return bound_ms(n_bytes, 2.0 * b * ho * wo * cout * cin * k * k, INT8_FLOP_PER_S)


def int8_device_ms(icc, x, scale, rec, const, bias, pad: int, dil: int, n: int = 20) -> float:
    """Device ms per launch of the int8 kernel: CUDA events around ``n``
    launches (baked layout, output allocated once) queued behind a spin of
    the card, so they run back to back and the launcher's host work is not
    in the time.  (Not a profile: in one run eight profiles in a row kept
    no record of this kernel at the DCNN's cnn_4.)  A whole site, or, where
    ``x`` is int8 NHWC codes, the codes-in mode (``scale``: the ``[Cout]``
    dequantizing scale; float32 out; ``const`` and ``bias`` unread)."""
    cout, k = rec["w_q"].shape[0], rec["w_q"].shape[2]
    codes_in = x.dtype == torch.int8
    if codes_in:
        b, h, w, cin = x.shape
    else:
        b, cin, h, w = x.shape
    plan = icc.plan_for(x, cout, k, pad, dil)
    ho, wo = icc.output_plane(h, w, k, pad, dil)
    out = torch.empty((b, cout, ho, wo), dtype=torch.float32 if codes_in else x.dtype,
                      device=x.device)

    def run():
        if codes_in:
            icc.launch(x, rec["rows"], scale, None, None, out, (b, h, w, cin), k, pad, dil,
                       plan, 1.0, 1.0)
        else:
            icc.launch(x, rec["rows"], rec["s_w"], const, bias, out, (b, h, w, cin), k, pad,
                       dil, plan, 1.0 / max(float(scale), 1e-30), float(scale))

    times = []
    for _ in range(3):
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues all n launches meanwhile
        start.record()
        for _ in range(n):
            run()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / n)
    return statistics.median(times)


def int8_case(gen, b, cin, cout, k, h, w):
    """Random codes over the whole int8 range and per-channel scales."""
    x_q = torch.randint(-127, 128, (b, h, w, cin), generator=gen, dtype=torch.int8).cuda()
    w_q = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, dtype=torch.int8).cuda()
    scale = (torch.rand(cout, generator=gen) * 1e-4 + 1e-6).cuda()
    return x_q, w_q, scale


def int8_site_case(gen, b, cin, cout, k, pad, dil, h, w, dtype, folded=True,
                   transposed=False):
    """A whole site: a working-type activation (``transposed``: a view of
    ``[B, Cin, W, H]`` memory, as the models hand their first site), its
    calibrated scale, a baked record of random float32 weights
    (``conv_site_record``), the fold's map (folded sites) and a bias in
    ``dtype``."""
    from audiodeepfake_detection_tpu_torch.ops.quantize import conv_site_record

    ho, wo = h + 2 * pad - dil * (k - 1), w + 2 * pad - dil * (k - 1)
    if transposed:
        x = torch.randn(b, cin, w, h, generator=gen).cuda().to(dtype).permute(0, 1, 3, 2)
    else:
        x = torch.randn(b, cin, h, w, generator=gen).cuda().to(dtype)
    w32 = (torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** 0.5).cuda()
    const = (0.1 * torch.randn(cout, ho, wo, generator=gen)).cuda().to(dtype) if folded else None
    bias = (0.1 * torch.randn(cout, generator=gen)).cuda().to(dtype)
    scale = float(x.float().abs().max()) / 127.0
    return x, scale, conv_site_record(w32, const), const, bias


def int8_cases():
    """``(name, site, B, Cin, Cout, k, padding, dilation, H, W)`` of every
    geometry phase 22 checks: the DCNN sites at B = 64 and 128, the LCNN
    sites at B = 128, the dilated sites and an odd plane."""
    cases = [(f"dcnn-{site}-B{b}", site, b, *geo)
             for b in (64, 128) for site, geo in INT8_DCNN_SITES.items()]
    cases += [(f"lcnn-{site}-B128", site, 128, *geo) for site, geo in INT8_LCNN_SITES.items()]
    return cases + [(name, name, *geo) for name, geo in INT8_EXTRA_CASES.items()]


def int8_vs_plain(ic, icc):
    """Phase 22, first: the int8 kernel against its plain version at every
    geometry of :func:`int8_cases`: whole sites (float32 and bf16; the map
    at folded sites) and the codes-in mode (int32 accumulators, float32 and
    bf16 outputs), each bit-equal to plain, a repeat the same bits, one
    launch a call; then the tensor-core (IMMA) and dp4a (IDP) instructions
    of each compiled variant."""
    import re

    gen = torch.Generator().manual_seed(22)
    errs = {}

    def check(name, fn, want, counter):
        before = getattr(icc, counter)
        got, again = fn(), fn()
        torch.cuda.synchronize()
        if getattr(icc, counter) - before != 2 or not torch.equal(got, again):
            raise AssertionError(f"int8 {name}: launches or repeats")
        err = 0.0 if torch.equal(got, want) else (got.double() - want.double()).abs().max().item()
        errs[name] = err
        if err != 0.0 or got.dtype != want.dtype:
            raise AssertionError(f"int8 {name}: max|kernel - plain| {err}, {got.dtype}")

    cases = int8_cases()
    for name, site, b, cin, cout, k, pad, dil, h, w in cases:
        folded = site not in INT8_UNFOLDED
        for dt in (torch.float32, torch.bfloat16):
            x, scale, rec, const, bias = int8_site_case(gen, b, cin, cout, k, pad, dil, h, w, dt,
                                                        folded, site in INT8_TRANSPOSED)
            want = ic.int8_conv_site_plain(x, scale, rec["w_q"], rec["s_w"], const, bias, pad, dil)
            check(f"site-{name}-{str(dt)[6:]}",
                  lambda: ic.int8_conv_site(x, scale, rec, pad, dil, const=const, bias=bias),
                  want, "SITE_LAUNCHES")
            del x, rec, want
        x_q, w_q, scale = int8_case(gen, b, cin, cout, k, h, w)
        acc = ic.int8_conv_plain(x_q, w_q, None, pad, dil, torch.int32)
        for dt in (torch.int32, torch.float32, torch.bfloat16):
            want = acc if dt == torch.int32 else ic.dequantize(acc, scale, dt)
            check(f"{name}-{str(dt)[6:]}", lambda: ic.int8_conv(x_q, w_q, scale, pad, dil, dt),
                  want, "LAUNCHES")
        del acc, want
    log(f"  {len(cases)} geometries: whole sites (float32, bfloat16) and codes in (int32, "
        "float32, bfloat16) bit-equal to plain, repeats the same bits")
    counts = {}
    for mangled, ops in sass_opcodes(icc._LIB).items():
        hit = re.search(r"int8_site_(mma|cin1)_kernelILi(\d)E(f|i|13__nv_bfloat16)Li(\d)E", mangled)
        if hit:
            route, kind, out, n = hit.groups()
            key = f"{route}-{('f32', 'bf16', 's8')[int(kind)]}-{dict(f='f32', i='s32').get(out, 'bf16')}-{n}"
            counts[key] = ops["IMMA" if route == "mma" else "IDP"]
    log(f"  IMMA (MMA route) / IDP (Cin = 1 route) instructions per variant: {counts}")
    mma = [v for key, v in counts.items() if key.startswith("mma")]
    cin1 = [v for key, v in counts.items() if key.startswith("cin1")]
    if len(mma) != 20 or len(cin1) != 15 or min(mma + cin1) <= 0:
        raise AssertionError(f"int8 kernel instructions: {counts}")
    return errs, counts


def int8_site_spy(icc, sites: dict):
    """Patch the site launcher to count launches per site, the site told by
    its geometry (Cin, Cout, k, dilation, H, W), and the launches that had
    to lay the weights out (no baked layout); returns ``(counts, restore)``
    (``counts["unbaked"]``: those launches)."""
    launch = icc.site_forward
    by_geo = {(g[0], g[1], g[2], g[4], g[5], g[6]): site for site, g in sites.items()}
    counts = {site: 0 for site in sites}
    counts["unbaked"] = 0

    def spy(x, act_scale, w_q, s_w, rows, const, bias, padding, dilation):
        b, cin, h, w = x.shape
        key = (cin, w_q.shape[0], w_q.shape[2], dilation, h, w)
        if key not in by_geo:
            raise AssertionError(f"an int8 launch at no known site: {key}")
        counts[by_geo[key]] += 1
        counts["unbaked"] += rows is None
        return launch(x, act_scale, w_q, s_w, rows, const, bias, padding, dilation)

    icc.site_forward = spy

    def restore():
        icc.site_forward = launch

    return counts, restore


def int8_drift(name: str, q, fp) -> float:
    """JAX's budget on P(fake): within ``INT8_DRIFT`` of fp32, and the fp32
    decision kept wherever fp32 lies more than ``INT8_DRIFT`` from 0.5."""
    q, fp = np.asarray(q, np.float64), np.asarray(fp, np.float64)
    drift = float(np.abs(q - fp).max())
    flips = int(((np.abs(fp - 0.5) > INT8_DRIFT) & ((q > 0.5) != (fp > 0.5))).sum())
    log(f"  {name}: {q.size} scores, max |int8 - fp32| {drift:.3e}, decisions flipped {flips}")
    if not drift < INT8_DRIFT or flips:
        raise AssertionError(f"{name}: int8 drift {drift}, {flips} decisions flipped")
    return drift


def calibration_clips(data: str, n: int) -> list:
    """``n`` corpus clips of each label, interleaved, so that the first
    calibration batches hold both."""
    dirs = [os.path.join(data, d) for d in ("A_ljspeech", "B_fbmelgan")]
    files = [sorted(os.path.join(d, f) for f in os.listdir(d))[:n] for d in dirs]
    return [p for pair in zip(*files) for p in pair]


def serve_int8(wpt_cuda, icc, snapshot: str, data: str):
    """Phase 22: phase 7's trained DCNN behind ``service_from_snapshot(int8=True,
    calibrate=<corpus clips>)`` on ``cuda`` over HTTP, the WPT's and the int8
    convolution's launches (per site) counted over exactly the requests; the
    scores held against the same int8 model (the card's scales) on the CPU and
    against the snapshot scored in float32 on the card."""
    from audiodeepfake_detection_tpu_torch.ops.quantize import (
        DEFAULT_INT8_SITES, bake_int8_weights, with_quant)
    from audiodeepfake_detection_tpu_torch.train.predict import (
        build_scorer_from_snapshot, make_score_fn)
    from audiodeepfake_detection_tpu_torch.train.serve import service_from_snapshot

    clips = [(1.0, SR), (2.5, SR), (5.0, SR), (2.0, 2 * SR)]
    rng = np.random.RandomState(23)
    pcms = [rng.randint(-12000, 12000, int(s * r)).astype(np.int16) for s, r in clips]
    t0 = time.perf_counter()
    svc = service_from_snapshot(snapshot, device="cuda", batch_size=64, int8=True,
                                calibrate=calibration_clips(data, 14))
    build_s = time.perf_counter() - t0
    scales = svc.model.quant
    if sorted(scales) != sorted(DEFAULT_INT8_SITES):
        raise AssertionError(f"int8 DCNN sites: {sorted(scales)}")
    model, transform, _ = build_scorer_from_snapshot(snapshot)
    fp32 = make_score_fn(model, transform, "cuda")
    cpu_model, cpu_transform, _ = build_scorer_from_snapshot(snapshot)
    cpu_q = with_quant(cpu_model.eval(), dict(scales))
    bake_int8_weights(cpu_q, cpu_transform(torch.zeros(1, 1, SR)))
    cpu_score = make_score_fn(cpu_q, cpu_transform, "cpu")
    counts, restore = int8_site_spy(icc, INT8_DCNN_SITES)
    launched = {}

    def reset():
        wpt_cuda.LAUNCHES = icc.LAUNCHES = icc.SITE_LAUNCHES = 0
        for site in counts:
            counts[site] = 0

    def read():
        launched["int8"] = icc.SITE_LAUNCHES
        launched["codes_in"] = icc.LAUNCHES
        return wpt_cuda.LAUNCHES

    try:
        out = serve_service(svc, cpu_score, clips, pcms, reset, read, atol=INT8_CPU_ATOL)
    finally:
        restore()
    d = out["dispatches"]
    unbaked = counts.pop("unbaked")
    out.update(int8_launches=launched["int8"], site_launches=dict(counts),
               scales=dict(scales), service_build_s=build_s)
    log(f"  int8 site launches {launched['int8']} ({counts}), {unbaked} without the baked "
        f"layout, codes-in launches {launched['codes_in']}, for {d} dispatches; service built "
        f"(calibrated, baked, warmed up) in {build_s:.1f} s")
    if (launched["int8"] != 6 * d or set(counts.values()) != {d} or unbaked
            or launched["codes_in"]):
        raise AssertionError(f"int8 launches {launched} {counts} ({unbaked} unbaked) for {d} "
                             "dispatches")
    q, f = [], []
    for (sec, rate), pcm, clip in zip(clips, pcms, out["clips"]):
        frames = svc.frame_clip(pcm.astype(np.float32) / 32768.0, rate)
        ref = fp32(torch.from_numpy(frames[:, None, :])).cpu().numpy()
        q += [clip["p_fake"], *clip["frame_scores"]]
        f += [float(ref.mean()), *ref.tolist()]
    out["drift_vs_fp32"] = int8_drift("DCNN over HTTP, int8 vs fp32 on the card", q, f)
    return out


def score_lcnn_int8(icc, snapshot: str, data: str):
    """Phase 22: phase 11's trained LCNN through ``score_files(int8=True)`` on
    ``cuda`` (calibrated on the scored frames, baked), its nine sites'
    launches counted, the scores against ``score_files`` in float32."""
    from audiodeepfake_detection_tpu_torch.train.predict import (
        build_scorer_from_snapshot, score_files)

    paths = calibration_clips(data, 4)
    model, transform, _ = build_scorer_from_snapshot(snapshot)
    fp = score_files(model, transform, paths, "cuda", batch_size=64)
    counts, restore = int8_site_spy(icc, INT8_LCNN_SITES)
    icc.SITE_LAUNCHES = 0
    try:
        q = score_files(model, transform, paths, "cuda", batch_size=64, int8=True)
        torch.cuda.synchronize()
    finally:
        restore()
    # one int8 forward to bake, then the 80 frames in two batches of 64
    unbaked = counts.pop("unbaked")
    log(f"  LCNN int8: {len(paths)} clips, launches {icc.SITE_LAUNCHES} ({counts}), "
        f"{unbaked} without the baked layout")
    if icc.SITE_LAUNCHES != 27 or set(counts.values()) != {3} or unbaked:
        raise AssertionError(f"LCNN int8 launches {icc.SITE_LAUNCHES}: {counts}, {unbaked}")
    drift = int8_drift("LCNN score_files, int8 vs fp32 on the card",
                       [q[p] for p in paths], [fp[p] for p in paths])
    return {"launches": icc.SITE_LAUNCHES, "site_launches": dict(counts),
            "drift_vs_fp32": drift}


def corpus_frames(data: str, n: int) -> np.ndarray:
    """``n`` 1 s frames cut from the corpus clips of both labels."""
    from audiodeepfake_detection_tpu_torch.data.wavio import audio_read

    frames = []
    for path in calibration_clips(data, 28):
        audio, _ = audio_read(path)
        frames += [audio[i * SR:(i + 1) * SR] for i in range(len(audio) // SR)][:2]
        if len(frames) >= n:
            break
    return np.stack(frames[:n]).astype(np.float32)


def ast_int8(fa_cuda, model, transform, data: str):
    """Phase 22: phase 18's trained AST quantized (every block's qkv, proj,
    fc1, fc2) and baked on corpus frames, scored at B = 64: kernel 4's
    launches read over the scoring call, the scores against fp32."""
    from audiodeepfake_detection_tpu_torch.train.predict import (
        make_score_fn, quantize_for_scoring)

    frames = corpus_frames(data, 64)
    audio = torch.from_numpy(frames[:, None, :]).cuda()
    qmodel = quantize_for_scoring(model, transform, list(frames), "cuda", 64)
    sites = sorted(qmodel.quant)
    if len(sites) != 4 * AST_BLOCKS:
        raise AssertionError(f"AST int8 sites: {sites}")
    fp = make_score_fn(model, transform, "cuda")(audio).cpu().numpy()
    score = make_score_fn(qmodel, transform, "cuda")
    fa_cuda.MHA_FWD_LAUNCHES = 0
    q = score(audio).cpu().numpy()
    torch.cuda.synchronize()
    launches = fa_cuda.MHA_FWD_LAUNCHES
    log(f"  AST int8 at B=64: {len(sites)} sites, kernel 4 launched {launches} times")
    if launches != AST_BLOCKS:
        raise AssertionError(f"kernel 4 launched {launches} times in the int8 AST scorer")
    drift = int8_drift("AST int8 vs fp32 on the card, B=64", q, fp)
    return qmodel, {"sites": len(sites), "mha_launches": launches, "drift_vs_fp32": drift}


def int8_site_times(ic, icc, card_line: str, gen) -> dict:
    """Phase 22: each DCNN site at B = 64 and 128 (float32): the site kernel
    through its launcher (the op, baked layout), as device time, and as the
    layer runs it (``folded_bn_conv(act_scale=)`` / ``quantized_conv_bias``
    on a baked record); the codes-in composition it replaced (the quantizing
    pass, the codes-in kernel, ``+ map``, ``+ bias``) and that kernel's
    device time; its fused bound; plain, and cuDNN's float32 / bf16
    convolution of the same shape (a yardstick only)."""
    import torch.nn.functional as F
    from torch import nn

    from audiodeepfake_detection_tpu_torch.models import layers

    out = {}
    for b in (64, 128):
        rows = out[b] = {}
        for site, (cin, cout, k, pad, dil, h, w) in INT8_DCNN_SITES.items():
            folded = site not in INT8_UNFOLDED
            x, scale, rec, const, bias = int8_site_case(gen, b, cin, cout, k, pad, dil, h, w,
                                                        torch.float32, folded,
                                                        site in INT8_TRANSPOSED)
            conv = nn.Conv2d(cin, cout, k, padding=pad, dilation=dil).cuda().eval()
            bn = nn.BatchNorm2d(cin).cuda().eval()
            with torch.no_grad():
                bn.running_mean.uniform_(-0.5, 0.5)
                bn.running_var.uniform_(0.5, 2.0)
            cache = {}

            def baked(make, cache=cache):  # the layer's record, baked on its first call
                if "rec" not in cache:
                    cache["rec"] = make()
                return cache["rec"]

            sx = float(scale) * rec["s_w"]
            fns = {
                "site": lambda: ic.int8_conv_site(x, scale, rec, pad, dil, const=const, bias=bias),
                "layer": (lambda: layers.folded_bn_conv(bn, conv, x, act_scale=scale, baked=baked))
                if folded else (lambda: layers.quantized_conv_bias(conv, x, scale, baked)),
                "codes_in": lambda: (ic.int8_conv(ic.quantize_activation_nhwc(x, scale),
                                                  rec["w_q"], sx, pad, dil)
                                     + (const if folded else 0) + bias.reshape(-1, 1, 1)),
            }
            xb, wb = x.bfloat16(), conv.weight.detach().bfloat16()
            fns.update(
                plain=lambda: ic.int8_conv_site_plain(x, scale, rec["w_q"], rec["s_w"], const,
                                                      bias, pad, dil),
                cudnn_fp32=lambda: F.conv2d(x, conv.weight, padding=pad, dilation=dil),
                cudnn_bf16=lambda: F.conv2d(xb, wb, padding=pad, dilation=dil))
            with torch.no_grad():
                ms = median_ms(fns, reps=5)
            device = int8_device_ms(icc, x, scale, rec, const, bias, pad, dil)
            codes_in_device = int8_device_ms(icc, ic.quantize_activation_nhwc(x, scale), sx, rec,
                                             None, None, pad, dil)
            bound, by = int8_bound(b, cin, cout, k, pad, dil, h, w, folded=folded)
            rows[site] = {**{f"{k_}_ms": v for k_, v in ms.items()}, "device_ms": device,
                          "codes_in_device_ms": codes_in_device, "bound_ms": bound,
                          "bound_by": by}
            log(f"  {site} B={b} [{card_line}]: site {ms['site']:.4f} ms through the launcher, "
                f"{device:.4f} ms device ({bound / device:.0%} of the bound {bound:.4f} ms, "
                f"{by}); as the layer runs it {ms['layer']:.4f}; the codes-in composition "
                f"{ms['codes_in']:.4f} (its kernel {codes_in_device:.4f} device); plain "
                f"{ms['plain']:.4f}; cuDNN fp32 {ms['cudnn_fp32']:.4f}, bf16 "
                f"{ms['cudnn_bf16']:.4f}")
            del x, xb, rec, const, bias, fns
        total = {k_: sum(v[k_] for v in rows.values()) for k_ in next(iter(rows.values()))
                 if k_ != "bound_by"}
        rows["six_sites"] = total
        log(f"  the six sites together, B={b}: " + ", ".join(
            f"{k_} {v:.4f}" for k_, v in total.items()))
    return out


def int8_timing(ic, icc, snapshot: str, lcnn_snapshot: str, ast_model, ast_q, ast_transform,
                card_line: str):
    """Phase 22, last: :func:`int8_site_times`; the DCNN and LCNN scorers in
    float32, bf16 and int8 at B = 64 and 128; the AST scorer in float32,
    bf16 and int8 at B = 64."""
    import copy

    from audiodeepfake_detection_tpu_torch.models.ast import ASTModel
    from audiodeepfake_detection_tpu_torch.train.predict import (
        build_scorer_from_snapshot, make_score_fn, quantize_for_scoring)

    gen = torch.Generator().manual_seed(24)
    out = {"sites": int8_site_times(ic, icc, card_line, gen)}
    audio = {bb: (0.3 * torch.randn(bb, 1, SR, generator=gen)).cuda() for bb in (64, 128)}
    frames = list(audio[128][:, 0].cpu().numpy())
    for name, path in (("dcnn", snapshot), ("lcnn", lcnn_snapshot)):
        model, transform, _ = build_scorer_from_snapshot(path)
        bf = copy.deepcopy(model)
        bf.dtype = torch.bfloat16
        q = quantize_for_scoring(model, transform, frames, "cuda", 64)
        scorers = {"fp32": make_score_fn(model, transform, "cuda"),
                   "bf16": make_score_fn(bf, transform, "cuda"),
                   "int8": make_score_fn(q, transform, "cuda")}
        if name == "dcnn":  # the site launches of one int8 scoring call at B = 128
            counts, restore = int8_site_spy(icc, INT8_DCNN_SITES)
            try:
                scorers["int8"](audio[128])
                torch.cuda.synchronize()
            finally:
                restore()
            out["b128_launches"] = {site: counts[site] for site in INT8_DCNN_SITES}
            log(f"  int8 DCNN scorer, one call at B=128: site launches {counts}")
            if min(out["b128_launches"].values()) != 1 or counts["unbaked"]:
                raise AssertionError(f"int8 DCNN scorer at B=128: launches {counts}")
        out[f"{name}_scorer_ms"] = {}
        for bb, a in audio.items():
            sms = median_ms({k_: (lambda fn=fn: fn(a)) for k_, fn in scorers.items()}, reps=5)
            out[f"{name}_scorer_ms"][bb] = {**sms, **{f"{k_}_frames_per_s": bb / v * 1e3
                                                      for k_, v in sms.items()}}
            log(f"  {name.upper()} scorer B={bb} [{card_line}]: " + ", ".join(
                f"{k_} {v:.3f} ms ({bb / v * 1e3:.1f} frames/s)" for k_, v in sms.items()))
        del model, bf, q, scorers

    ast_bf = ASTModel(input_tdim=ast_model.input_tdim, fused_attention=True,
                      dtype=torch.bfloat16).cuda()
    ast_bf.load_state_dict(ast_model.state_dict())
    a = audio[64]
    ast_scorers = {"fp32": make_score_fn(ast_model, ast_transform, "cuda"),
                   "bf16": make_score_fn(ast_bf, ast_transform, "cuda"),
                   "int8": make_score_fn(ast_q, ast_transform, "cuda")}
    sms = median_ms({name: (lambda fn=fn: fn(a)) for name, fn in ast_scorers.items()}, reps=3)
    out["ast_scorer_ms"] = {64: {**sms, **{f"{k_}_frames_per_s": 64 / v * 1e3
                                          for k_, v in sms.items()}}}
    log(f"  AST scorer B=64 [{card_line}]: " + ", ".join(
        f"{k_} {v:.3f} ms ({64 / v * 1e3:.1f} frames/s)" for k_, v in sms.items()))
    return out


def op_counters(mods) -> dict:
    """``{op name: (module, counter)}``: the launch count each ``adfd`` op's
    CUDA implementation adds one to per kernel launch."""
    wpt_cuda, fc, fp, f2, fa, icc = mods
    return {
        "adfd::wpt_packets": (wpt_cuda, "LAUNCHES"),
        "adfd::fused_conv1_prelu_pool": (fc, "FWD_LAUNCHES"),
        "adfd::fused_conv_mfm_pool": (fc, "MFM_FWD_LAUNCHES"),
        "adfd::fused_prelu_pool": (fp, "POOL_FWD_LAUNCHES"),
        "adfd::fused_conv2_prelu_pool": (f2, "CONV2_FWD_LAUNCHES"),
        "adfd::flash_mha_packed": (fa, "MHA_FWD_LAUNCHES"),
        "adfd::int8_conv": (icc, "LAUNCHES"),
        "adfd::int8_conv_site": (icc, "SITE_LAUNCHES"),
    }


def export_scorers(dcnn_snapshot: str, lcnn_snapshot: str, ast_model, ast_transform,
                   data: str):
    """Phase 23's scorers: ``(name, model, transform, adfd ops per call)``.
    Phase 7's DCNN snapshot (kernel 1), int8-baked (the int8 site kernel),
    with all three fused flags (kernels 2, 5 and 6); phase 11's LCNN with
    its fused block (kernel 3); phase 18's AST (kernel 4)."""
    import copy

    from audiodeepfake_detection_tpu_torch.ops.quantize import DEFAULT_INT8_SITES
    from audiodeepfake_detection_tpu_torch.train.predict import (
        build_scorer_from_snapshot, quantize_for_scoring)

    model, transform, _ = build_scorer_from_snapshot(dcnn_snapshot)
    fused = copy.deepcopy(model)
    fused.fused_layer1 = fused.fused_pool = fused.fused_layer2 = "always"
    q = quantize_for_scoring(model, transform, list(corpus_frames(data, 64)), "cuda", 64)
    lcnn, lcnn_transform, _ = build_scorer_from_snapshot(lcnn_snapshot)
    lcnn.fused_layer1 = "always"
    return [
        ("dcnn", model, transform, {"adfd::wpt_packets": 1}),
        ("dcnn-int8", q, transform,
         {"adfd::wpt_packets": 1, "adfd::int8_conv_site": len(DEFAULT_INT8_SITES)}),
        ("dcnn-fused", fused, transform,
         {"adfd::wpt_packets": 1, "adfd::fused_conv1_prelu_pool": 1,
          "adfd::fused_conv2_prelu_pool": 1, "adfd::fused_prelu_pool": 1}),
        ("lcnn-fused", lcnn, lcnn_transform, {"adfd::fused_conv_mfm_pool": 1}),
        ("ast-fused", ast_model, ast_transform, {"adfd::flash_mha_packed": AST_BLOCKS}),
    ]


def graph_ops(ep) -> dict:
    """``{op: calls}`` over every call in an exported graph (a report of
    what the program runs, printed where its bits differ from eager)."""
    from collections import Counter

    return dict(Counter(str(n.target) for n in ep.graph.nodes if n.op == "call_function"))


def export_phase(mods, scorers, root: str, card_line: str):
    """Phase 23: each scorer exported on ``cuda`` with a symbolic batch, saved
    and reloaded from its file; its graph's ``adfd`` ops; at B = 1, 64 and
    128 its scores against the eager scorer (the same bits, or the maximum
    difference within ``EXPORT_ATOL``) and each op's launch counter grown by
    its calls per artifact call; the fp32 and int8 DCNN artifacts timed
    against their eager scorers at B = 64 and 128."""
    from audiodeepfake_detection_tpu_torch.train import export
    from audiodeepfake_detection_tpu_torch.train.predict import make_score_fn

    counters = op_counters(mods)
    gen = torch.Generator().manual_seed(31)
    audio = {b: (0.3 * torch.randn(b, 1, SR, generator=gen)).cuda() for b in EXPORT_BATCHES}
    out = {}
    for name, model, transform, want_ops in scorers:
        t0 = time.perf_counter()
        ep = export.export_scorer(model, transform, SR, "cuda")
        export_s = time.perf_counter() - t0
        path = os.path.join(root, f"{name}.adfx")
        export.save_artifact(ep, path, {"model": name, "win": SR})
        t0 = time.perf_counter()
        loaded, meta = export.load_artifact(path)
        load_s = time.perf_counter() - t0
        ops = dict(export.adfd_ops(loaded))
        if ops != want_ops or meta["in_shape"] != ["b", "1", str(SR)]:
            raise AssertionError(f"{name}: adfd ops {ops} (want {want_ops}), meta {meta}")
        artifact = loaded.module()
        eager = make_score_fn(model, transform, "cuda")
        row = {"export_s": export_s, "load_s": load_s, "bytes": os.path.getsize(path),
               "ops": ops, "max_abs_diff": {}, "launches_per_call": {}}
        for b, a in audio.items():
            want = eager(a)
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            with torch.inference_mode():
                got = artifact(a)
            torch.cuda.synchronize()
            launched = {op: getattr(*counters[op]) for op in counters
                        if getattr(*counters[op])}
            if launched != want_ops:
                raise AssertionError(f"{name} B={b}: launches {launched}, want {want_ops}")
            if type(want) is not torch.Tensor or got.shape != (b,):
                raise AssertionError(f"{name} B={b}: eager {type(want)}, artifact {got.shape}")
            diff = (got - want).abs().max().item()
            row["max_abs_diff"][b] = diff
            row["launches_per_call"][b] = launched
            if diff:
                log(f"  {name} B={b}: artifact differs from eager by {diff:.3e} (limit "
                    f"{EXPORT_ATOL}); the graph runs {graph_ops(loaded)}")
            if not diff <= EXPORT_ATOL:
                raise AssertionError(f"{name} B={b}: artifact vs eager {diff}")
        if name in ("dcnn", "dcnn-int8"):
            row["ms"] = {}
            for b in (64, 128):
                a = audio[b]

                def run_artifact(a=a):
                    with torch.inference_mode():  # as make_score_fn's scorer
                        return artifact(a)

                fns = {"eager": lambda a=a: eager(a), "artifact": run_artifact}
                ms = median_ms(fns, reps=5)
                host = {k: host_ms(fn, reps=5) for k, fn in fns.items()}
                row["ms"][b] = {**ms, **{f"{k}_host": v for k, v in host.items()}}
                log(f"  {name} B={b} [{card_line}]: artifact {ms['artifact']:.3f} ms, eager "
                    f"{ms['eager']:.3f} ms; host time a call (no synchronize) artifact "
                    f"{host['artifact']:.3f} ms, eager {host['eager']:.3f} ms")
        log(f"  {name}: exported in {export_s:.2f} s, {row['bytes']} bytes, loaded in "
            f"{load_s:.2f} s, ops {ops}, max |artifact - eager| {row['max_abs_diff']}")
        out[name] = row
        del artifact, loaded, ep
    out["dispatch"] = op_dispatch(mods, card_line)
    return out


def host_ms(fn, reps: int) -> float:
    """Host milliseconds a call of ``fn``: the loop timed before the
    synchronize, so the queued device work is not in it (unless the queue
    fills)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def op_dispatch(mods, card_line: str, reps: int = 50) -> dict:
    """Phase 23: each of two ops against its direct launcher, the same kernel
    on the same tensor: kernel 1 at B = 64 (1 s frames, with the log) and
    kernel 4 at B = 32, N = 227 (12 heads); CUDA-event medians and the
    host's microseconds a call (:func:`host_ms`, median of ``WINDOWS``)."""
    wpt_cuda, _, _, _, fa, _ = mods
    gen = torch.Generator().manual_seed(32)
    x = torch.randn(64, SR, generator=gen).cuda()
    b, n, heads = AST_SHAPE
    qkv = torch.randn(b, n, 3 * heads * 64, generator=gen).cuda()
    cases = {
        "wpt-B64": {
            "op": lambda: torch.ops.adfd.wpt_packets.default(x, MAIN[0], MAIN[1], True, 2.0),
            "launcher": lambda: wpt_cuda.wpt_packets_cuda(x, *MAIN, log_scale=True),
        },
        "mha-N227": {
            "op": lambda: torch.ops.adfd.flash_mha_packed.default(qkv, heads, 0.125),
            "launcher": lambda: fa.forward(qkv, heads, 0.125, False)[0],
        },
    }
    out = {}
    with torch.inference_mode():
        for case, fns in cases.items():
            if not torch.equal(fns["op"](), fns["launcher"]()):
                raise AssertionError(f"{case}: the op and its launcher differ")
            ms = median_ms(fns, reps=reps)
            host = {name: 1e3 * statistics.median(host_ms(fn, reps) for _ in range(WINDOWS))
                    for name, fn in fns.items()}
            out[case] = {"op_ms": ms["op"], "launcher_ms": ms["launcher"],
                         "op_host_us": host["op"], "launcher_host_us": host["launcher"]}
            log(f"  {case} [{card_line}]: op {ms['op']:.4f} ms ({host['op']:.1f} us of host "
                f"a call), launcher {ms['launcher']:.4f} ms ({host['launcher']:.1f} us)")
    return out


def int8_rows(errs, served, times):
    """The ``kernels`` rows of the int8 site kernel, one per DCNN site at B =
    64 and one at B = 128: launches at the site over phase 22's HTTP run
    (B = 64 dispatches) and in one int8 DCNN scoring call at B = 128,
    checked and timed in phase 22 (``library_ms`` null: no PyTorch call convolves int8
    on CUDA; cuDNN's float32 and bf16 times stand beside it as a
    yardstick)."""
    rows = []
    for b in (64, 128):
        for site in INT8_DCNN_SITES:
            t = times["sites"][b][site]
            rows.append({
                "name": f"int8_conv_{site}" + ("" if b == 64 else "_b128"), "route": "cuda",
                "source": "audiodeepfake_detection_tpu_torch/csrc/int8_conv.cu",
                "replaces": "audiodeepfake_detection_tpu/ops/quantize.py:113 int8_conv and :135 "
                            "quantized_conv (XLA s8 conv, no Pallas kernel)",
                "design": "a whole site: codes made on load (register loads; at an N tile "
                          "of 32 the NCHW rows staged by cp.async; the codes-in mode copies "
                          "16-byte code words by cp.async) into a channels-innermost halo, "
                          "implicit im2col by ldmatrix, mma.sync m16n8k32 s8 with N tiles of "
                          "32-128 shaped to Cout, weights in fragment order through a cp.async "
                          "ring (Cin = 1: dp4a), scale + map + bias in the epilogue, NCHW runs "
                          "from shared memory",
                "launches": (served["site_launches"][site] if b == 64
                             else times["b128_launches"][site]),
                "max_abs_err": errs[f"site-dcnn-{site}-B{b}-float32"],
                "ms": t["site_ms"], "plain_ms": t["plain_ms"], "device_ms": t["device_ms"],
                "layer_ms": t["layer_ms"], "codes_in_ms": t["codes_in_ms"],
                "codes_in_device_ms": t["codes_in_device_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
                "cudnn_fp32_ms": t["cudnn_fp32_ms"], "cudnn_bf16_ms": t["cudnn_bf16_ms"],
            })
    return rows


# ---- sweeps and resident data (phase 24)
SWEEP_SEEDS = (0, 1, 2)
# per-step loss, a seed of the "vmap" sweep (unfused DCNN, dropout 0)
# against its serial run: the vmapped convolutions and BatchNorm sum in
# another order than the serial batch-128 ones, then Adam carries that on.
# Read on an NVIDIA H100 80GB HBM3 at 700 W over this phase's 3 steps:
# 2.04e-5 and 2.65e-5 in two runs (on the CPU: 2e-7,
# tests/test_torch_vectorized.py); the bound is about 8x the larger
VMAP_LOSS_RTOL = 2e-4
RESIDENT_FRAMES = 55_504  # the LJSpeech train split at 1 s frames (data/prepare.py)
RESIDENT_GROUP = 4  # steps per call of the chained / resident runs and timings
SWEEP_WINDOWS = 5


@contextlib.contextmanager
def wpt_batches(wpt_cuda):
    """Record the batch of every call of kernel 1's launcher in the block
    (the op ``adfd::wpt_packets`` looks the launcher up at call time)."""
    seen = []
    launcher = wpt_cuda.wpt_packets_cuda

    def spy(x, *rest, **kw):
        seen.append(int(x.shape[0]))
        return launcher(x, *rest, **kw)

    wpt_cuda.wpt_packets_cuda = spy
    try:
        yield seen
    finally:
        wpt_cuda.wpt_packets_cuda = launcher


def dcnn_counts(mods, reset: bool = False) -> dict:
    """Launch counters of kernels 1, 2, 5 and 6 (set to 0 with ``reset``)."""
    wpt_cuda, fused_cuda, pool_cuda, conv2_cuda = mods
    if reset:
        wpt_cuda.LAUNCHES = fused_cuda.FWD_LAUNCHES = fused_cuda.BWD_LAUNCHES = 0
        pool_cuda.POOL_FWD_LAUNCHES = pool_cuda.POOL_BWD_LAUNCHES = 0
        conv2_cuda.CONV2_FWD_LAUNCHES = conv2_cuda.CONV2_BWD_LAUNCHES = 0
    return {"wpt": wpt_cuda.LAUNCHES, "conv1_fwd": fused_cuda.FWD_LAUNCHES,
            "conv1_bwd": fused_cuda.BWD_LAUNCHES, "pool_fwd": pool_cuda.POOL_FWD_LAUNCHES,
            "pool_bwd": pool_cuda.POOL_BWD_LAUNCHES, "conv2_fwd": conv2_cuda.CONV2_FWD_LAUNCHES,
            "conv2_bwd": conv2_cuda.CONV2_BWD_LAUNCHES}


@contextlib.contextmanager
def captured_sweeps():
    """The shadow Trainers of each vectorized sweep trained in the block, and
    the seed axis each sweep ran."""
    from audiodeepfake_detection_tpu_torch.train import sweep

    shadows, axes = [], []
    train = sweep.VectorizedSeedSweep.train

    def record(self, max_epochs):
        axes.append(self.seed_axis)
        out = train(self, max_epochs)
        shadows.extend(self.shadows)
        return out

    sweep.VectorizedSeedSweep.train = record
    try:
        yield shadows, axes
    finally:
        sweep.VectorizedSeedSweep.train = train


def sweep_main(root: str, data: str, log_dir: str, seeds, axes: dict, *flags) -> None:
    """``experiment.main`` as a grid search over ``seeds`` with ``flags``;
    the grid file carries the data, the widths and ``axes``."""
    from audiodeepfake_detection_tpu_torch.train import experiment

    grid = {"learning_rate": [4e-4], "weight_decay": [1e-3], "module": ["DCNN"],
            "flattend_size": [320], "time_dim_add": [1], "data_path": [data],
            "save_path": [os.path.join(root, "meta")], "only_use": [["ljspeech", "fbmelgan"]],
            **axes}
    config = os.path.join(root, f"{log_dir}.py")
    with open(config, "w") as fh:
        fh.write(f"def get_config():\n    return {grid!r}\n")
    experiment.main([
        "--enable-gs", "--config", config, "--init-seeds", *map(str, seeds),
        "--device", "cuda", "--epochs", str(EPOCHS), "--batch-size", str(BATCH),
        "--model", "modules", "--transform", "packets", "--wavelet", MAIN[0],
        "--num-of-scales", str(2 ** MAIN[1]), "--log-scale", "--calc-normalization",
        "--log-dir", os.path.join(root, log_dir),
        "--data-prefix", data + "/fake_22050_22050_0.7_fbmelgan", *flags,
    ])


def loss_rel_diff(got, want) -> float:
    if len(got) != len(want) or not np.isfinite(got).all():
        raise AssertionError(f"losses {got} against {want}")
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


class SyntheticFrames:
    """A loader-shaped set of ``n`` frames for ``ResidentData``: one random
    chunk reused, each row's first sample its index; ``fail`` refuses any
    decode (the budget gate must refuse first)."""

    def __init__(self, n: int, emit: str, seed: int = 0, fail: bool = False) -> None:
        self.dataset = range(n)
        self.target_len = SR
        self.emit = emit
        self.fail = fail
        rng = np.random.RandomState(seed)
        chunk = np.clip(0.3 * rng.randn(512, 1, SR), -1.0, 1.0 - 2.0**-15)
        self.chunk = ((chunk * 32768).astype(np.int16) if emit == "int16"
                      else chunk.astype(np.float32))

    def _make_batch(self, idxs, pad_to):
        if self.fail:
            raise AssertionError("decoded before the budget gate")
        audio = self.chunk[: len(idxs)].copy()
        audio[:, 0, 0] = idxs % 32768
        return {"audio": audio, "label": (idxs % 2).astype(np.int32)}


def windows_ms(fns: dict, reps: int, windows: int = SWEEP_WINDOWS) -> dict:
    """Every window's CUDA-event ms per call of each function (the order
    alternates between windows), their median and spread."""
    for fn in fns.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    names = list(fns)
    for w in range(windows):
        for name in names if w % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fns[name]()
            stop.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(stop) / reps)
    out = {}
    for name, v in times.items():
        med = statistics.median(v)
        out[name] = {"ms": med, "windows_ms": v, "spread_pct": (max(v) - min(v)) / med * 100}
    return out


def enqueue_ms(fn, n: int = 8) -> dict:
    """Host time to enqueue ``n`` calls (no wait) against their wall time
    to the end of the device's work, per call: a host that enqueues as
    slowly as the card runs would be held up by launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"enqueue_ms": (t1 - t0) / n * 1e3, "wall_ms": (t2 - t0) / n * 1e3}


def dcnn_step_parts(norm, seed: int = 0, **model_kw):
    """A full-width DCNN (``model_kw``: its flags, dropout), its transform
    with phase 7's normalization, and its optimizer."""
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.train.steps import make_optimizer
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    transform = normalized_transform(make_transform(train_args("", "", "")),
                                     *[np.asarray(v) for v in norm])
    torch.manual_seed(seed)
    model = DCNN(time_dim=12, **model_kw).cuda()
    return model, transform, make_optimizer(model.parameters(), 4e-4, 1e-3)


def host_batches(n: int, seed: int, seeds: int = 0) -> list:
    """``n`` numpy batches of 128 frames (``[S, 128, ...]`` with ``seeds``)."""
    gen = np.random.RandomState(seed)
    shape = (seeds, BATCH) if seeds else (BATCH,)
    return [{"audio": (0.3 * gen.randn(*shape, 1, SR)).astype(np.float32),
             "label": gen.randint(0, 2, shape).astype(np.int32)} for _ in range(n)]


def sweep_timing(norm, data_ds, card_line: str) -> dict:
    """Phase 24 (e): the fused DCNN step three ways, three seeds four ways,
    the loader with and without the frame cache, and the H2D copy."""
    import itertools

    from audiodeepfake_detection_tpu_torch.data import frame_cache
    from audiodeepfake_detection_tpu_torch.data.loader import (
        FrameLoader, batch_to_device, device_prefetch)
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.train import vectorized
    from audiodeepfake_detection_tpu_torch.train.device_data import ResidentData
    from audiodeepfake_detection_tpu_torch.train.steps import (
        make_resident_multi_train_step, make_train_step)

    flags = dict(fused_layer1=True, fused_pool=True, fused_layer2=True)
    out = {}
    # (1) one fused step at B=128: resident G=4, streamed, a fixed device batch
    res = ResidentData(SyntheticFrames(1024, "float32", seed=3), "cuda")
    model, transform, opt = dcnn_step_parts(norm, **flags)
    resident = make_resident_multi_train_step(model, transform, opt)
    gen = torch.Generator().manual_seed(8)
    blocks = itertools.cycle([torch.randperm(1024, generator=gen)[: RESIDENT_GROUP * BATCH]
                              .view(RESIDENT_GROUP, BATCH).cuda() for _ in range(4)])
    model2, transform2, opt2 = dcnn_step_parts(norm, **flags)
    streamed_step = make_train_step(model2, transform2, opt2)
    stream = device_prefetch(itertools.cycle(host_batches(4, seed=9)), torch.device("cuda"))
    model3, transform3, opt3 = dcnn_step_parts(norm, **flags)
    fixed_step = make_train_step(model3, transform3, opt3)
    fixed = batch_to_device(host_batches(1, seed=10)[0], torch.device("cuda"))
    fns = {"resident_g4": lambda: resident(res.audio, res.labels, next(blocks)),
           "streamed": lambda: streamed_step(next(stream)[1]),
           "fixed_batch": lambda: fixed_step(fixed)}
    step = windows_ms(fns, reps=3)
    step["resident_g4"] = {k: (v / RESIDENT_GROUP if k == "ms" else
                               [w / RESIDENT_GROUP for w in v] if k == "windows_ms" else v)
                           for k, v in step["resident_g4"].items()}
    for name, row in step.items():
        row["frames_per_s"] = BATCH / row["ms"] * 1e3
    step["enqueue"] = {"fixed_batch": enqueue_ms(fns["fixed_batch"]),
                       "resident_g4_per_call": enqueue_ms(fns["resident_g4"], n=2)}
    out["step"] = step
    del res, resident, model, model2, model3, stream
    log(f"  fused DCNN step at B={BATCH} [{card_line}]: " + ", ".join(
        f"{k} {v['ms']:.3f} ms ({v['frames_per_s']:.1f} frames/s, windows "
        f"{['%.3f' % w for w in v['windows_ms']]}, spread {v['spread_pct']:.1f} %)"
        for k, v in step.items() if k != "enqueue"))
    log(f"  host enqueue vs wall per call: {step['enqueue']}")

    # (2) three seeds: three serial models, "scan", and unfused serial / "vmap"
    seeds = list(SWEEP_SEEDS)
    s = len(seeds)
    group = batch_to_device(host_batches(1, seed=11, seeds=s)[0], torch.device("cuda"))
    fns = {}
    for kind, kw in (("fused", dict(flags)),
                     ("unfused", dict(dropout_cnn=0.0, dropout_lstm=0.0))):
        serial = []
        for i, seed in enumerate(seeds):
            m, t, o = dcnn_step_parts(norm, seed=seed, **kw)
            st = make_train_step(m, t, o)
            serial.append(lambda st=st, i=i: st({k: v[i] for k, v in group.items()}))
        fns[f"serial_{kind}"] = lambda serial=serial: [f() for f in serial]
        axis = "scan" if kind == "fused" else "vmap"
        _, t, _ = dcnn_step_parts(norm, **kw)
        vstate = vectorized.create_vectorized_state(
            lambda kw=kw: DCNN(time_dim=12, **kw), seeds, 4e-4, 1e-3, device="cuda",
            seed_axis=axis)
        vstep = vectorized.make_vectorized_train_step(vstate, t)
        fns[f"{axis}_{kind}"] = lambda vstep=vstep: vstep(group)
    seeds_t = windows_ms(fns, reps=2)
    for row in seeds_t.values():
        row["frames_per_s"] = s * BATCH / row["ms"] * 1e3
    out["seeds"] = seeds_t
    del fns, vstate, vstep, group
    log(f"  {s} seeds, one step each at B={BATCH} [{card_line}]: " + ", ".join(
        f"{k} {v['ms']:.3f} ms ({v['frames_per_s']:.1f} frames/s, windows "
        f"{['%.3f' % w for w in v['windows_ms']]}, spread {v['spread_pct']:.1f} %)"
        for k, v in seeds_t.items()))

    # (3) the loader: decoding (prefetch thread) against a warm frame cache
    def loader_rate(loader, epochs: int = 2, windows: int = 3) -> dict:
        rates = []
        for _ in range(windows):
            n, t0 = 0, time.perf_counter()
            for e in range(epochs):
                for batch in loader.epoch(e):
                    n += int(batch["weight"].sum())
            rates.append(n / (time.perf_counter() - t0))
        med = statistics.median(rates)
        return {"frames_per_s": med, "windows_frames_per_s": rates,
                "spread_pct": (max(rates) - min(rates)) / med * 100}

    kw = dict(shuffle=True, drop_last=True, num_threads=8)
    loader = {"decode": loader_rate(FrameLoader(data_ds, BATCH, use_frame_cache=False, **kw))}
    t0 = time.perf_counter()
    frame_cache.build_frame_cache(data_ds, num_threads=8)
    loader["cache_build_s"] = time.perf_counter() - t0
    for emit in ("float32", "int16"):
        cached = FrameLoader(data_ds, BATCH, use_frame_cache=True, emit=emit, **kw)
        if cached._frame_cache is None:
            raise AssertionError("the frame cache was not opened")
        loader[f"cache_{emit}"] = loader_rate(cached, epochs=8)
    out["loader"] = loader
    log(f"  FrameLoader over {len(data_ds)} frames (host clock): decode "
        f"{loader['decode']['frames_per_s']:.0f} frames/s, cache built in "
        f"{loader['cache_build_s']:.2f} s, warm cache float32 "
        f"{loader['cache_float32']['frames_per_s']:.0f} / int16 "
        f"{loader['cache_int16']['frames_per_s']:.0f} frames/s ({loader})")

    # (4) one [128, 1, 22050] host-to-device copy from pinned memory
    h2d = {}
    for name, dtype in (("int16", torch.int16), ("float32", torch.float32)):
        host = torch.zeros((BATCH, 1, SR), dtype=dtype).pin_memory()
        dev = torch.empty((BATCH, 1, SR), dtype=dtype, device="cuda")
        row = windows_ms({name: lambda host=host, dev=dev: dev.copy_(host, non_blocking=True)},
                         reps=20)[name]
        row["gb_per_s"] = host.numel() * host.element_size() / row["ms"] / 1e6
        h2d[name] = row
    out["h2d"] = h2d
    log(f"  H2D [{BATCH}, 1, {SR}] pinned [{card_line}]: " + ", ".join(
        f"{k} {v['ms']:.4f} ms ({v['gb_per_s']:.1f} GB/s, spread {v['spread_pct']:.1f} %)"
        for k, v in h2d.items()))
    return out


def sweep_phase(mods, root: str, data: str, norm, card_line: str) -> dict:
    """Phase 24: the seed sweep (scan and vmap), the guard, resident and
    chained training, resident data at the LJSpeech split's size, timing."""
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.train import vectorized
    from audiodeepfake_detection_tpu_torch.train.device_data import ResidentData
    from audiodeepfake_detection_tpu_torch.train.experiment import (
        run_experiment, run_experiment_vectorized)

    t_phase = time.perf_counter()
    out = {}
    steps = EPOCHS * STEPS_PER_EPOCH
    s = len(SWEEP_SEEDS)
    flags3 = dict(fused_pool=True, fused_layer2=True)

    # (a) the sweep through main, "scan": every kernel once per slice, kernel
    # 1 once a step for all slices
    dcnn_counts(mods, reset=True)
    t0 = time.perf_counter()
    with captured_sweeps() as (shadows, axes), wpt_batches(mods[0]) as batches:
        sweep_main(root, data, "log_sweep_scan", SWEEP_SEEDS, {"fused_layer2": [True]},
                   "--fused-layer1", "train", "--fused-pool", "train", "--vmap-seeds")
    torch.cuda.synchronize()
    counts = dcnn_counts(mods)
    wall = time.perf_counter() - t0
    if axes != ["scan"] or len(shadows) != s:
        raise AssertionError(f"sweep (a): seed axes {axes}, {len(shadows)} shadows")
    want = {k: s * steps for k in counts if k != "wpt"}
    n_sweep = sum(b == s * BATCH for b in batches)
    if any(counts[k] != v for k, v in want.items()) or n_sweep != steps:
        raise AssertionError(f"sweep (a): launches {counts} (want {want}), kernel 1 at "
                             f"{s * BATCH} frames {n_sweep} times (want {steps}): {batches}")
    runs = []
    for sh in shadows:
        serial = run_experiment(train_args(root, data, "log_sweep_serial",
                                           seed=int(sh.args.seed), **flags3))
        got = [row[2] for row in sh.loss_list]
        ref = [row[2] for row in serial.loss_list]
        worst = loss_rel_diff(got, ref)
        test_diff = max(abs(a - b) for a, b in zip(sh.test_results, serial.test_results))
        log(f"  seed {sh.args.seed}: sweep losses {['%.6f' % v for v in got]}, serial "
            f"{['%.6f' % v for v in ref]} (worst rel diff {worst:.2e}); test "
            f"{sh.test_results} against {serial.test_results}")
        if not worst <= LOSS_RTOL:
            raise AssertionError(f"sweep (a) seed {sh.args.seed}: losses {worst} > {LOSS_RTOL}")
        # a frame's decision or two at most (the test split has 84 frames)
        if not test_diff <= 2.0 / 84 + 1e-9:
            raise AssertionError(f"sweep (a) seed {sh.args.seed}: test metrics "
                                 f"{sh.test_results} against {serial.test_results}")
        runs.append({"seed": int(sh.args.seed), "losses": got, "serial_losses": ref,
                     "loss_rel_diff": worst, "test": list(sh.test_results),
                     "serial_test": list(serial.test_results), "test_diff": test_diff})
        if int(sh.args.seed) == 0:
            streamed_seed0 = serial
    # the floor: seed 0's serial run again (cuDNN's default algorithms may
    # sum a weight gradient in another order from run to run)
    again = run_experiment(train_args(root, data, "log_sweep_serial_again", seed=0, **flags3))
    floor = loss_rel_diff([row[2] for row in again.loss_list],
                          [row[2] for row in streamed_seed0.loss_list])
    log(f"  seed 0's serial run repeated: worst rel diff {floor:.2e}")
    out["serial_repeat_rel_diff"] = floor
    del again
    out["scan"] = {"launches": counts, "kernel1_at_sweep_batch": n_sweep,
                   "kernel1_batches": sorted(set(batches)), "wall_s": wall, "seeds": runs}
    log(f"  sweep (a), scan: launches {counts}, kernel 1 at {s * BATCH} frames {n_sweep} "
        f"times, {wall:.1f} s wall")

    # (b) "vmap" (asked for: the sweep runs "scan" by itself): the unfused
    # DCNN, dropout 0, one epoch, against serial runs
    kw = dict(fused_layer1=False, dropout_cnn=0.0, dropout_lstm=0.0, epochs=1)
    with captured_sweeps() as (_, axes), wpt_batches(mods[0]) as batches:
        shadows = run_experiment_vectorized(
            [train_args(root, data, "log_sweep_vmap", seed=seed, **kw) for seed in SWEEP_SEEDS],
            seed_axis="vmap")
    n_vmap = sum(b == s * BATCH for b in batches)
    if axes != ["vmap"] or n_vmap != STEPS_PER_EPOCH:
        raise AssertionError(f"sweep (b): seed axes {axes}, kernel 1 at {s * BATCH} frames "
                             f"{n_vmap} times (want {STEPS_PER_EPOCH})")
    runs = []
    for sh in shadows:
        serial = run_experiment(train_args(root, data, "log_vmap_serial",
                                           seed=int(sh.args.seed), **kw))
        got = [row[2] for row in sh.loss_list]
        ref = [row[2] for row in serial.loss_list]
        worst = loss_rel_diff(got, ref)
        log(f"  seed {sh.args.seed}: vmap losses {['%.7f' % v for v in got]}, serial "
            f"{['%.7f' % v for v in ref]} (worst rel diff {worst:.2e})")
        if not worst <= VMAP_LOSS_RTOL:
            raise AssertionError(f"sweep (b) seed {sh.args.seed}: losses {worst} > "
                                 f"{VMAP_LOSS_RTOL}")
        runs.append({"seed": int(sh.args.seed), "losses": got, "serial_losses": ref,
                     "loss_rel_diff": worst})
    out["vmap"] = {"kernel1_at_sweep_batch": n_vmap, "seeds": runs}

    # (c) a fused model is never vmapped: refused before any launch
    dcnn_counts(mods, reset=True)
    refused = None
    try:
        vectorized.create_vectorized_state(
            lambda: DCNN(time_dim=12, fused_layer1=True, **flags3), [0, 1], 4e-4, 1e-3,
            device="cuda", seed_axis="vmap")
    except ValueError as exc:
        refused = str(exc)
    counts = dcnn_counts(mods)
    if refused is None or "fused_layer1" not in refused or any(counts.values()):
        raise AssertionError(f"guard (c): refusal {refused!r}, launches {counts}")
    out["guard"] = refused
    log(f"  guard (c): {refused}")

    # (d) device_data + steps_per_call through run_experiment, against (a)'s
    # streamed serial run of seed 0 (the same configuration)
    dcnn_counts(mods, reset=True)
    trainer = run_experiment(train_args(root, data, "log_resident", device_data=True,
                                        steps_per_call=RESIDENT_GROUP, **flags3))
    torch.cuda.synchronize()
    counts = dcnn_counts(mods)
    got = [row[2] for row in trainer.loss_list]
    ref = [row[2] for row in streamed_seed0.loss_list]
    worst = loss_rel_diff(got, ref)
    log(f"  resident + chained (G={RESIDENT_GROUP}): losses {['%.6f' % v for v in got]} "
        f"(worst rel diff to streamed {worst:.2e}), test {trainer.test_results} against "
        f"{streamed_seed0.test_results}, launches {counts}, resident "
        f"{trainer._resident.nbytes} B, eval sets parked {len(trainer._resident_eval_cache)}")
    want = {k: steps for k in counts if k != "wpt"}
    if any(counts[k] != v for k, v in want.items()) or counts["wpt"] < steps:
        raise AssertionError(f"resident run (d): launches {counts}, want {want}")
    test_diff = max(abs(a - b) for a, b in zip(trainer.test_results,
                                               streamed_seed0.test_results))
    if not worst <= LOSS_RTOL or not test_diff <= 2.0 / 84 + 1e-9:
        raise AssertionError(f"resident run (d) against streamed: losses {worst}, test "
                             f"{trainer.test_results} / {streamed_seed0.test_results}")
    out["resident_run"] = {"launches": counts, "losses": got, "streamed_losses": ref,
                           "loss_rel_diff": worst, "resident_bytes": trainer._resident.nbytes}
    data_ds = trainer.train_loader.dataset
    del trainer, streamed_seed0

    # the LJSpeech train split's size in int16, parked; then a set over the
    # budget, refused before anything is allocated
    torch.cuda.empty_cache()
    free0, total = torch.cuda.mem_get_info()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    big = ResidentData(SyntheticFrames(RESIDENT_FRAMES, "int16", seed=4), "cuda")
    park_s = time.perf_counter() - t0
    free1, _ = torch.cuda.mem_get_info()
    # the caching allocator may serve the set from a segment it already
    # holds, which mem_get_info does not see: the tensors' own bytes count
    parked = torch.cuda.memory_allocated() - alloc0
    rows = [0, 12_345, RESIDENT_FRAMES - 1]
    firsts = big.audio[rows, 0, 0].tolist()
    labels_bytes = RESIDENT_FRAMES * 4
    if (big.nbytes != RESIDENT_FRAMES * SR * 2 or free1 > free0
            or not big.nbytes + labels_bytes <= parked <= big.nbytes + labels_bytes + (2 << 20)
            or firsts != [r % 32768 for r in rows] or big.audio.dtype != torch.int16):
        raise AssertionError(f"resident set: {big.nbytes} B, free {free0} -> {free1}, "
                             f"allocated +{parked}, rows {firsts}")
    del big
    torch.cuda.empty_cache()
    over = int(0.6 * total / (SR * 4)) + 1
    alloc2, free2 = torch.cuda.memory_allocated(), torch.cuda.mem_get_info()[0]
    refusal = None
    try:
        ResidentData(SyntheticFrames(over, "float32", fail=True), "cuda")
    except ValueError as exc:
        refusal = str(exc)
    alloc3, free3 = torch.cuda.memory_allocated(), torch.cuda.mem_get_info()[0]
    if refusal is None or alloc3 != alloc2 or free3 < free2:
        raise AssertionError(f"budget gate: refusal {refusal!r}, allocated {alloc2} -> "
                             f"{alloc3}, free {free2} -> {free3}")
    out["resident_set"] = {"frames": RESIDENT_FRAMES, "bytes": RESIDENT_FRAMES * SR * 2,
                           "free_before": free0, "free_after": free1, "total": total,
                           "allocated_delta": parked,
                           "park_s": park_s, "refused_frames": over, "refusal": refusal,
                           "free_around_refusal": [free2, free3]}
    log(f"  {RESIDENT_FRAMES} int16 frames parked in {park_s:.2f} s: "
        f"{RESIDENT_FRAMES * SR * 2} B (allocated +{parked} B with the labels), "
        f"mem_get_info free {free0} -> {free1} of {total}; "
        f"{over} float32 frames refused ({refusal}), allocated {alloc2} -> {alloc3}, "
        f"free {free2} -> {free3}")

    log("  time")
    out["timing"] = sweep_timing(norm, data_ds, card_line)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 24 took {out['phase_s']:.1f} s")
    return out


# ---- analysis on the card (phase 25)
# the fingerprints' mean |WPT| spectra through kernel 1 against the plain
# cascade on the card, relative to the largest entry: the raw packets read
# 0.0 from plain on every plan (phase 3), so the same means follow; this
# bound takes a mean over time and clips summed in another order
FINGERPRINT_RTOL = 1e-6
# mean attributions through kernels 5 and 6 ("always") against the same
# fused model with the blocks' plain PyTorch versions in their place (the
# same folded math), relative to the largest: kernel 6's forward sums in
# cuDNN's order (phase 14 reads 0.0), kernel 5's is elementwise, so the
# pools choose alike, and what is left is the kernels' dx in fp32 (kernel
# 6's split TF32, ~2**-22 a product) summed over 201 path images
IG_KERNEL_RTOL = 1e-4
# mean attributions, fused against unfused (cuDNN, BatchNorm then conv),
# relative to the largest: the fused block folds its BatchNorm into its
# weights, so its values differ from the unfused ones by fp32 roundoff, and
# a max-pool window whose two largest values lie within that roundoff
# chooses differently (48 of 201 path images of one image held such a
# window on the card, more of them near the zero baseline, where the image
# is nearly constant); such a row moves by up to 0.9 of its largest entry
# at a few pixels and weighs 1/200 in the trapezoid.  First set at 2e-3
# from the CPU's 5.2e-4 (a narrow DCNN, tests/test_torch_analysis.py); the
# card read 2.4e-3 on the trained full-width DCNN (NVIDIA H100 80GB HBM3,
# 700 W), so the bound is 1e-2, and the per-row reading below shows where
# it sits
IG_UNFUSED_RTOL = 1e-2
# a path image's gradient relative to its largest entry.  Through kernels 5
# and 6 against their plain versions in the same folded model, whose
# forwards agree bit for bit (phase 14), so every pool chooses alike: fp32
# sums of dx in another order (kernel 6's split TF32), held on every row.
# Fused against unfused, a row above this holds a max-pool choice the two
# roundings made differently; any row may hold one (the image itself did
# on one card run of four, at 1.07e-2), so that reading is held only to
# most rows agreeing: a wrong dx moves every row
IG_GRAD_RTOL = 1e-4
# the mean and last images of the two IG runs: the same transform of the
# same frames, each run with its own normalization pass on the card
IG_IMAGE_RTOL = 1e-6
# block-norm statistics on the card against the CPU, relative to each
# node's std: fp32 packets of two cascades (cuDNN against the CPU's conv)
# and Welford sums over 392 frames in another order
BLOCK_NORM_RTOL = 1e-4
# |CWT| on the card against the CPU, relative to the largest coefficient:
# three complex64 FFTs of 32,768 points in two libraries (cuFFT, pocketfft),
# the bound the CPU tests hold the complex64 CWT to against the float64
# oracle (read 1.4e-5 on an NVIDIA H100 80GB HBM3 at 700 W)
CWT_RTOL = 1e-4
# the average STFT energy on the card against the CPU, relative to the
# largest bin: one 2048-point FFT a frame, summed over the frames
ENERGY_RTOL = 1e-5
IG_PER_TARGET = 2  # ig_times_per_target: 2 images of each class
FINGERPRINT_CLIPS = 28  # every clip of each directory of the corpus


def rel_max(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def fingerprint_phase(wpt, wpt_cuda, root: str, data: str, card_line: str) -> dict:
    """(a) Per-generator level-14 haar fingerprints over the whole 10 s clips
    through kernel 1 (its top-level route: one ``wpt_level_kernel`` launch
    per level through device memory, then the subtree kernel), against the
    plain cascade on the card; the CLI end to end; one clip timed."""
    from audiodeepfake_detection_tpu_torch.analysis import cli as analysis_cli
    from audiodeepfake_detection_tpu_torch.analysis.fingerprints import (
        generator_fingerprints,
        load_clips,
    )

    kw = dict(real_name="ljspeech", wavelet="haar", level=14,
              max_files=FINGERPRINT_CLIPS, device="cuda")
    wpt_cuda.LAUNCHES = wpt_cuda.LEVEL_LAUNCHES = 0
    got = generator_fingerprints(data, ["fbmelgan"], **kw)
    torch.cuda.synchronize()
    launches = {"subtree": wpt_cuda.LAUNCHES, "level": wpt_cuda.LEVEL_LAUNCHES}
    want = generator_fingerprints(data, ["fbmelgan"], use_kernel=False, **kw)
    errs = {f"{gen}_{key}": rel_max(got[gen][key], want[gen][key])
            for gen in want for key in want[gen] if key.startswith("wpt")}
    clip = load_clips(os.path.join(data, "A_ljspeech"), 1)[0]
    t = (len(clip) >> 14) << 14
    x = torch.from_numpy(clip[None, :t]).cuda()
    plan = wpt_cuda.wpt_plan(1, t, wpt_cuda.filter_length("haar"), 14,
                             *wpt_cuda.device_limits(x.device.index))
    clips = 2 * FINGERPRINT_CLIPS
    log(f"  {clips} clips of {t} samples (level-14 haar, plan {plan}): launches {launches}; "
        f"mean spectra against the plain cascade, relative to the largest: {errs}")
    if launches != {"subtree": clips, "level": clips * plan.in_level} or plan.in_level < 1:
        raise AssertionError(f"level-14 launches {launches} for {clips} clips on plan {plan}")
    if not max(errs.values()) <= FINGERPRINT_RTOL:
        raise AssertionError(f"fingerprints, kernel against plain: {errs} > {FINGERPRINT_RTOL}")

    out_dir = os.path.join(root, "fingerprints")
    analysis_cli.main(["fingerprints", "--data-path", data, "--generators", "fbmelgan",
                       "--real-name", "ljspeech", "--max-files", str(FINGERPRINT_CLIPS),
                       "--out-dir", out_dir, "--device", "cuda"])
    files = sorted(os.listdir(out_dir))
    expect = sorted([f"ljspeech_{k}" for k in ("wpt.npy", "rfft.npy", "fingerprint.wav")]
                    + [f"fbmelgan_{k}" for k in ("wpt.npy", "rfft.npy", "wpt_diff.npy",
                                                 "rfft_diff.npy", "fingerprint.wav")])
    if files != expect:
        raise AssertionError(f"analysis.cli fingerprints wrote {files}")
    cli_err = rel_max(np.load(os.path.join(out_dir, "fbmelgan_wpt.npy")), want["fbmelgan"]["wpt"])
    log(f"  analysis.cli fingerprints wrote {files}; fbmelgan_wpt against plain {cli_err:.3e}")

    kernel = lambda: wpt_cuda.wpt_packets_cuda(x, "haar", 14)  # noqa: E731
    raw = float((kernel() - wpt.wpt_analysis(x, "haar", 14)).abs().max())
    ms = median_ms({"plain": lambda: wpt.wpt_analysis(x, "haar", 14), "kernel": kernel}, reps=10)
    device = wpt_device_ms(wpt_cuda, kernel)
    b_ms, b_by = wpt_bound(wpt, 1, t, "haar", 14)
    log(f"  one clip [1, {t}]: kernel {ms['kernel']:.4f} ms (device {ms_or_not(device)}), plain "
        f"{ms['plain']:.4f} ms, bound {b_ms:.5f} ms ({b_by}); raw max|kernel - plain| {raw:.3e} "
        f"({card_line})")
    if not raw <= RAW_ATOL:
        raise AssertionError(f"level-14 raw packets, kernel against plain: {raw} > {RAW_ATOL}")
    return {"launches": launches, "clips": clips, "samples": t, "split": plan.split,
            "in_level": plan.in_level, "rel_err": errs, "cli_files": files,
            "cli_rel_err": cli_err, "max_abs_err": raw, "kernel_ms": ms["kernel"],
            "plain_ms": ms["plain"], "device_ms": device, "bound_ms": b_ms, "bound_by": b_by}


def ig_counts(fused_cuda, pool_cuda, conv2_cuda) -> dict:
    return {"conv1_fwd": fused_cuda.FWD_LAUNCHES, "conv1_bwd": fused_cuda.BWD_LAUNCHES,
            "pool_fwd": pool_cuda.POOL_FWD_LAUNCHES, "pool_bwd": pool_cuda.POOL_BWD_LAUNCHES,
            "conv2_fwd": conv2_cuda.CONV2_FWD_LAUNCHES,
            "conv2_bwd": conv2_cuda.CONV2_BWD_LAUNCHES}


@contextlib.contextmanager
def plain_mid_blocks():
    """The DCNN's fused mid blocks through their plain PyTorch versions on
    any device, wherever autograd records (``fused_pool._run`` and
    ``fused_conv2._run``, looked up at call time, patched for the block)."""
    from audiodeepfake_detection_tpu_torch.ops import fused_conv2, fused_pool

    saved = fused_pool._run, fused_conv2._run

    def pool(x, alpha, want_stats):
        if want_stats:
            return fused_pool.plain_prelu_pool_stats(x, alpha)
        return fused_pool.plain_prelu_pool(x, alpha), None, None

    def conv2(x, w, corr, alpha, want_stats):
        if want_stats:
            return fused_conv2.plain_conv2_prelu_pool_stats(x, w, corr, alpha)
        return fused_conv2.plain_conv2_prelu_pool(x, w, corr, alpha), None, None

    fused_pool._run, fused_conv2._run = pool, conv2
    try:
        yield
    finally:
        fused_pool._run, fused_conv2._run = saved


def path_grads(model, image, target: int, m_steps: int = 200) -> torch.Tensor:
    """The gradients of ``softmax(model(path))[:, target]`` at every path
    image ``alpha * image`` (what ``integrated_grad`` integrates)."""
    alphas = torch.linspace(0.0, 1.0, m_steps + 1, device=image.device)
    path = (alphas.reshape(-1, 1, 1, 1) * image[None]).requires_grad_(True)
    probs = torch.softmax(model(path), -1)[:, target]
    return torch.autograd.grad(probs.sum(), path)[0]


def ig_phase(mods, root: str, data: str, snapshot: str, card_line: str) -> dict:
    """(b) ``run_experiment(only_ig=True)`` on phase 7's DCNN snapshot at full
    width: fused (``fused_layer1=True``, which the run switches off with
    JAX's message, ``fused_pool`` and ``fused_layer2`` at ``"always"``:
    kernels 5 and 6 forward and ``dx`` at B = 201) against the same with
    the blocks' plain versions, and against unfused; each path image's
    gradient through the kernels against their plain versions and against
    unfused; completeness; a trace; the times."""
    from audiodeepfake_detection_tpu_torch.analysis.integrated_gradients import integrated_grad
    from audiodeepfake_detection_tpu_torch.train import profiling
    from audiodeepfake_detection_tpu_torch.train.experiment import run_experiment

    fused_cuda, pool_cuda, conv2_cuda = mods
    always = dict(fused_layer1=True, fused_pool="always", fused_layer2="always")
    runs_of = {"fused": (always, contextlib.nullcontext),
               "fused_plain": (always, plain_mid_blocks),
               "unfused": (dict(fused_layer1=False), contextlib.nullcontext)}
    images = 2 * IG_PER_TARGET
    runs, maps = {}, {}
    for name, (flag, blocks) in runs_of.items():
        log_dir = f"log_ig_{name}"
        keep_snapshot(snapshot, os.path.join(root, log_dir))  # the name the args give it
        args = train_args(root, data, log_dir, aug_contrast=True, aug_noise=True,
                          cross_data_path=data, cross_sources=["ljspeech", "fbmelgan"],
                          ig_times_per_target=IG_PER_TARGET, only_ig=True, **flag)
        fused_cuda.FWD_LAUNCHES = fused_cuda.BWD_LAUNCHES = 0
        pool_cuda.POOL_FWD_LAUNCHES = pool_cuda.POOL_BWD_LAUNCHES = 0
        conv2_cuda.CONV2_FWD_LAUNCHES = conv2_cuda.CONV2_BWD_LAUNCHES = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), blocks():
            trainer = run_experiment(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ig_counts(fused_cuda, pool_cuda, conv2_cuda)
        plots = os.path.join(root, log_dir, "plots")
        maps[name] = {f.split("target-01_")[1]: np.load(os.path.join(plots, f))
                      for f in sorted(os.listdir(plots))}
        runs[name] = {"launches": counts, "wall_s": wall, "files": sorted(os.listdir(plots)),
                      "guard": "only_ig: disabling fused_layer1" in out.getvalue(),
                      "trainer": trainer}
        log(f"  {name}: {images} images, launches {counts}, files {runs[name]['files']}, "
            f"{wall:.1f} s wall")
    fused, unfused = runs["fused"], runs["unfused"]
    if not fused["guard"] or fused["trainer"].model.fused_layer1 is not False:
        raise AssertionError("only_ig left fused_layer1 on (kernel 2 has no input gradient)")
    want = {"conv1_fwd": 0, "conv1_bwd": 0, "pool_fwd": images, "pool_bwd": images,
            "conv2_fwd": images, "conv2_bwd": images}
    if fused["launches"] != want or any(
            any(runs[n]["launches"].values()) for n in ("fused_plain", "unfused")):
        raise AssertionError(f"IG launches: {({n: r['launches'] for n, r in runs.items()})}, "
                             f"fused wants {want}")
    if not all(len(r["files"]) == 3 and r["files"] == fused["files"] for r in runs.values()):
        raise AssertionError(f"IG files {[r['files'] for r in runs.values()]}")
    errs = {other: {key: rel_max(maps["fused"][key], maps[other][key]) for key in maps[other]}
            for other in ("fused_plain", "unfused")}
    ig = maps["fused"]["integrated_gradients.npy"]
    log(f"  mean maps through the kernels, relative to the largest: against their plain "
        f"versions {errs['fused_plain']}, against unfused {errs['unfused']}; "
        f"|IG| max {np.abs(ig).max():.3e}")
    if not (np.isfinite(ig).all() and np.abs(ig).max() > 0):
        raise AssertionError("attributions not finite or all zero")
    if not errs["fused_plain"]["integrated_gradients.npy"] <= IG_KERNEL_RTOL:
        raise AssertionError(f"IG, kernels 5 and 6 against plain: {errs} > {IG_KERNEL_RTOL}")
    if not errs["unfused"]["integrated_gradients.npy"] <= IG_UNFUSED_RTOL:
        raise AssertionError(f"IG, fused against unfused: {errs} > {IG_UNFUSED_RTOL}")
    if not max(e[k] for e in errs.values() for k in ("mean_images.npy", "last_image.npy")) \
            <= IG_IMAGE_RTOL:
        raise AssertionError(f"IG images differ between the runs: {errs}")

    # per path image, completeness and the times on frames of the cross test set
    fm, um = fused["trainer"].model.eval(), unfused["trainer"].model.eval()
    batch = next(iter(fused["trainer"].cross_loader_test.epoch(0, shuffle=False)))
    with torch.no_grad():
        imgs = fused["trainer"].transform(torch.from_numpy(batch["audio"][:3]).cuda())
    gf, gu = path_grads(fm, imgs[0], 1), path_grads(um, imgs[0], 1)
    with plain_mid_blocks():
        gp = path_grads(fm, imgs[0], 1)

    def rows_apart(ref):
        err = ((gf - ref).flatten(1).abs().amax(1) / ref.flatten(1).abs().amax(1)).cpu().numpy()
        return err, np.nonzero(err > IG_GRAD_RTOL)[0]

    kernel_err, kernel_apart = rows_apart(gp)
    row_err, apart = rows_apart(gu)
    log(f"  path gradients of one image through kernels 5 and 6 against their plain "
        f"versions: {len(kernel_apart)} of 201 rows above {IG_GRAD_RTOL} of their largest "
        f"(up to {kernel_err.max():.3e})")
    log(f"  the same, fused against unfused: {len(apart)} of 201 rows above {IG_GRAD_RTOL} "
        f"(alpha index {apart.tolist()[:12]}, up to {row_err.max():.3e}); alpha = 1: "
        f"{row_err[-1]:.3e}")
    if len(kernel_apart):
        raise AssertionError(f"path gradients, kernels 5 and 6 against plain: rows "
                             f"{kernel_apart.tolist()} above {IG_GRAD_RTOL} (up to "
                             f"{kernel_err.max()})")
    if not 2 * len(apart) < len(row_err):
        raise AssertionError(f"path gradients fused against unfused: {len(apart)} of "
                             f"{len(row_err)} rows above {IG_GRAD_RTOL}")
    completeness = []
    for img in imgs:
        attr = integrated_grad(fm, img, 1)
        with torch.no_grad():
            p = torch.softmax(fm(torch.stack([img, torch.zeros_like(img)])), -1)[:, 1]
        completeness.append({"sum_ig": float(attr.sum()), "delta_p": float(p[0] - p[1]),
                             "abs_gap": abs(float(attr.sum()) - float(p[0] - p[1]))})
    log(f"  completeness |sum(IG) - (P(x) - P(0))| on {len(imgs)} images: "
        f"{[float('%.3e' % c['abs_gap']) for c in completeness]} (delta P "
        f"{[float('%.3e' % c['delta_p']) for c in completeness]})")
    if not all(np.isfinite(c["abs_gap"]) for c in completeness):
        raise AssertionError(f"completeness: {completeness}")

    trace_dir = os.path.join(root, "trace")
    with profiling.trace(trace_dir):
        with profiling.annotate("integrated_grad"):
            integrated_grad(fm, imgs[0], 1)
        torch.cuda.synchronize()
    (trace_file,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace_file)) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    ranges = sum(1 for e in events if e.get("name") == "integrated_grad")
    log(f"  profiling.trace: {kernels} kernel events, {ranges} 'integrated_grad' range(s)")
    if not (kernels > 0 and ranges > 0):
        raise AssertionError("profiling.trace kept no kernel or no annotation")

    ms = median_ms({"unfused": lambda: integrated_grad(um, imgs[0], 1),
                    "fused": lambda: integrated_grad(fm, imgs[0], 1)}, reps=2)
    log(f"  IG per image (201 path images, forward and backward): fused {ms['fused']:.3f} ms, "
        f"unfused {ms['unfused']:.3f} ms ({card_line})")
    for run in runs.values():
        del run["trainer"]
    return {"runs": runs, "images": images, "launches": fused["launches"],
            "rel_err": errs, "rows_apart": apart.tolist(), "row_rel_err_max": float(row_err.max()),
            "kernel_row_rel_err_max": float(kernel_err.max()),
            "image_grad_rel_err": float(row_err[-1]), "completeness": completeness,
            "trace_kernel_events": kernels, "fused_ms": ms["fused"], "unfused_ms": ms["unfused"]}


def stats_phase(root: str, data: str, card_line: str) -> dict:
    """(c) per-node block-norm statistics of the training set (kernel 1, raw
    packets) on the card against the CPU, and the ``*_mean_std_bn`` cache
    through ``get_transforms``; (d) the scalogram's CWT and the average STFT
    energy on the card against the CPU."""
    import pickle as pkl

    from audiodeepfake_detection_tpu_torch.analysis.fingerprints import load_clips
    from audiodeepfake_detection_tpu_torch.analysis.plots import compute_scalogram
    from audiodeepfake_detection_tpu_torch.analysis.stats import average_energy
    from audiodeepfake_detection_tpu_torch.train.experiment import (
        create_data_loaders,
        norm_batches_fn,
    )
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        compute_block_norm_stats,
        get_transforms,
        norm_cache_prefix,
    )

    args = train_args(root, data, "log_bn", block_norm=True)
    batches = list(norm_batches_fn(create_data_loaders(args)[0])())
    frames = sum(len(b) for b in batches)
    compute_block_norm_stats(args, iter(batches), "cuda")  # warm
    t0 = time.perf_counter()
    gpu = compute_block_norm_stats(args, iter(batches), "cuda")
    secs = time.perf_counter() - t0
    cpu = compute_block_norm_stats(args, iter(batches), "cpu")
    nodes = sorted(cpu)
    std = np.asarray([cpu[n]["std"] for n in nodes])
    bn_err = max(
        float(np.max(np.abs(np.asarray([gpu[n][k] for n in nodes])
                            - np.asarray([cpu[n][k] for n in nodes])) / std))
        for k in ("mean", "std"))
    get_transforms(args, train_batches=lambda: iter(batches), device="cuda")
    with open(norm_cache_prefix(args) + "_mean_std_bn.pkl", "rb") as fh:
        cached = pkl.load(fh)
    log(f"  block-norm statistics: {frames} frames in {secs * 1e3:.3f} ms on the card "
        f"({frames / secs:.1f} frames/s, {card_line}); card against CPU {bn_err:.3e} of each "
        f"node's std; cache of {len(cached)} nodes")
    if not bn_err <= BLOCK_NORM_RTOL:
        raise AssertionError(
            f"block-norm statistics card against CPU: {bn_err} > {BLOCK_NORM_RTOL}")
    if cached != gpu:
        raise AssertionError("get_transforms cached other block-norm statistics")

    clips = load_clips(os.path.join(data, "A_ljspeech"), 8)
    t0 = time.perf_counter()
    scal, freqs = compute_scalogram(clips[0][:SR], SR, device="cuda")
    cwt_s = time.perf_counter() - t0
    scal_cpu, _ = compute_scalogram(clips[0][:SR], SR, device="cpu")
    cwt_err = rel_max(scal, scal_cpu)
    energy_err = rel_max(average_energy(clips, device="cuda"), average_energy(clips, device="cpu"))
    log(f"  scalogram {scal.shape} ({cwt_s * 1e3:.1f} ms on the card, host clock): card against "
        f"CPU {cwt_err:.3e}; average energy over {len(clips)} clips {energy_err:.3e}")
    if not (cwt_err <= CWT_RTOL and energy_err <= ENERGY_RTOL):
        raise AssertionError(f"CWT {cwt_err} / energy {energy_err} on the card against the CPU")
    return {"block_norm": {"frames": frames, "seconds": secs, "frames_per_s": frames / secs,
                           "rel_err": bn_err},
            "cwt": {"shape": list(scal.shape), "rel_err": cwt_err, "host_ms": cwt_s * 1e3},
            "energy_rel_err": energy_err}


def analysis_phase(wpt, mods, root: str, data: str, snapshot: str, card_line: str) -> dict:
    """Phase 25: fingerprints, integrated gradients, block-norm statistics,
    CWT and energy on the card; ``--tensorboard`` refused by name where the
    package is missing."""
    import importlib.util

    t_phase = time.perf_counter()
    wpt_cuda, fused_cuda, pool_cuda, conv2_cuda = mods
    out = {}
    log("  (a) fingerprints")
    out["fingerprints"] = fingerprint_phase(wpt, wpt_cuda, root, data, card_line)
    log("  (b) integrated gradients")
    out["ig"] = ig_phase((fused_cuda, pool_cuda, conv2_cuda), root, data, snapshot, card_line)
    log("  (c, d) block-norm statistics, CWT, energy")
    out.update(stats_phase(root, data, card_line))
    if importlib.util.find_spec("tensorboard") is None:
        from audiodeepfake_detection_tpu_torch.train.experiment import make_writer

        try:
            make_writer(train_args(root, data, "log_tb"), root, "DCNN")
        except ImportError as exc:
            if "`tensorboard` package" not in str(exc):
                raise
            log(f"  --tensorboard without the package: {exc}")
        else:
            raise AssertionError("--tensorboard ran without the tensorboard package")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 25 took {out['phase_s']:.1f} s")
    return out


# ---- data parallelism (phase 26)
# the card's machine has one card: ranks are NCCL on it alone (one rank), or
# separate processes on cuda:0 joined by gloo, which stages every
# collective through the host (tools/dist_probe.py: gloo runs all_reduce,
# broadcast and all_gather_into_tensor on CUDA tensors; FSDP2's step dies
# there, so FSDP's two-rank numerics are held on the CPU only)
MESH_RANKS = 2
MESH_LR = 1e-2  # one SGD step: the parameters move by lr x the gradient
# the update (parameters after one SGD step less before) of the two-rank
# DDP step against one process at B = 128, per tensor, relative to its
# largest entry: the same gradients summed in another order (each rank's
# cuDNN weight gradient over 64 frames, then the ranks' sum) and the
# BatchNorm's one-pass moments against cuDNN's centred ones; the updates
# are ~1e-5 (lr 1e-2).  First set at 1e-2 from phase 10 (cuDNN moves a
# first-block dW by 3e-3 of its largest entry between two orders); the
# card read 1.04e-2 (DCNN, fused: dil_conv.4.bias), 7.8e-3 (unfused) and
# 2.07e-2 (LCNN: lcnn.13.weight), NVIDIA H100 80GB HBM3, 700 W, so the
# bound is 5e-2.  A fault shows at O(1): a gradient not averaged over the
# ranks doubles the update, and moments not summed move the loss and the
# buffers (read: 8.6e-8 and <= 3e-6)
MESH_UPDATE_RTOL = 5e-2
# running buffers of the same steps, relative to each buffer's largest
# entry: one-pass moments summed over two ranks against cuDNN's centred
# ones over 128 frames
MESH_BUFFER_RTOL = 1e-4
# level-14 haar of a 196,608-sample clip over two ranks (a stride-2 conv1d a
# level, cuDNN) against kernel 1's dense cascade: fp32 sums of two taps a
# level in another order; the JAX package's own bound for this pair on the
# CPU (tests/test_parallel.py::test_level14_haar_design_point)
SP_RAW_ATOL = 2e-4
# the mean |WPT| spectra of the corpus, the same two routes, relative to
# the largest entry
SP_SPECTRUM_RTOL = 1e-5
GLOO_CHECKS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all_single",
               "ddp_step", "fsdp2_step")


def free_port() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


@contextlib.contextmanager
def torchrun_env(rank: int, world: int):
    """torchrun's variables for this process (a fresh port)."""
    env = {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": free_port()}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_main(mods, root: str, data: str, mode: str) -> dict:
    """``experiment.main`` with ``--<mode>`` under a one-rank torchrun
    environment (NCCL), the headline DCNN with all three flags, dropout 0;
    the Trainer it ran and kernels 1, 2, 5 and 6's launches over the run."""
    import torch.distributed as dist

    from audiodeepfake_detection_tpu_torch.train import experiment

    trainers = []
    run = experiment.run_experiment

    def record(*a, **kw):
        trainers.append(run(*a, **kw))
        return trainers[-1]

    experiment.run_experiment = record
    dcnn_counts(mods, reset=True)
    t0 = time.perf_counter()
    try:
        with torchrun_env(0, 1):
            sweep_main(root, data, f"log_mesh_{mode}", [0], {"fused_layer2": [True]},
                       "--fused-layer1", "train", "--fused-pool", "train",
                       "--dropout-cnn", "0", "--dropout-lstm", "0", f"--{mode}")
    finally:
        experiment.run_experiment = run
    torch.cuda.synchronize()
    counts = dcnn_counts(mods)
    (trainer,) = trainers
    if dist.is_initialized() or trainer.mesh is None:
        raise AssertionError(f"--{mode}: group left {dist.is_initialized()}, mesh {trainer.mesh}")
    return {"trainer": trainer, "launches": counts, "wall_s": time.perf_counter() - t0}


def sgd_step_state(model, transform, batch, run=None):
    """One SGD step (``run`` is the wrapped model, if any): the loss and the
    state dict after it, on the CPU."""
    from audiodeepfake_detection_tpu_torch.train.steps import make_train_step

    opt = torch.optim.SGD(model.parameters(), lr=MESH_LR)
    stats = make_train_step(run or model, transform, opt)(batch)
    return stats, {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()}


def dcnn_transform(norm):
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    return normalized_transform(make_transform(train_args("", "", "")),
                                *[np.asarray(v) for v in norm])


MESH_FLAGS = {"fused": dict(fused_layer1=True, fused_pool=True, fused_layer2=True),
              "unfused": {}}


def mesh_rank_worker(directory: str, rank: int) -> None:
    """One of the two gloo ranks on ``cuda:0`` (``--mesh-rank``): (b) a
    full-width DCNN step at 64 frames a rank, fused and unfused, and an LCNN
    step with kernel 3, each under DDP with the synchronized BatchNorm,
    launches counted; the fused step timed; (c) level-14 haar
    fingerprints of the corpus over the two ranks, one clip whole and
    timed."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from audiodeepfake_detection_tpu_torch.analysis.fingerprints import (
        generator_fingerprints, load_clips)
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
    from audiodeepfake_detection_tpu_torch.ops import (
        fused_conv1_cuda, fused_conv2_cuda, fused_pool_cuda, wpt_cuda)
    from audiodeepfake_detection_tpu_torch.parallel.mesh import (
        all_reduce_sum, get_mesh, mesh_group, shard_batch)
    from audiodeepfake_detection_tpu_torch.parallel.sequence import sp_wpt_analysis

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    store = dist.FileStore(os.path.join(directory, "store"), MESH_RANKS)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=MESH_RANKS)
    mesh = get_mesh("cuda")
    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    mods = (wpt_cuda, fused_conv1_cuda, fused_pool_cuda, fused_conv2_cuda)
    transform = dcnn_transform(inputs["norm"])
    batch = shard_batch(mesh, {k: v.cuda() for k, v in inputs["batch"].items()})

    def global_loss(stats):
        return float(all_reduce_sum((stats["loss"].reshape(1),), mesh)[0]) / MESH_RANKS

    out = {}
    for form, flags in MESH_FLAGS.items():
        model = DCNN(time_dim=12, dropout_cnn=0.0, dropout_lstm=0.0, mesh=mesh, **flags).cuda()
        model.load_state_dict(inputs["dcnn"])
        ddp = DistributedDataParallel(model, device_ids=[0], process_group=mesh_group(mesh),
                                      broadcast_buffers=False)
        dcnn_counts(mods, reset=True)
        stats, state = sgd_step_state(model, transform, batch, ddp)
        torch.cuda.synchronize()
        out[form] = {"loss": global_loss(stats), "state": state, "launches": dcnn_counts(mods)}
        if form == "fused":
            from audiodeepfake_detection_tpu_torch.train.steps import make_optimizer, make_train_step

            step = make_train_step(ddp, transform, make_optimizer(model.parameters(), 4e-4, 1e-3))
            out["step_ms"] = windows_ms({"ddp_gloo": lambda: step(batch)}, reps=2,
                                        windows=3)["ddp_gloo"]
        del model, ddp
    lcnn = LCNN(fused_layer1=True, dropout=0.0, mesh=mesh).cuda()
    lcnn.load_state_dict(inputs["lcnn"])
    ddp = DistributedDataParallel(lcnn, device_ids=[0], process_group=mesh_group(mesh),
                                  broadcast_buffers=False)
    fused_conv1_cuda.MFM_FWD_LAUNCHES = fused_conv1_cuda.MFM_BWD_LAUNCHES = 0
    image = shard_batch(mesh, {k: v.cuda() for k, v in inputs["lcnn_batch"].items()})
    stats, state = sgd_step_state(lcnn, lambda a: a, image, ddp)
    torch.cuda.synchronize()
    out["lcnn"] = {"loss": global_loss(stats), "state": state,
                   "launches": {"mfm_fwd": fused_conv1_cuda.MFM_FWD_LAUNCHES,
                                "mfm_bwd": fused_conv1_cuda.MFM_BWD_LAUNCHES}}
    del lcnn, ddp

    # (c) the sequence-parallel cascade: no launch of kernel 1
    wpt_cuda.LAUNCHES = wpt_cuda.LEVEL_LAUNCHES = 0
    spectra = generator_fingerprints(inputs["data"], ["fbmelgan"], real_name="ljspeech",
                                     wavelet="haar", level=14, max_files=FINGERPRINT_CLIPS,
                                     device="cuda", mesh=mesh)
    clip = load_clips(os.path.join(inputs["data"], "A_ljspeech"), 1)[0]
    block = MESH_RANKS << 14
    x = torch.from_numpy(clip[None, : len(clip) // block * block]).cuda()
    whole = sp_wpt_analysis(x, "haar", 14, mesh)
    torch.cuda.synchronize()
    out["sp"] = {"spectra": spectra, "clip": whole.cpu(), "kernel_launches": wpt_cuda.LAUNCHES,
                 "ms": windows_ms({"sp": lambda: sp_wpt_analysis(x, "haar", 14, mesh)},
                                  reps=3, windows=3)["sp"]}
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def update_rel(got: dict, want: dict, before: dict, keys) -> dict:
    """Per tensor: the largest difference of two steps' updates relative to
    the tensor's largest update entry, and that entry."""
    out = {}
    for k in keys:
        du, dv = got[k] - before[k], want[k] - before[k]
        scale = float(dv.abs().max())
        out[k] = (float((du - dv).abs().max()) / scale if scale > 0 else 0.0, scale)
    return out


def worst_update(rel: dict) -> float:
    return max(v[0] for v in rel.values())


def buffer_rel(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max() / want[k].abs().max())
               for k in want if "running_" in k)


def mesh_two_ranks(root: str, data: str, norm, card_line: str) -> dict:
    """(b) and (c): two gloo processes on ``cuda:0`` (``--mesh-rank``)
    against one process at B = 128 and kernel 1's dense cascade."""
    from audiodeepfake_detection_tpu_torch.analysis.fingerprints import load_clips
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
    from audiodeepfake_detection_tpu_torch.ops import wpt_cuda
    from audiodeepfake_detection_tpu_torch.ops.wpt import wpt_analysis

    directory = os.path.join(root, "mesh")
    os.makedirs(directory)
    torch.manual_seed(0)
    dcnn = DCNN(time_dim=12).state_dict()
    torch.manual_seed(1)
    lcnn = LCNN().state_dict()
    gen = torch.Generator().manual_seed(14)
    inputs = {"dcnn": dcnn, "lcnn": lcnn, "norm": [np.asarray(v) for v in norm], "data": data,
              "batch": {k: torch.from_numpy(v) for k, v in host_batches(1, seed=12)[0].items()},
              "lcnn_batch": {"audio": torch.randn(BATCH, 1, 256, 101, generator=gen),
                             "label": torch.randint(0, 2, (BATCH,), generator=gen)}}
    torch.save(inputs, os.path.join(directory, "inputs.pt"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                               directory, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MESH_RANKS)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise AssertionError("two-rank workers failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{o[-8000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    ranks = [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
             for r in range(MESH_RANKS)]
    wall = time.perf_counter() - t0

    # one process at B = 128 from the same weights and batch
    transform = dcnn_transform(norm)
    batch = {k: v.cuda() for k, v in inputs["batch"].items()}
    before = {k: v.float().clone() for k, v in dcnn.items()}
    out = {"wall_s": wall}
    for form, flags in MESH_FLAGS.items():
        model = DCNN(time_dim=12, dropout_cnn=0.0, dropout_lstm=0.0, **flags).cuda()
        model.load_state_dict(dcnn)
        stats, want = sgd_step_state(model, transform, batch)
        # the card's own floor: the same one-process step again
        model.load_state_dict(dcnn)
        _, again = sgd_step_state(model, transform, batch)
        got = ranks[0][form]
        same = all(torch.equal(got["state"][k], ranks[1][form]["state"][k]) for k in want)
        params = [k for k in want if "running_" not in k and "num_batches" not in k]
        row = {"loss": got["loss"], "single_loss": float(stats["loss"]),
               "loss_rel": abs(got["loss"] - float(stats["loss"])) / abs(float(stats["loss"])),
               "update_rel_per_tensor": update_rel(got["state"], want, before, params),
               "buffer_rel": buffer_rel(got["state"], want), "ranks_bit_equal": same,
               "launches": [r[form]["launches"] for r in ranks]}
        row["update_rel"] = worst_update(row["update_rel_per_tensor"])
        row["update_rel_repeat"] = worst_update(update_rel(again, want, before, params))
        out[form] = row
        top = sorted(row["update_rel_per_tensor"].items(), key=lambda kv: -kv[1][0])[:4]
        log(f"  (b) {form} DCNN step, 2 gloo ranks x 64 against one process x 128: loss "
            f"{row['loss']:.6f} / {row['single_loss']:.6f} (rel {row['loss_rel']:.2e}), update "
            f"{row['update_rel']:.2e} (worst tensors, (rel, largest update): {top}; one process "
            f"against itself {row['update_rel_repeat']:.2e}), buffers "
            f"{row['buffer_rel']:.2e}, ranks bit-equal {same}, launches per rank "
            f"{row['launches']}")
        if not (row["loss_rel"] <= LOSS_RTOL and row["update_rel"] <= MESH_UPDATE_RTOL
                and row["buffer_rel"] <= MESH_BUFFER_RTOL and same):
            raise AssertionError(f"two-rank {form} DCNN step: {row}")
        del model
    want_fused = {"conv1_fwd": 1, "conv1_bwd": 1, "pool_fwd": 1, "pool_bwd": 1,
                  "conv2_fwd": 1, "conv2_bwd": 1}
    for counts in out["fused"]["launches"]:
        if counts["wpt"] < 1 or any(counts[k] != v for k, v in want_fused.items()):
            raise AssertionError(f"fused two-rank launches {counts}, want {want_fused}")
    if any(v for c in out["unfused"]["launches"] for k, v in c.items() if k != "wpt"):
        raise AssertionError(f"unfused two-rank launches {out['unfused']['launches']}")

    lcnn_model = LCNN(fused_layer1=True, dropout=0.0).cuda()
    lcnn_model.load_state_dict(lcnn)
    image = {k: v.cuda() for k, v in inputs["lcnn_batch"].items()}
    stats, want = sgd_step_state(lcnn_model, lambda a: a, image)
    got = ranks[0]["lcnn"]
    params = [k for k in want if "running_" not in k and "num_batches" not in k]
    row = {"loss": got["loss"], "single_loss": float(stats["loss"]),
           "loss_rel": abs(got["loss"] - float(stats["loss"])) / abs(float(stats["loss"])),
           "update_rel_per_tensor": update_rel(
               got["state"], want, {k: v.float() for k, v in lcnn.items()}, params),
           "buffer_rel": buffer_rel(got["state"], want),
           "ranks_bit_equal": all(torch.equal(got["state"][k], ranks[1]["lcnn"]["state"][k])
                                  for k in want),
           "launches": [r["lcnn"]["launches"] for r in ranks]}
    row["update_rel"] = worst_update(row["update_rel_per_tensor"])
    out["lcnn"] = row
    top = sorted(row["update_rel_per_tensor"].items(), key=lambda kv: -kv[1][0])[:4]
    log(f"  (b) LCNN step (kernel 3), 2 gloo ranks x 64 against one process x 128: loss "
        f"{row['loss']:.6f} / {row['single_loss']:.6f} (rel {row['loss_rel']:.2e}), update "
        f"{row['update_rel']:.2e} (worst tensors: {top}), buffers {row['buffer_rel']:.2e}, "
        f"ranks bit-equal {row['ranks_bit_equal']}, launches per rank {row['launches']}")
    if not (row["loss_rel"] <= LOSS_RTOL and row["update_rel"] <= MESH_UPDATE_RTOL
            and row["buffer_rel"] <= MESH_BUFFER_RTOL and row["ranks_bit_equal"]
            and all(c == {"mfm_fwd": 1, "mfm_bwd": 1} for c in row["launches"])):
        raise AssertionError(f"two-rank LCNN step: {row}")
    del lcnn_model
    out["step_ms_host_staged"] = [r["step_ms"] for r in ranks]
    log(f"  (d) fused DCNN step over 2 gloo ranks on one card at 64 a rank, HOST-STAGED "
        f"collectives [{card_line}]: {[round(r['step_ms']['ms'], 3) for r in ranks]} ms "
        f"(windows {[r['step_ms']['windows_ms'] for r in ranks]})")

    # (c) the same crops through kernel 1 and the plain cascade
    sp = ranks[0]["sp"]
    block = MESH_RANKS << 14
    spectra = {}
    for name, gen_dir in (("ljspeech", "A_ljspeech"), ("fbmelgan", "B_fbmelgan")):
        acc = {"kernel": 0.0, "plain": 0.0}
        clips = load_clips(os.path.join(data, gen_dir), FINGERPRINT_CLIPS)
        for clip in clips:
            x = torch.from_numpy(clip[None, : len(clip) // block * block]).cuda()
            acc["kernel"] = acc["kernel"] + wpt_cuda.wpt_packets(x, "haar", 14, False, 2.0)[0] \
                .abs().mean(-1)
            acc["plain"] = acc["plain"] + wpt_analysis(x, "haar", 14)[0].abs().mean(-1)
        spectra[name] = {k: (v / len(clips)).cpu().numpy() for k, v in acc.items()}
    spec_err = {f"{n}_{k}": rel_max(sp["spectra"][n]["wpt"], spectra[n][k])
                for n in spectra for k in ("kernel", "plain")}
    clip = load_clips(os.path.join(data, "A_ljspeech"), 1)[0]
    x = torch.from_numpy(clip[None, : len(clip) // block * block]).cuda()
    kernel = lambda: wpt_cuda.wpt_packets_cuda(x, "haar", 14)  # noqa: E731
    raw = {"kernel": float((sp["clip"] - kernel().cpu()).abs().max()),
           "plain": float((sp["clip"] - wpt_analysis(x, "haar", 14).cpu()).abs().max())}
    same = torch.equal(sp["clip"], ranks[1]["sp"]["clip"])
    dense_ms = median_ms({"kernel": kernel}, reps=10)["kernel"]
    out["sp"] = {"spectrum_rel": spec_err, "raw_abs": raw, "ranks_bit_equal": same,
                 "samples": int(x.shape[-1]), "kernel_launches": sp["kernel_launches"],
                 "sp_ms": [r["sp"]["ms"] for r in ranks], "dense_kernel_ms": dense_ms}
    log(f"  (c) level-14 haar over 2 gloo ranks, {2 * FINGERPRINT_CLIPS} clips cropped to "
        f"{x.shape[-1]} samples: spectra against kernel 1 / plain {spec_err}; one clip raw "
        f"{raw}, ranks bit-equal {same}; kernel-1 launches in the sharded cascade "
        f"{sp['kernel_launches']}")
    log(f"  (d) one clip [{card_line}]: sp_wpt_analysis over 2 gloo ranks (HOST-STAGED) "
        f"{[round(r['sp']['ms']['ms'], 3) for r in ranks]} ms against kernel 1 dense "
        f"{dense_ms:.4f} ms")
    if not (max(spec_err.values()) <= SP_SPECTRUM_RTOL and max(raw.values()) <= SP_RAW_ATOL
            and same and sp["kernel_launches"] == 0):
        raise AssertionError(f"sequence-parallel WPT over 2 ranks: {out['sp']}")
    return out


def mesh_nccl_steps(mods, fa_cuda, norm, ast_norm, card_line: str) -> dict:
    """(a) one FSDP step of the base384 AST (kernel 4) and (d) the fused
    DCNN step at B = 128 under a one-rank NCCL group: plain, DDP and FSDP,
    timed in one call."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from audiodeepfake_detection_tpu_torch.data.loader import batch_to_device
    from audiodeepfake_detection_tpu_torch.models.ast import ASTModel
    from audiodeepfake_detection_tpu_torch.models.layers import use_mesh
    from audiodeepfake_detection_tpu_torch.parallel.fsdp import shard_fsdp
    from audiodeepfake_detection_tpu_torch.parallel.mesh import get_mesh, mesh_group
    from audiodeepfake_detection_tpu_torch.train.steps import make_optimizer, make_train_step
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = get_mesh("cuda", min_ranks=1)
        flags = MESH_FLAGS["fused"]
        fixed = batch_to_device(host_batches(1, seed=10)[0], torch.device("cuda"))
        fns = {}
        model, transform, opt = dcnn_step_parts(norm, **flags)
        plain = make_train_step(model, transform, opt)
        fns["plain"] = lambda: plain(fixed)
        model2, transform2, _ = dcnn_step_parts(norm, **flags)
        use_mesh(model2, mesh)
        ddp = DistributedDataParallel(model2, device_ids=[0], process_group=mesh_group(mesh),
                                      broadcast_buffers=False)
        ddp_step = make_train_step(ddp, transform2, make_optimizer(model2.parameters(), 4e-4, 1e-3))
        fns["ddp"] = lambda: ddp_step(fixed)
        model3, transform3, _ = dcnn_step_parts(norm, **flags)
        use_mesh(model3, mesh)
        shard_fsdp(model3, mesh)
        fsdp_step = make_train_step(model3, transform3,
                                    make_optimizer(model3.parameters(), 4e-4, 1e-3))
        fns["fsdp"] = lambda: fsdp_step(fixed)
        steps = windows_ms(fns, reps=3)
        for row in steps.values():
            row["frames_per_s"] = BATCH / row["ms"] * 1e3
        # where DDP's time goes on one rank: device time by kernel group
        profiles = {name: profile_train(fns[name]) for name in ("plain", "ddp")}
        log(f"  (d) fused DCNN step at B={BATCH}, one NCCL rank [{card_line}]: " + ", ".join(
            f"{k} {v['ms']:.3f} ms (windows {['%.3f' % w for w in v['windows_ms']]}, spread "
            f"{v['spread_pct']:.1f} %)" for k, v in steps.items()))
        del fns, plain, ddp, ddp_step, fsdp_step, model, model2, model3

        # one FSDP step of phase 18's AST, kernel 4 in its blocks (each block
        # a unit of its own at the default min_bytes)
        args = ast_args("", "", "")
        ast_transform = normalized_transform(make_transform(args),
                                             *[np.asarray(v) for v in ast_norm])
        gen = torch.Generator().manual_seed(6)
        batch = {"audio": (0.3 * torch.randn(AST_BATCH, 1, SR, generator=gen)).cuda(),
                 "label": torch.randint(0, 2, (AST_BATCH,), generator=gen).cuda()}
        with torch.no_grad():
            tdim = ast_transform(batch["audio"]).shape[-1]
        torch.manual_seed(0)
        ast = ASTModel(input_tdim=tdim, fused_attention=True).cuda()
        shard_fsdp(ast, mesh)
        ast_step = make_train_step(ast, ast_transform, make_optimizer(
            ast.parameters(), args.learning_rate, args.weight_decay))
        fa_cuda.MHA_FWD_LAUNCHES = fa_cuda.MHA_BWD_LAUNCHES = 0
        stats = ast_step(batch)
        torch.cuda.synchronize()
        ast_launches = {"fwd": fa_cuda.MHA_FWD_LAUNCHES, "bwd": fa_cuda.MHA_BWD_LAUNCHES}
        blocks = len(ast.v.blocks)
        loss = float(stats["loss"])
        ast_ms = windows_ms({"fsdp_ast": lambda: ast_step(batch)}, reps=2, windows=3)["fsdp_ast"]
        log(f"  (a) one FSDP step of the base384 AST on one NCCL rank: loss {loss:.6f}, "
            f"kernel 4 launches {ast_launches} ({blocks} blocks), then {ast_ms['ms']:.3f} ms a "
            f"step [{card_line}]")
        if ast_launches != {"fwd": blocks, "bwd": blocks} or not np.isfinite(loss):
            raise AssertionError(f"FSDP AST step: loss {loss}, kernel 4 launches {ast_launches}")
        del ast, ast_step
    finally:
        dist.destroy_process_group()
    return {"steps": steps, "profile": profiles,
            "ast": {"loss": loss, "launches": ast_launches, "ms": ast_ms}}


def gloo_collectives() -> dict:
    """What gloo performs on CUDA tensors on this machine: two processes on
    ``cuda:0`` (``tools/dist_probe.py``; point-to-point is left out: a
    rank that tries it aborts)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "dist_probe.py")
    spec = importlib.util.spec_from_file_location("dist_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe.probe(MESH_RANKS, "gloo", timeout=180, only=GLOO_CHECKS)


def mesh_phase(mods, fa_cuda, root: str, data: str, norm, ast_norm, mid_losses,
               card_line: str) -> dict:
    """Phase 26: (a) the headline DCNN through ``main`` with ``--ddp`` and
    ``--fsdp`` on one NCCL rank against phase 15's run (b) without a group,
    and an FSDP step of the AST; (b), (c) two gloo ranks on the card; (d)
    the times; and which collectives gloo runs on CUDA tensors here."""
    t_phase = time.perf_counter()
    out = {}
    steps = EPOCHS * STEPS_PER_EPOCH
    for mode in ("ddp", "fsdp"):
        run = mesh_main(mods, root, data, mode)
        trainer = run.pop("trainer")
        losses = [row[2] for row in trainer.loss_list]
        worst = loss_rel_diff(losses, mid_losses)
        want = {"conv1_fwd": steps, "conv1_bwd": steps, "pool_fwd": steps, "pool_bwd": steps,
                "conv2_fwd": steps, "conv2_bwd": steps}
        log(f"  (a) main --{mode}, one NCCL rank: losses {['%.6f' % v for v in losses]} (worst "
            f"rel diff to phase 15's run without a group {worst:.2e}), test "
            f"{trainer.test_results}, launches {run['launches']}, {run['wall_s']:.1f} s wall")
        if any(run["launches"][k] != v for k, v in want.items()) or run["launches"]["wpt"] < steps:
            raise AssertionError(f"--{mode} launch counts {run['launches']}, want {want}")
        if not worst <= LOSS_RTOL:
            raise AssertionError(f"--{mode} losses differ by {worst} > {LOSS_RTOL}")
        if not os.path.exists(trainer.snapshot_path) or not os.path.exists(trainer.state_path):
            raise AssertionError(f"--{mode} wrote no snapshot")
        out[mode] = {**run, "losses": losses, "loss_rel_diff": worst,
                     "test": list(trainer.test_results)}
        del trainer
    out["nccl"] = mesh_nccl_steps(mods, fa_cuda, norm, ast_norm, card_line)
    out["two_ranks"] = mesh_two_ranks(root, data, norm, card_line)
    t0 = time.perf_counter()
    out["gloo_cuda"] = gloo_collectives()
    answers = {name: sorted({str(r.get(name, r.get("exit"))) for r in out["gloo_cuda"].values()})
               for name in GLOO_CHECKS}
    log(f"  gloo on CUDA tensors, 2 processes on cuda:0 ({time.perf_counter() - t0:.1f} s): "
        f"{answers}")
    log("  FSDP over 2 gloo ranks on one card: not run (gloo's FSDP2 step dies on CUDA "
        "tensors, above); its two-rank numerics are held on the CPU only "
        "(tests/test_torch_parallel.py)")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---- the AST's model parallelism (phase 27)
MP_RANKS = 2
MP_BATCH = 32  # the pipeline's batch: 4 microbatches of 8 frames
MP_MICROBATCHES = 4
TP_BATCH = 8  # tensor parallelism: two all-reduces a block each way, host-staged
TP_HEADS = AST_SHAPE[2] // MP_RANKS  # 6 heads of 64 a rank
MP_LR, MP_WD = 1e-4, 0.01  # phase 18's AST optimizer
# TP logits against one process, relative to the largest logit: each
# row-parallel output summed over two ranks in another order than one
# GEMM's k-loop, in each of 12 blocks
TP_LOGIT_RTOL = 1e-5
# TP gradients, gathered, against one process, of each tensor's largest
# entry: the same reordered sums, through the backward
TP_GRAD_RTOL = 1e-4
# the pipeline: the same kernels on other batch splits (microbatches of 8
# for cuBLAS), the gradients summed over the stages
PP_LOGIT_RTOL = 1e-5
PP_GRAD_RTOL = 2e-4
# remat_policy against no remat: the same kernels on the same inputs recompute
# the same bits; 1e-6 of each tensor's largest entry allows a reordered sum
REMAT_RTOL = 1e-6
MP_LAUNCHES = {"tp": {"fwd": AST_BLOCKS, "bwd": AST_BLOCKS},
               # 6 blocks a stage x (M + S - 1) = 5 ticks, the bubble ticks too
               "pp": {"fwd": 30, "bwd": 30}}


def tensor_rel(got: dict, want: dict) -> float:
    """Largest difference over tensors, each relative to its largest entry."""
    return max(float((got[k].float() - want[k].float()).abs().max()
                     / want[k].float().abs().max().clamp(min=1e-30)) for k in want)


def logits_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def fresh_ast(state, **kw):
    """A base384 AST with the fused attention, built on the card, holding
    ``state``."""
    from audiodeepfake_detection_tpu_torch.models.ast import ASTModel

    with torch.device("cuda"):
        model = ASTModel(fused_attention=True, **kw)
    model.load_state_dict(state)
    return model


def ast_grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def state_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for key, val in model.state_dict().items():
        h.update(key.encode())
        h.update(val.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def mp_rank_worker(directory: str, rank: int) -> None:
    """One of phase 27's two gloo ranks on ``cuda:0`` (``--mp-rank``): (a)
    the base384 AST tensor-parallel over ``("data", "model") = (1, 2)``: one
    forward and backward at B = 8 (kernel 4 on 6 heads a rank, counted, its
    head counts read by a spy), the gathered gradients and state, the
    forward timed; (b) the pipeline over ``("data", "stage") = (1, 2)`` at B
    = 32 in 4 microbatches: logits and combined gradients, kernel 4
    counted, then two Trainer steps with the mesh, a snapshot, the state's
    digest and the step timed.  Rank 0 also holds each against one
    process's unsharded model."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from audiodeepfake_detection_tpu_torch.ops import flash_attention_cuda as fa_cuda
    from audiodeepfake_detection_tpu_torch.parallel.mesh import data_stage_mesh, get_mesh
    from audiodeepfake_detection_tpu_torch.parallel.pipeline import (
        combine_pp_grads, pp_ast_logits)
    from audiodeepfake_detection_tpu_torch.parallel.tensor import (
        full_ast_state, shard_ast_params)
    from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
    from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    store = dist.FileStore(os.path.join(directory, "store"), MP_RANKS)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=MP_RANKS)
    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    state = inputs["state"]
    x, y = inputs["images"].cuda(), inputs["labels"].cuda()
    xt, yt = x[:TP_BATCH], y[:TP_BATCH]

    def counts():
        torch.cuda.synchronize()
        return {"fwd": fa_cuda.MHA_FWD_LAUNCHES, "bwd": fa_cuda.MHA_BWD_LAUNCHES}

    ref = {}
    if rank == 0:  # one process, unsharded, on the same inputs
        model = fresh_ast(state)
        for name, (xb, yb) in (("tp", (xt, yt)), ("pp", (x, y))):
            model.zero_grad(set_to_none=True)
            logits = model(xb)
            F.cross_entropy(logits, yb).backward()
            ref[name] = (logits.detach(), ast_grads(model))
        del model
    out = {}

    # (a) tensor parallelism
    mesh = get_mesh("cuda", axis_names=("data", "model"), shape=(1, MP_RANKS))
    model = shard_ast_params(fresh_ast(state), mesh)
    heads, forward = [], fa_cuda.forward

    def spy(qkv, h, scale, want_stats):
        heads.append(h)
        return forward(qkv, h, scale, want_stats)

    fa_cuda.forward = spy
    fa_cuda.MHA_FWD_LAUNCHES = fa_cuda.MHA_BWD_LAUNCHES = 0
    logits = model(xt)
    F.cross_entropy(logits, yt).backward()
    launches = counts()
    fa_cuda.forward = forward
    grads = full_ast_state(model, mesh, tensors={n: p.grad for n, p in model.named_parameters()})
    gathered = full_ast_state(model, mesh)
    row = {"launches": launches, "heads": sorted(set(heads)),
           "state_bit_equal": all(torch.equal(gathered[k].cpu(), v) for k, v in state.items())}
    if rank == 0:
        row["logits_rel"] = logits_rel(logits, ref["tp"][0])
        row["grad_rel"] = tensor_rel(grads, ref["tp"][1])
    del grads, gathered
    with torch.no_grad():
        row["forward_ms"] = windows_ms({"tp": lambda: model(xt)}, reps=2, windows=3)["tp"]
    out["tp"] = row
    del model, logits

    # (b) the pipeline
    mesh = data_stage_mesh(MP_RANKS, "cuda")
    model = fresh_ast(state)
    fa_cuda.MHA_FWD_LAUNCHES = fa_cuda.MHA_BWD_LAUNCHES = 0
    logits = pp_ast_logits(model, x, mesh, MP_MICROBATCHES, data_axis="data")
    F.cross_entropy(logits, y).backward()
    combine_pp_grads(model, mesh, "stage", "data")
    row = {"launches": counts()}
    if rank == 0:
        row["logits_rel"] = logits_rel(logits, ref["pp"][0])
        row["grad_rel"] = tensor_rel(ast_grads(model), ref["pp"][1])
    del model, logits, ref
    args = default_config()
    args.update(learning_rate=MP_LR, weight_decay=MP_WD, seed=0, pp_stages=MP_RANKS,
                pp_microbatches=MP_MICROBATCHES)
    trainer = Trainer(fresh_ast(state), lambda a: a, DotDict(args),
                      os.path.join(directory, "pp_trainer"), device="cuda", mesh=mesh)
    batch = {"audio": x, "label": y}
    fa_cuda.MHA_FWD_LAUNCHES = fa_cuda.MHA_BWD_LAUNCHES = 0
    row["trainer_losses"] = [float(trainer.train_step(batch)["loss"]) for _ in range(2)]
    row["trainer_launches"] = counts()
    trainer.save_snapshot(0)
    trainer.model.eval()
    with torch.no_grad():
        row["eval_logits"] = trainer.model(x[:8]).cpu()
    row["digest"] = state_digest(trainer.model)
    row["snapshot"] = trainer.snapshot_path
    row["step_ms"] = windows_ms({"pp": lambda: trainer.train_step(batch)}, reps=1,
                                windows=3)["pp"]
    out["pp"] = row
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def mha_new_shapes(fa, fa_cuda) -> dict:
    """Kernel 4 against its plain version at phase 27's shapes: a rank's 6
    local heads at B = 8 (tensor parallelism) and one microbatch of 8
    frames with 12 heads (the pipeline), N = 227."""
    out = {}
    for i, (name, (b, heads)) in enumerate({"tp": (TP_BATCH, TP_HEADS),
                                            "pp": (MP_BATCH // MP_MICROBATCHES, 12)}.items()):
        qkv, g = mha_case(b, AST_SHAPE[1], heads, torch.float32, seed=270 + i)
        want = fa.plain_mha_packed(qkv, heads, 0.125)
        (wgrad,) = torch.autograd.grad(want, qkv, g)
        y, dqkv = mha_run(fa, fa_cuda, qkv, g, heads)
        torch.cuda.synchronize()
        out[f"{name}-B{b}-N{AST_SHAPE[1]}-H{heads}"] = row = {
            "fwd_max_abs_err": (y - want).abs().max().item(), "dqkv_rel_err": rel_err(dqkv, wgrad)}
        log(f"  kernel 4 at the {name} shape [{b}, {AST_SHAPE[1]}, 3 x {heads} x 64] against "
            f"plain: out max|err| {row['fwd_max_abs_err']:.3e}, dqkv rel "
            f"{row['dqkv_rel_err']:.2e}")
        if not (row["fwd_max_abs_err"] <= MHA_FWD_ATOL and row["dqkv_rel_err"] <= MHA_GRAD_RTOL):
            raise AssertionError(f"kernel 4 at the {name} shape: {row}")
    return out


def remat_runs(fa_cuda, state, x, y) -> dict:
    """(c) one base384 training step (forward, backward) under no remat,
    ``remat_blocks`` and each supported ``remat_policy``: loss and gradients
    against no remat, kernel 4's launches, the peak of allocated memory."""
    import torch.nn.functional as F

    from audiodeepfake_detection_tpu_torch.models.ast import REMAT_POLICIES

    model = fresh_ast(state).train()
    out, base = {}, None
    for name in ("none", "remat_blocks", *REMAT_POLICIES):
        model.remat_blocks = name != "none"
        model.remat_policy = name if name in REMAT_POLICIES else None
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # allocated before the step: the weights, and no remat's gradients
        # kept for the comparison after the first run
        before = torch.cuda.memory_allocated() / 2**20
        fa_cuda.MHA_FWD_LAUNCHES = fa_cuda.MHA_BWD_LAUNCHES = 0
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        row = {"loss": float(loss.detach()), "launches": {"fwd": fa_cuda.MHA_FWD_LAUNCHES,
                                                          "bwd": fa_cuda.MHA_BWD_LAUNCHES},
               "peak_mib": peak, "before_mib": before, "step_peak_mib": peak - before}
        grads = ast_grads(model)
        if base is None:
            base = (row["loss"], grads)
        row["loss_diff"] = abs(row["loss"] - base[0])
        row["grad_rel"] = tensor_rel(grads, base[1])
        saved = name == "none" or REMAT_POLICIES.get(name) == "all"
        want = {"fwd": AST_BLOCKS * (1 if saved else 2), "bwd": AST_BLOCKS}
        log(f"  (c) {name}: loss {row['loss']:.6f} (diff {row['loss_diff']:.1e}), gradients "
            f"{row['grad_rel']:.1e} of each tensor's largest from no remat, kernel 4 "
            f"{row['launches']} (want {want}), peak {row['peak_mib']:.0f} MiB, "
            f"{row['step_peak_mib']:.0f} of them above what the step found allocated")
        if not (row["loss_diff"] <= REMAT_RTOL and row["grad_rel"] <= REMAT_RTOL
                and row["launches"] == want):
            raise AssertionError(f"remat {name}: {row}")
        out[name] = row
        del grads, loss
    del model, base
    return out


def model_parallel_phase(fa, fa_cuda, root: str, card_line: str) -> dict:
    """Phase 27: kernel 4 at the model-parallel shapes; (c) ``remat_policy``
    in one process; the one-process references timed; then (a) tensor
    parallelism and (b) the pipeline on two gloo ranks on ``cuda:0``
    (``--mp-rank``), held against one process; rank 0's snapshot in one
    process."""
    import torch.nn.functional as F

    from audiodeepfake_detection_tpu_torch.models.ast import ASTModel
    from audiodeepfake_detection_tpu_torch.train.trainer import Trainer
    from audiodeepfake_detection_tpu_torch.utils.config import DotDict, default_config

    t_phase = time.perf_counter()
    out = {"mha_vs_plain": mha_new_shapes(fa, fa_cuda)}
    directory = os.path.join(root, "model_parallel")
    os.makedirs(directory)
    torch.manual_seed(0)
    with torch.device("cuda"):
        state = {k: v.cpu() for k, v in ASTModel(fused_attention=True).state_dict().items()}
    gen = torch.Generator().manual_seed(27)
    inputs = {"state": state, "images": torch.randn(MP_BATCH, 1, 256, 101, generator=gen),
              "labels": torch.randint(0, 2, (MP_BATCH,), generator=gen)}
    torch.save(inputs, os.path.join(directory, "inputs.pt"))
    x, y = inputs["images"].cuda(), inputs["labels"].cuda()
    out["remat"] = remat_runs(fa_cuda, state, x, y)

    # the one-process references of (a) and (b)'s times, and (b)'s losses
    model = fresh_ast(state)
    with torch.no_grad():
        plain_fwd = windows_ms({"fwd": lambda: model(x[:TP_BATCH])}, reps=2, windows=3)["fwd"]
    del model
    args = default_config()
    args.update(learning_rate=MP_LR, weight_decay=MP_WD, seed=0)
    one = Trainer(fresh_ast(state), lambda a: a, DotDict(args), os.path.join(directory, "one"),
                  device="cuda")
    batch = {"audio": x, "label": y}
    one_losses = [float(one.train_step(batch)["loss"]) for _ in range(2)]
    one_step = windows_ms({"one": lambda: one.train_step(batch)}, reps=1, windows=3)["one"]
    del one

    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-rank",
                               directory, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MP_RANKS)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise AssertionError("model-parallel ranks failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{o[-8000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    ranks = [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
             for r in range(MP_RANKS)]
    out["ranks_wall_s"] = time.perf_counter() - t0

    tp = ranks[0]["tp"]
    out["tp"] = {**tp, "launches": [r["tp"]["launches"] for r in ranks],
                 "heads": [r["tp"]["heads"] for r in ranks], "plain_forward_ms": plain_fwd}
    log(f"  (a) TP over (data, model) = (1, 2), base384, B = {TP_BATCH}: logits "
        f"{tp['logits_rel']:.2e} of the largest from one process, gradients "
        f"{tp['grad_rel']:.2e} of each tensor's largest, state gathered bit-equal "
        f"{[r['tp']['state_bit_equal'] for r in ranks]}, kernel 4 {out['tp']['launches']} "
        f"at heads {out['tp']['heads']}")
    log(f"  (d) TP forward at B = {TP_BATCH} over 2 gloo ranks, HOST-STAGED [{card_line}]: "
        f"{[round(r['tp']['forward_ms']['ms'], 3) for r in ranks]} ms against one process "
        f"{plain_fwd['ms']:.3f} ms")
    if not (tp["logits_rel"] <= TP_LOGIT_RTOL and tp["grad_rel"] <= TP_GRAD_RTOL
            and all(r["tp"]["state_bit_equal"] for r in ranks)
            and all(r["tp"]["launches"] == MP_LAUNCHES["tp"] for r in ranks)
            and all(r["tp"]["heads"] == [TP_HEADS] for r in ranks)):
        raise AssertionError(f"tensor parallelism: {out['tp']}")

    pp = ranks[0]["pp"]
    # rank 0's snapshot in one process: the logits rank 0's model gave
    model = fresh_ast(torch.load(pp["snapshot"], weights_only=True)["MODEL_STATE"]).eval()
    with torch.no_grad():
        snap_logits = model(x[:8]).cpu()
    del model
    out["pp"] = {
        "logits_rel": pp["logits_rel"], "grad_rel": pp["grad_rel"],
        "launches": [r["pp"]["launches"] for r in ranks],
        "trainer_launches": [r["pp"]["trainer_launches"] for r in ranks],
        "trainer_losses": pp["trainer_losses"], "one_process_losses": one_losses,
        "loss_rel": loss_rel_diff(pp["trainer_losses"], one_losses),
        "ranks_bit_equal": ranks[1]["pp"]["digest"] == pp["digest"],
        "snapshot_logits_equal": torch.equal(snap_logits, pp["eval_logits"]),
        "snapshot_logits_rel": logits_rel(snap_logits, pp["eval_logits"]),
        "step_ms": [r["pp"]["step_ms"] for r in ranks], "one_process_step_ms": one_step}
    row = out["pp"]
    log(f"  (b) PP over (data, stage) = (1, 2), base384, B = {MP_BATCH} in "
        f"{MP_MICROBATCHES} microbatches: logits {row['logits_rel']:.2e} of the largest from "
        f"one process, gradients {row['grad_rel']:.2e} of each tensor's largest, kernel 4 "
        f"{row['launches']} a rank (predicted {MP_LAUNCHES['pp']}); two Trainer steps: losses "
        f"{row['trainer_losses']} against one process {one_losses} (rel {row['loss_rel']:.2e}), "
        f"kernel 4 {row['trainer_launches']}, ranks bit-equal {row['ranks_bit_equal']}, rank "
        f"0's snapshot in one process: logits equal {row['snapshot_logits_equal']} "
        f"({row['snapshot_logits_rel']:.1e})")
    log(f"  (d) PP train step over 2 gloo ranks, HOST-STAGED [{card_line}]: "
        f"{[round(r['ms'], 3) for r in row['step_ms']]} ms against one process "
        f"{one_step['ms']:.3f} ms")
    if not (row["logits_rel"] <= PP_LOGIT_RTOL and row["grad_rel"] <= PP_GRAD_RTOL
            and row["loss_rel"] <= LOSS_RTOL and row["ranks_bit_equal"]
            and row["snapshot_logits_rel"] <= TP_LOGIT_RTOL
            and all(c == MP_LAUNCHES["pp"] for c in row["launches"])
            and all(c == {k: 2 * v for k, v in MP_LAUNCHES["pp"].items()}
                    for c in row["trainer_launches"])):
        raise AssertionError(f"pipeline: {row}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    from audiodeepfake_detection_tpu_torch.ops import (
        flash_attention, flash_attention_cuda, fused_conv1, fused_conv1_cuda, fused_conv2,
        fused_conv2_cuda, fused_pool, fused_pool_cuda, int8_conv, int8_conv_cuda, wpt,
        wpt_cuda)

    # fp32 convolutions on both sides of every comparison (TF32 keeps ~3
    # digits); the JAX reference runs its convolutions at HIGHEST
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card_line = card()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    def timed_build(mod):
        t0 = time.perf_counter()
        return mod.build(), time.perf_counter() - t0

    kernel_mods = (wpt_cuda, fused_conv1_cuda, fused_pool_cuda, fused_conv2_cuda,
                   flash_attention_cuda, int8_conv_cuda)
    with concurrent.futures.ThreadPoolExecutor(len(kernel_mods)) as pool:  # one nvcc each
        builds = list(pool.map(timed_build, kernel_mods))
    build_s = {}
    for mod, (report, secs) in zip(kernel_mods, builds):
        build_s[mod.SOURCE.name] = secs
        log(f"[2 build] {mod.SOURCE.name} -> sm_90a in {secs:.3f} s\n{report.strip()}")

    log("[3 kernel vs plain]")
    errs = kernel_vs_plain(wpt_cuda, wpt)

    build_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        snapshot = write_snapshot(root)
        log("[4 serve]")
        served = serve(wpt_cuda, snapshot)
        log("  the same behind --no-kernel (the plain cascade)")
        served["no_kernel"] = serve_plain_cascade(wpt_cuda, snapshot, served)
        log("[5 time]")
        times = timing(wpt_cuda, wpt, snapshot, card_line)

    log("[6 fused first block vs plain]")
    fused_errs = fused_vs_plain(fused_conv1)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        t0 = time.perf_counter()
        data = write_corpus(root)
        log(f"[7 train] corpus: 56 clips of 10 s written in {time.perf_counter() - t0:.1f} s")
        trained = train(wpt_cuda, fused_conv1_cuda, root, data)
        # phase 22 serves this snapshot: kept apart from the later runs' snapshots
        int8_dcnn = keep_snapshot(trained.pop("snapshot"), os.path.join(root, "int8"))
        log("[8 time, training]")
        train_times, fused_step = train_timing(
            fused_conv1, fused_conv1_cuda, trained["norm"], card_line)
        log("[9 profile, fused train step]")
        prof = profile_train(fused_step)
        prof["copies"] = copy_profile(fused_step, TRAIN_SHAPE[0] * TRAIN_SHAPE[3] * int(
            np.prod(fused_conv1.pad_geometry(*TRAIN_SHAPE[1:3]))))
        del fused_step
        log("[10 fused LCNN block vs plain]")
        mfm_errs = mfm_vs_plain(fused_conv1, fused_conv1_cuda)
        log("[11 train the LCNN]")
        lcnn = train_lcnn(wpt_cuda, fused_conv1_cuda, root, data)
        log("[12 serve the trained LCNN]")
        lcnn_snapshot = lcnn.pop("snapshot")
        lcnn_served = serve(wpt_cuda, lcnn_snapshot, kernel_on_path=False)
        log("[13 time and profile, LCNN]")
        lcnn_times, lcnn_step = lcnn_timing(
            fused_conv1, fused_conv1_cuda, lcnn["norm"], card_line)
        lcnn_prof = profile_train(lcnn_step)
        del lcnn_step
        log("[14 fused mid blocks vs plain]")
        mid_errs = mid_vs_plain(fused_pool, fused_conv2)
        mid_errs["conv2-split-tf32"] = conv2_split_tf32_check(fused_conv2_cuda)
        mid_errs["conv2-bf16-from-code"] = conv2_bf16_grads_check(fused_conv2_cuda)
        mid_mma = conv2_mma_count(fused_conv2_cuda)
        log("[15 train with the fused mid blocks]")
        mid = train_mid(wpt_cuda, fused_conv1_cuda, fused_pool_cuda, fused_conv2_cuda,
                        root, data, trained["unfused_losses"])
        log("  the snapshot of run (b) over HTTP")
        mid["serve"] = serve(wpt_cuda, mid.pop("snapshot"))
        log("[16 time and profile, fused mid blocks]")
        mid_times, mid_step = mid_timing(
            fused_pool, fused_pool_cuda, fused_conv2, fused_conv2_cuda, trained["norm"],
            card_line)
        mid_prof = profile_train(mid_step)
        del mid_step
        log("[17 fused attention vs plain]")
        mha_errs = mha_vs_plain(flash_attention, flash_attention_cuda)
        mma = mma_count(flash_attention_cuda)
        log("[18 train the AST]")
        ast_trainer, ast_run = train_ast(flash_attention_cuda, root, data)
        log("  the trained AST over HTTP")
        ast_run["serve"] = serve_ast(flash_attention_cuda, ast_trainer)
        ast_model, ast_transform = ast_trainer.model, ast_trainer.transform  # phase 22
        del ast_trainer
        log("[19 time and profile, AST]")
        ast_times, ast_steps = ast_timing(
            flash_attention, flash_attention_cuda, ast_run["norm"], card_line)
        ast_prof = {}
        for name, step in ast_steps.items():
            log(f"  profile of the {name} AST step")
            ast_prof[name] = profile_train(step, kernel_groups=AST_KERNEL_GROUPS)
        del ast_steps
        log("[20 train on 2 s frames]")
        long_run = train_long(wpt, wpt_cuda, flash_attention_cuda, root, data, card_line)
        log("[21 the CNNs in bf16]")
        bf16_run = train_bf16(wpt_cuda, fused_conv1_cuda, fused_pool_cuda, fused_conv2_cuda,
                              root, data, trained["unfused_losses"])
        log("  kernels 2, 3, 5 and 6 in bf16 against plain, at the path's shapes")
        bf16_errs = bf16_vs_plain(fused_conv1, fused_pool, fused_conv2)
        log("  time")
        bf16_times, bf16_steps = bf16_timing(
            fused_conv1, fused_conv1_cuda, fused_pool, fused_pool_cuda, fused_conv2,
            fused_conv2_cuda, trained["norm"], lcnn["norm"], card_line)
        bf16_prof = {}
        for name, step in bf16_steps.items():
            log(f"  profile of the {name} step")
            bf16_prof[name] = profile_train(step)
        del bf16_steps
        log("[22 post-training int8]")
        int8_errs, int8_imma = int8_vs_plain(int8_conv, int8_conv_cuda)
        log("  phase 7's DCNN snapshot, int8, over HTTP")
        int8_run = {"serve": serve_int8(wpt_cuda, int8_conv_cuda, int8_dcnn, data)}
        log("  phase 11's LCNN snapshot through score_files(int8=True)")
        int8_run["lcnn"] = score_lcnn_int8(int8_conv_cuda, lcnn_snapshot, data)
        log("  phase 18's AST, int8")
        ast_q, int8_run["ast"] = ast_int8(flash_attention_cuda, ast_model, ast_transform, data)
        log("  time")
        int8_times = int8_timing(int8_conv, int8_conv_cuda, int8_dcnn, lcnn_snapshot, ast_model,
                                 ast_q, ast_transform, card_line)
        del ast_q
        log("[23 the serving export]")
        export_mods = (wpt_cuda, fused_conv1_cuda, fused_pool_cuda, fused_conv2_cuda,
                       flash_attention_cuda, int8_conv_cuda)
        export_run = export_phase(
            export_mods, export_scorers(int8_dcnn, lcnn_snapshot, ast_model, ast_transform,
                                        data), root, card_line)
        del ast_model
        log("[24 sweeps and resident data]")
        sweep_run = sweep_phase((wpt_cuda, fused_conv1_cuda, fused_pool_cuda, fused_conv2_cuda),
                                root, data, trained["norm"], card_line)
        log("[25 analysis on the card]")
        analysis_run = analysis_phase(
            wpt, (wpt_cuda, fused_conv1_cuda, fused_pool_cuda, fused_conv2_cuda), root, data,
            int8_dcnn, card_line)
        log("[26 data parallelism]")
        mesh_run = mesh_phase((wpt_cuda, fused_conv1_cuda, fused_pool_cuda, fused_conv2_cuda),
                              flash_attention_cuda, root, data, trained["norm"], ast_run["norm"],
                              mid["b"]["losses"], card_line)
        log("[27 the AST's model parallelism and remat_policy]")
        mp_run = model_parallel_phase(flash_attention, flash_attention_cuda, root, card_line)

    sweep_launches = sweep_run["scan"]["launches"]
    # phase 26: the headline DCNN through main --ddp on one NCCL rank
    # (kernels 1, 2, 5, 6), the LCNN step on each of two gloo ranks (kernel
    # 3), one FSDP step of the AST (kernel 4)
    mesh_launches = mesh_run["ddp"]["launches"]
    mesh_mfm = mesh_run["two_ranks"]["lcnn"]["launches"][0]
    mesh_mha = mesh_run["nccl"]["ast"]["launches"]
    # phase 27, rank 0 of two gloo ranks: one TP step (6 heads a launch),
    # one pipelined step and two Trainer steps (microbatches of 8), and
    # remat_policy's dots_saveable step in one process (recomputed forward)
    mp_mha = {way: {"tp": mp_run["tp"]["launches"][0][way],
                    "pp": mp_run["pp"]["launches"][0][way],
                    "pp_trainer": mp_run["pp"]["trainer_launches"][0][way],
                    "remat_dots_saveable": mp_run["remat"]["dots_saveable"]["launches"][way]}
              for way in ("fwd", "bwd")}
    ig_launches = analysis_run["ig"]["launches"]
    l14 = analysis_run["fingerprints"]
    main_key = f"{MAIN[0]}-L{MAIN[1]}-B64-T{SR}"
    train_key = "B{}-H{}-W{}-C{}-float32".format(*TRAIN_SHAPE)
    fused_src = "audiodeepfake_detection_tpu_torch/csrc/fused_conv1.cu"
    wpt_b, wpt_by = wpt_bound(wpt, 64, SR)
    (fwd_b, fwd_by), (bwd_b, bwd_by) = fused_bounds(*TRAIN_SHAPE)
    lcnn_key = "B{}-H{}-W{}-C{}-float32".format(*LCNN_SHAPE)
    (mfwd_b, mfwd_by), (mbwd_b, mbwd_by) = mfm_bounds(*LCNN_SHAPE)
    pool_src = "audiodeepfake_detection_tpu_torch/csrc/fused_pool.cu"
    conv2_src = "audiodeepfake_detection_tpu_torch/csrc/fused_conv2.cu"
    pool_key = "pool-B{}-C{}-H{}-W{}-float32".format(*POOL2_SHAPE)
    conv2_key = "conv2-B{}-Cin{}-Cout{}-H{}-W{}-float32".format(*CONV2_SHAPE)
    (pfwd_b, pfwd_by), (pbwd_b, pbwd_by) = pool_bounds(
        *POOL2_SHAPE, mid_times["pool2"]["n_negative"])
    (cfwd_b, cfwd_by), (cbwd_b, cbwd_by), _ = conv2_bounds(*CONV2_SHAPE)
    mid_launches = {k: mid["a"]["launches"][k] + mid["b"]["launches"][k]
                    for k in ("pool_fwd", "pool_bwd", "conv2_fwd", "conv2_bwd")}
    mha_src = "audiodeepfake_detection_tpu_torch/csrc/flash_mha.cu"
    mha_key = "B{}-N{}-H{}-float32".format(*AST_SHAPE)
    (afwd_b, afwd_by), (abwd_b, abwd_by) = mha_bounds(*AST_SHAPE)
    f32 = ast_times[mha_key]
    mha_fwd_design = ("mma.sync (bf16 m16n8k16; fp32 split TF32 m16n8k8, 3 products), S and "
                      "P in registers, K/V through a cp.async ring; fp32 one online pass, "
                      "bf16 two; one route for every N")
    mha_bwd_design = ("as the forward; dQ kernel (bf16: two walks over the keys; fp32: "
                      "row term rowsum(dO * O)) and dK/dV kernel (keys as rows); nine "
                      "products in bf16, seven in fp32")
    # the rows of phase 20's geometry: checked, timed and bounded there
    stream_key = "B{}-N{}-H{}-float32".format(*STREAM_SHAPE)
    (sfwd_b, sfwd_by), (sbwd_b, sbwd_by) = mha_bounds(*STREAM_SHAPE)
    s32 = ast_times[stream_key]
    long_key = "log-{}-L{}-B{}-T{}".format(LONG_CASES[0][2], LONG_CASES[0][3], *LONG_CASES[0][:2])
    long_b, long_by = wpt_bound(wpt, *LONG_CASES[0][:2])
    # library_ms is null for kernels 1-3, 5 and 6: no single PyTorch call
    # computes a wavelet-packet cascade, or conv + PReLU + pool with moments,
    # or conv + MaxFeatureMap + pool with a code, or PReLU + pool with a
    # code, or gradients from a code; kernel 4's is scaled_dot_product_attention
    print(json.dumps({"kernels": [
        {
            "name": "wpt_cascade", "route": "cuda",
            "source": "audiodeepfake_detection_tpu_torch/csrc/wpt_cascade.cu",
            "replaces": "audiodeepfake_detection_tpu/ops/wpt_pallas.py:287",
            "design": "a CTA per (frame, node at split depth k), subtree in shared memory "
                      "as padded rows; first level staged by coalesced loads; R outputs of "
                      "both children from one float4 window, taps from the constant bank",
            "launches": served["launches"], "train_launches": trained["launches"]["wpt"],
            "sweep_launches": sweep_launches["wpt"], "mesh_launches": mesh_launches["wpt"],
            "max_abs_err": errs[main_key],
            "ms": times[64]["wpt_kernel_ms"], "plain_ms": times[64]["wpt_plain_ms"],
            "device_ms": times[64]["wpt_device_ms"], "split": times[64]["split"],
            "bound_ms": wpt_b, "bound_by": wpt_by, "library_ms": None,
        },
        {
            "name": "fused_conv1_fwd", "route": "cuda", "source": fused_src,
            "design": "a thread per 4 windows of a block's range of the flattened plane, "
                      "4x4 patches in registers from a cp.async halo tile, taps as float4 "
                      "broadcasts, NCHW stores, moments by warp shuffles",
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv1.py:376",
            "launches": trained["launches"]["fwd"],
            "sweep_launches": sweep_launches["conv1_fwd"],
            "mesh_launches": mesh_launches["conv1_fwd"],
            "max_abs_err": fused_errs[train_key]["fwd_max_abs_err"],
            "ms": train_times["fwd_kernel_ms"], "plain_ms": train_times["fwd_plain_ms"],
            "device_ms": train_times["fwd_device_ms"],
            "bound_ms": fwd_b, "bound_by": fwd_by, "library_ms": None,
        },
        {
            "name": "fused_conv1_bwd", "route": "cuda", "source": fused_src,
            "design": "a lane per channel over a run of a 4-row strip's windows, x from a "
                      "cp.async halo tile; g and codes (NCHW) copied 16 windows at a time by "
                      "coalesced loads into a per-warp buffer; out rebuilt, not read",
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv1.py:472",
            "launches": trained["launches"]["bwd"],
            "sweep_launches": sweep_launches["conv1_bwd"],
            "mesh_launches": mesh_launches["conv1_bwd"],
            "max_abs_err": fused_errs[train_key]["dW_max_abs_err"],
            "ms": train_times["bwd_kernel_ms"], "plain_ms": train_times["bwd_plain_ms"],
            "device_ms": train_times["bwd_device_ms"],
            "bound_ms": bwd_b, "bound_by": bwd_by, "library_ms": None,
        },
        {
            "name": "fused_conv_mfm_fwd", "route": "cuda", "source": fused_src,
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv1.py:756",
            "launches": lcnn["launches"]["mfm_fwd"], "mesh_launches": mesh_mfm["mfm_fwd"],
            "max_abs_err": mfm_errs[lcnn_key]["fwd_max_abs_err"],
            "ms": lcnn_times["fwd_kernel_ms"], "plain_ms": lcnn_times["fwd_plain_ms"],
            "bound_ms": mfwd_b, "bound_by": mfwd_by, "library_ms": None,
        },
        {
            # one launch counted per backward call: the block kernel and the
            # fixed-order sum of its per-block partials
            "name": "fused_conv_mfm_bwd", "route": "cuda", "source": fused_src,
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv1.py:806",
            "launches": lcnn["launches"]["mfm_bwd"], "mesh_launches": mesh_mfm["mfm_bwd"],
            "max_abs_err": mfm_errs[lcnn_key]["dW_max_abs_err"],
            "ms": lcnn_times["bwd_kernel_ms"], "plain_ms": lcnn_times["bwd_plain_ms"],
            "bound_ms": mbwd_b, "bound_by": mbwd_by, "library_ms": None,
        },
        {
            "name": "fused_pool_fwd", "route": "cuda", "source": pool_src,
            "replaces": "audiodeepfake_detection_tpu/ops/fused_pool.py:197",
            "launches": mid_launches["pool_fwd"], "ig_launches": ig_launches["pool_fwd"],
            "sweep_launches": sweep_launches["pool_fwd"],
            "mesh_launches": mesh_launches["pool_fwd"],
            "max_abs_err": mid_errs[pool_key]["fwd_max_abs_err"],
            "ms": mid_times["pool2"]["fwd_kernel_ms"],
            "plain_ms": mid_times["pool2"]["fwd_plain_ms"],
            "bound_ms": pfwd_b, "bound_by": pfwd_by, "library_ms": None,
        },
        {
            "name": "fused_pool_bwd", "route": "cuda", "source": pool_src,
            "design": "a thread per window, two windows of a pooled row at once, code, g "
                      "and out by independent coalesced loads, dx as a pair to each input "
                      "row; blocks over strips of 8 pooled rows, one dalpha partial each",
            "replaces": "audiodeepfake_detection_tpu/ops/fused_pool.py:241",
            "launches": mid_launches["pool_bwd"], "ig_launches": ig_launches["pool_bwd"],
            "sweep_launches": sweep_launches["pool_bwd"],
            "mesh_launches": mesh_launches["pool_bwd"],
            "max_abs_err": mid_errs[pool_key]["dx_max_abs_err"],
            "ms": mid_times["pool2"]["bwd_kernel_ms"],
            "plain_ms": mid_times["pool2"]["bwd_plain_ms"],
            "bound_ms": pbwd_b, "bound_by": pbwd_by, "library_ms": None,
        },
        {
            "name": "fused_conv2_fwd", "route": "cuda", "source": conv2_src,
            "design": "FMA pipe in cuDNN's summation order, two-stage cp.async ring",
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv2.py:323",
            "launches": mid_launches["conv2_fwd"], "ig_launches": ig_launches["conv2_fwd"],
            "sweep_launches": sweep_launches["conv2_fwd"],
            "mesh_launches": mesh_launches["conv2_fwd"],
            "max_abs_err": mid_errs[conv2_key]["fwd_max_abs_err"],
            "ms": mid_times["conv2"]["fwd_kernel_ms"],
            "plain_ms": mid_times["conv2"]["fwd_plain_ms"],
            "bound_ms": cfwd_b, "bound_by": cfwd_by, "library_ms": None,
        },
        {
            # one launch counted per backward call: its dx, dw and dcorr /
            # dalpha kernels together
            "name": "fused_conv2_bwd", "route": "cuda", "source": conv2_src,
            "design": "dx, dw: mma.sync m16n8k8 split-TF32 (3 products), two-stage "
                      "ring; dcorr / dalpha: FMA",
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv2.py:383",
            "launches": mid_launches["conv2_bwd"], "ig_launches": ig_launches["conv2_bwd"],
            "sweep_launches": sweep_launches["conv2_bwd"],
            "mesh_launches": mesh_launches["conv2_bwd"],
            "max_abs_err": mid_errs[conv2_key]["dw_max_abs_err"],
            "ms": mid_times["conv2"]["bwd_kernel_ms"],
            "plain_ms": mid_times["conv2"]["bwd_plain_ms"],
            "bound_ms": cbwd_b, "bound_by": cbwd_by, "library_ms": None,
            "dx_ms": mid_times["conv2"]["bwd_dx_ms"],
            "dw_ms": mid_times["conv2"]["bwd_dw_ms"],
            "small_ms": mid_times["conv2"]["bwd_small_ms"],
            "hmma": {k: v for k, v in mid_mma.items() if k.startswith(("dx-", "dw-"))},
        },
        {
            # kernel 4 at the AST's 1 s frames (N = 227): phase 18's launches,
            # checked in phase 17 and timed in phase 19 there
            "name": "flash_mha_fwd", "route": "cuda", "source": mha_src,
            "tokens": AST_SHAPE[1], "design": mha_fwd_design,
            "replaces": "audiodeepfake_detection_tpu/ops/flash_attention.py:137",
            "launches": ast_run["launches"]["fwd"], "mesh_launches": mesh_mha["fwd"],
            "model_parallel_launches": mp_mha["fwd"],
            "max_abs_err": mha_errs[mha_key]["fwd_max_abs_err"],
            "ms": f32["fwd_kernel_ms"], "plain_ms": f32["fwd_plain_ms"],
            "bound_ms": afwd_b, "bound_by": afwd_by, "library_ms": f32["fwd_library_ms"],
            "hmma": {k: v for k, v in mma["hmma"].items() if k.startswith("stream-fwd")},
        },
        {
            # one launch counted per backward call: its dQ and dK/dV kernels
            "name": "flash_mha_bwd", "route": "cuda", "source": mha_src,
            "tokens": AST_SHAPE[1], "design": mha_bwd_design,
            "replaces": "audiodeepfake_detection_tpu/ops/flash_attention.py:156",
            "launches": ast_run["launches"]["bwd"], "mesh_launches": mesh_mha["bwd"],
            "model_parallel_launches": mp_mha["bwd"],
            "max_abs_err": mha_errs[mha_key]["dqkv_max_abs_err"],
            "ms": f32["bwd_kernel_ms"], "plain_ms": f32["bwd_plain_ms"],
            "bound_ms": abwd_b, "bound_by": abwd_by, "library_ms": f32["bwd_library_ms"],
            "hmma": {k: v for k, v in mma["hmma"].items()
                     if k.startswith(("stream-dq", "stream-dkv"))},
        },
        {
            # the same kernels at 2 s frames (N = 477): phase 20's launches
            "name": "flash_mha_stream_fwd", "route": "cuda", "source": mha_src,
            "tokens": STREAM_SHAPE[1], "design": mha_fwd_design,
            "replaces": "audiodeepfake_detection_tpu/ops/flash_attention.py:137",
            "launches": long_run["mha_launches"]["fwd"],
            "max_abs_err": mha_errs[stream_key]["fwd_max_abs_err"],
            "ms": s32["fwd_kernel_ms"], "plain_ms": s32["fwd_plain_ms"],
            "bound_ms": sfwd_b, "bound_by": sfwd_by, "library_ms": s32["fwd_library_ms"],
        },
        {
            "name": "flash_mha_stream_bwd", "route": "cuda", "source": mha_src,
            "tokens": STREAM_SHAPE[1], "design": mha_bwd_design,
            "replaces": "audiodeepfake_detection_tpu/ops/flash_attention.py:156",
            "launches": long_run["mha_launches"]["bwd"],
            "max_abs_err": mha_errs[stream_key]["dqkv_max_abs_err"],
            "ms": s32["bwd_kernel_ms"], "plain_ms": s32["bwd_plain_ms"],
            "bound_ms": sbwd_b, "bound_by": sbwd_by, "library_ms": s32["bwd_library_ms"],
        },
        {
            # the same kernel on phase 20's 2 s frames at its batch of 64, with
            # the log: subtrees on chip, no level through device memory
            "name": "wpt_cascade_long", "route": "cuda",
            "source": "audiodeepfake_detection_tpu_torch/csrc/wpt_cascade.cu",
            "replaces": "audiodeepfake_detection_tpu/ops/wpt_pallas.py:287",
            "launches": long_run["wpt_launches"]["subtree"],
            "level_launches": long_run["wpt_launches"]["level"],
            "max_abs_err": errs[long_key],
            "ms": long_run["wpt_long"]["wpt_kernel_ms"],
            "plain_ms": long_run["wpt_long"]["wpt_plain_ms"],
            "device_ms": long_run["wpt_long"]["wpt_device_ms"],
            "split": long_run["wpt_long"]["split"],
            "bound_ms": long_b, "bound_by": long_by, "library_ms": None,
        },
        {
            # the same kernel on phase 25's whole 10 s clips at level-14 haar,
            # B = 1: the top levels through device memory (wpt_level_kernel,
            # one launch a level), then the subtree kernel
            "name": "wpt_cascade_l14", "route": "cuda",
            "source": "audiodeepfake_detection_tpu_torch/csrc/wpt_cascade.cu",
            "replaces": "audiodeepfake_detection_tpu/ops/wpt_pallas.py:287",
            "launches": l14["launches"]["subtree"], "level_launches": l14["launches"]["level"],
            "max_abs_err": l14["max_abs_err"], "ms": l14["kernel_ms"], "plain_ms": l14["plain_ms"],
            "device_ms": l14["device_ms"], "split": l14["split"], "in_level": l14["in_level"],
            "bound_ms": l14["bound_ms"], "bound_by": l14["bound_by"], "library_ms": None,
        },
        *bf16_rows(bf16_run, bf16_errs, bf16_times),
        *int8_rows(int8_errs, int8_run["serve"], int8_times),
    ]}))
    trained.pop("norm")
    lcnn.pop("norm")
    ast_run.pop("norm")
    wall_s = time.perf_counter() - t_start
    print(json.dumps({
        "card": card_line, "wall_s": wall_s, "build_s": build_s, "max_abs_err": errs,
        "serve": served, "timing": times, "fused_vs_plain": fused_errs,
        "train": trained, "train_timing": train_times, "profile": prof,
        "mfm_vs_plain": mfm_errs, "lcnn_train": lcnn, "lcnn_serve": lcnn_served,
        "lcnn_timing": lcnn_times, "lcnn_profile": lcnn_prof,
        "mid_vs_plain": mid_errs, "mid_hmma": mid_mma, "mid_train": mid, "mid_timing": mid_times,
        "mid_profile": mid_prof, "mha_vs_plain": mha_errs, "mha_hmma": mma,
        "ast_train": ast_run, "ast_timing": ast_times, "ast_profile": ast_prof,
        "long_frames": long_run, "bf16_train": bf16_run, "bf16_vs_plain": bf16_errs,
        "bf16_timing": bf16_times, "bf16_profile": bf16_prof,
        "int8_vs_plain": int8_errs, "int8_imma": int8_imma, "int8": int8_run,
        "int8_timing": int8_times, "export": export_run, "sweep": sweep_run,
        "analysis": analysis_run, "mesh": mesh_run, "model_parallel": mp_run,
    }))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one of phase 26's two gloo ranks
        mesh_rank_worker(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--mp-rank"]:  # one of phase 27's two gloo ranks
        mp_rank_worker(sys.argv[2], int(sys.argv[3]))
    else:
        main()
