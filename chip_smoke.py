"""Drive the PyTorch/CUDA port's serving and training paths (DCNN, with and
without its fused mid blocks, LCNN and AST) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure propagates and the script exits non-zero
(there is no CPU fallback):

1. device: require CUDA, print ``nvidia-smi``'s card name and power limit;
2. build: compile ``csrc/wpt_cascade.cu``, ``csrc/fused_conv1.cu``,
   ``csrc/fused_pool.cu``, ``csrc/fused_conv2.cu`` and ``csrc/flash_mha.cu``
   for sm_90a from this checkout, all at once;
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
   over exactly this run;
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
    cap that one TF32 pass (modelled on the same inputs) must exceed; the
    tensor-core (HMMA) instructions of its dx / dw kernels are counted in
    the built library (``cuobjdump -sass``: > 0; the forward's: 0);
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
    counted likewise); the WPT on 2 s frames timed against plain at B=64.

The last lines are the kernels' JSON record, the measurements with the
card's name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import os
import pickle
import statistics
import subprocess
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


def serve_service(svc, cpu_score, clips, pcms, reset, read, kernel_on_path: bool = True):
    """Concurrent HTTP uploads (and one garbage body) scored by ``svc`` on the
    card, held against ``cpu_score``; ``reset`` / ``read`` zero and read the
    launch count of the kernel on the serving path."""
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

    worst = 0.0
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
        log(f"  {sec} s @ {rate} Hz: {payload['frames']} frames, p_fake "
            f"{payload['p_fake']:.6f}, max|cuda - cpu| {err:.3e}")
    if not worst <= SCORE_ATOL:
        raise AssertionError(f"cuda vs cpu scores: {worst} > {SCORE_ATOL}")
    if kernel_on_path and launches < max(dispatches, 1):
        raise AssertionError(
            f"kernel launched {launches} times for {dispatches} dispatches"
        )
    log(f"  {dispatches} dispatches, {launches} kernel launches, "
        f"{wall:.3f} s wall for {len(results)} requests")
    return {"dispatches": dispatches, "launches": launches,
            "max_abs_err_cuda_vs_cpu": worst}


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


def wpt_device_ms(wpt_cuda, fn, n: int = 20) -> float:
    """Device ms per call of ``fn`` in the WPT kernels: their mean duration
    in a profile of ``n`` calls times the launches one call makes (read
    from the launch counters), so a profile that lost a few records still
    reads right."""
    from torch.profiler import ProfilerActivity, profile

    before = wpt_counts(wpt_cuda)
    fn()
    torch.cuda.synchronize()
    launches = sum(wpt_counts(wpt_cuda)) - sum(before)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that lost every record is taken again
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
        raise AssertionError("three profiles show no WPT kernel")
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
            f"the launcher, {out[b]['wpt_device_ms']:.4f} ms on the device (k="
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


def wpt_bound(wpt, b: int, t: int):
    """The frame read once and the last level written once; 2 flops per tap
    per output of every level (either route: the long-frame route's level
    round trips are its own cost, not the function's)."""
    filt_len = wpt.dec_kernel(MAIN[0], "cpu").shape[-1]
    flops, n = 0, t
    for lvl in range(MAIN[1]):
        n = (n + filt_len - 1) // 2
        flops += (2 << lvl) * n * 2 * filt_len
    return bound_ms(4 * b * (t + (2 ** MAIN[1]) * n), b * flops)


def fused_bounds(b, h, w, c, itemsize=4):
    """Training forward: x and the parameters read, out, code and moments
    written; 36 FMAs per output.  Backward: g, code, x, the parameters and
    the moments' cotangents read (not out: the kernel rebuilds it from x
    and the code), dW/db/dalpha written; 9 FMAs per output for dW, one add
    for db."""
    n_out = b * ((h + 2) // 2) * ((w + 2) // 2) * c
    params = 4 * (9 * c + c + 1)
    fwd = bound_ms(itemsize * b * h * w + params + n_out * (itemsize + 1) + 8 * c,
                   n_out * 72)
    bwd = bound_ms(itemsize * b * h * w + params + n_out * (itemsize + 1) + 8 * c
                   + params, n_out * 20)
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
            "served_vs_trainer": err, "wall_s": wall,
            "norm": [np.asarray(v).tolist() for v in trainer.norm_stats]}


def step_fns(norm, fused: bool, **flags):
    """A train step and an eval step at full width on a fixed device batch;
    ``flags``: the DCNN's ``fused_pool`` / ``fused_layer2``."""
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.train.steps import (
        make_eval_step, make_optimizer, make_train_step)
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    args = train_args("", "", "")
    transform = normalized_transform(make_transform(args), *[np.asarray(v) for v in norm])
    torch.manual_seed(0)
    model = DCNN(time_dim=12, fused_layer1=fused, **flags).cuda()
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
        f"{dev['fwd']:.4f} ms on the device ({b2b['fwd']:.4f} back to back), plain "
        f"{fwd['plain']:.4f} ms, bound {fb:.4f} ms; bwd kernel {bwd['kernel']:.4f} ms, "
        f"{dev['bwd']:.4f} ms on the device ({b2b['bwd']:.4f} back to back), plain "
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
    for _ in range(3):  # a profile that lost every record of a key is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        raise AssertionError(f"three profiles show no records for some of {keys}: {counts}")
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
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            train_step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # kernel rows only: an operator's row repeats its kernels' device time,
    # and a user range (``Optimizer.step#...``) spans kernels and host gaps
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and e.self_device_time_total > 0]
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


def mfm_bounds(b, h, w, c, itemsize=4):
    """Training forward: x and the parameters read, out and code written;
    8 candidates x 25 FMAs per output.  Backward: g, code and x read, dW/db
    written; 25 FMAs and one add per output."""
    n_out = b * (h // 2) * (w // 2) * (c // 2)
    params = 4 * (25 * c + c)
    fwd = bound_ms(itemsize * b * h * w + params + n_out * (itemsize + 1), n_out * 400)
    bwd = bound_ms(itemsize * b * h * w + n_out * (itemsize + 1) + params, n_out * 51)
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


def lcnn_step_fns(norm, fused: bool):
    """An LCNN train step and eval step at full width on a fixed batch."""
    from audiodeepfake_detection_tpu_torch.models.lcnn import LCNN
    from audiodeepfake_detection_tpu_torch.train.steps import (
        make_eval_step, make_optimizer, make_train_step)
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    args = lcnn_args("", "", "")
    transform = normalized_transform(make_transform(args), *[np.asarray(v) for v in norm])
    torch.manual_seed(0)
    model = LCNN(fused_layer1=fused).cuda()
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


def pool_bounds(b, c, h, w, n_negative, itemsize=4):
    """Training forward: x read, out, code and the per-plane moments written;
    4 compare-selects per output.  Backward: g, code and out read, dx
    written, and x read at the selected negative elements (counted from this
    run's code); 2 operations per element of dx."""
    n_out = b * c * (h // 2) * (w // 2)
    n_in = b * c * h * w
    fwd = bound_ms(itemsize * n_in + n_out * (itemsize + 1) + 8 * b * c, 8 * n_out)
    bwd = bound_ms(n_out * (2 * itemsize + 1) + itemsize * (n_in + n_negative), 2 * n_in)
    return fwd, bwd


def conv2_bounds(b, c_in, c_out, h, w, itemsize=4):
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
    fwd = bound_ms(itemsize * n_x + small + n_out * (itemsize + 1), 4 * n_out * 18 * c_in)
    bwd = bound_ms(2 * itemsize * n_x + n_out * (2 * itemsize + 1) + 2 * small,
                   2 * n_out * 18 * c_in)
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


def tie_cases(slope):
    """Windows whose four values are equal: a constant negative plane for
    the pool, and for the conv a channel with zero weights under a constant
    negative ``corr`` (at a zero slope every such window also ties at 0)."""
    (x, alpha), pool_cot = pool_case(3, 4, 8, 10, torch.float32, slope, seed=70)
    with torch.no_grad():
        x[0] = -1.5
        x[1] = x[1, :, ::2, ::2].repeat_interleave(2, 1).repeat_interleave(2, 2)
    conv_args, conv_cot = conv2_case(3, 3, 4, 8, 10, torch.float32, slope, seed=71)
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
            log(f"  {key}: out max|err| {fwd_err:.3e} (tol {fwd_tol:.1e}), moments rel "
                f"{max(sums.values()):.2e}, grads rel {gerr}, repeat bit-equal {bitwise}")
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
            f"launcher, {dev['bwd']:.4f} ms of device time ({b2b['bwd']:.4f} back to back), "
            f"against its byte bound {bb:.4f} ms ({100 * bb / bwd['kernel']:.1f} %, "
            f"{100 * bb / dev['bwd']:.1f} %); fwd {fwd['kernel']:.4f} ms, {dev['fwd']:.4f} ms "
            f"device ({b2b['fwd']:.4f} back to back), against {fb:.4f} ms")
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
        f" ms; its kernels' device time (profiler): dx {c2['bwd_dx_ms']:.4f}, dw "
        f"{c2['bwd_dw_ms']:.4f}, small {c2['bwd_small_ms']:.4f} ms; the dense split-TF32 "
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
    """Phase 14, last: HMMA instructions in kernel 6.  The dx and dw kernels
    (split TF32 on the tensor cores) must have them in both types, the
    forward (the FMA pipe, in cuDNN's summation order) none."""
    import re

    found = {}
    for mangled, n_mma in hmma_per_kernel(conv2_cuda._LIB).items():
        kind = re.search(r"fused_conv2_(fwd|dx|dw|small)_kernel", mangled)
        if kind:
            dtype = "bfloat16" if "bfloat16" in mangled else "float32"
            nc = re.search(r"Li(\d+)E", mangled)  # the forward's channels a thread
            found[f"{kind.group(1)}-{dtype}" + (f"-nc{nc.group(1)}" if nc else "")] = n_mma
    log(f"  HMMA instructions per kernel-6 kernel: {found}")
    gemms = {k: v for k, v in found.items() if k.startswith(("dx-", "dw-"))}
    fwd = {k: v for k, v in found.items() if k.startswith("fwd-")}
    if len(gemms) != 4 or min(gemms.values()) <= 0 or len(fwd) != 4 or any(fwd.values()):
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
        f"{ms['wpt_kernel_ms']:.4f} ms through the launcher, {ms['wpt_device_ms']:.4f} ms "
        f"on the device (k={ms['split']}, top {ms['top']}), plain {ms['wpt_plain_ms']:.4f} ms")
    return {"dcnn_losses": losses, "wpt_launches": counts, "ast_tokens": tokens,
            "ast_losses": ast_losses, "mha_launches": mha, "ast_step_ms": step_ms,
            "ast_step_profile": step_prof, "kernel4_share_of_device": share,
            "wpt_long": ms}


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    from audiodeepfake_detection_tpu_torch.ops import (
        flash_attention, flash_attention_cuda, fused_conv1, fused_conv1_cuda, fused_conv2,
        fused_conv2_cuda, fused_pool, fused_pool_cuda, wpt, wpt_cuda)

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
                   flash_attention_cuda)
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
        log("[5 time]")
        times = timing(wpt_cuda, wpt, snapshot, card_line)

    log("[6 fused first block vs plain]")
    fused_errs = fused_vs_plain(fused_conv1)
    with tempfile.TemporaryDirectory(dir=build_root) as root:
        t0 = time.perf_counter()
        data = write_corpus(root)
        log(f"[7 train] corpus: 56 clips of 10 s written in {time.perf_counter() - t0:.1f} s")
        trained = train(wpt_cuda, fused_conv1_cuda, root, data)
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
        lcnn_served = serve(wpt_cuda, lcnn.pop("snapshot"), kernel_on_path=False)
        log("[13 time and profile, LCNN]")
        lcnn_times, lcnn_step = lcnn_timing(
            fused_conv1, fused_conv1_cuda, lcnn["norm"], card_line)
        lcnn_prof = profile_train(lcnn_step)
        del lcnn_step
        log("[14 fused mid blocks vs plain]")
        mid_errs = mid_vs_plain(fused_pool, fused_conv2)
        mid_errs["conv2-split-tf32"] = conv2_split_tf32_check(fused_conv2_cuda)
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
            "max_abs_err": fused_errs[train_key]["dW_max_abs_err"],
            "ms": train_times["bwd_kernel_ms"], "plain_ms": train_times["bwd_plain_ms"],
            "device_ms": train_times["bwd_device_ms"],
            "bound_ms": bwd_b, "bound_by": bwd_by, "library_ms": None,
        },
        {
            "name": "fused_conv_mfm_fwd", "route": "cuda", "source": fused_src,
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv1.py:756",
            "launches": lcnn["launches"]["mfm_fwd"],
            "max_abs_err": mfm_errs[lcnn_key]["fwd_max_abs_err"],
            "ms": lcnn_times["fwd_kernel_ms"], "plain_ms": lcnn_times["fwd_plain_ms"],
            "bound_ms": mfwd_b, "bound_by": mfwd_by, "library_ms": None,
        },
        {
            # one launch counted per backward call: the block kernel and the
            # fixed-order sum of its per-block partials
            "name": "fused_conv_mfm_bwd", "route": "cuda", "source": fused_src,
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv1.py:806",
            "launches": lcnn["launches"]["mfm_bwd"],
            "max_abs_err": mfm_errs[lcnn_key]["dW_max_abs_err"],
            "ms": lcnn_times["bwd_kernel_ms"], "plain_ms": lcnn_times["bwd_plain_ms"],
            "bound_ms": mbwd_b, "bound_by": mbwd_by, "library_ms": None,
        },
        {
            "name": "fused_pool_fwd", "route": "cuda", "source": pool_src,
            "replaces": "audiodeepfake_detection_tpu/ops/fused_pool.py:197",
            "launches": mid_launches["pool_fwd"],
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
            "launches": mid_launches["pool_bwd"],
            "max_abs_err": mid_errs[pool_key]["dx_max_abs_err"],
            "ms": mid_times["pool2"]["bwd_kernel_ms"],
            "plain_ms": mid_times["pool2"]["bwd_plain_ms"],
            "bound_ms": pbwd_b, "bound_by": pbwd_by, "library_ms": None,
        },
        {
            "name": "fused_conv2_fwd", "route": "cuda", "source": conv2_src,
            "design": "FMA pipe in cuDNN's summation order, two-stage cp.async ring",
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv2.py:323",
            "launches": mid_launches["conv2_fwd"],
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
            "launches": mid_launches["conv2_bwd"],
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
            "launches": ast_run["launches"]["fwd"],
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
            "launches": ast_run["launches"]["bwd"],
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
        "long_frames": long_run,
    }))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
