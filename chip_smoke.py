"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure propagates and the script exits non-zero
(there is no CPU fallback):

1. device: require CUDA, print ``nvidia-smi``'s card name and power limit;
2. build: compile ``csrc/wpt_cascade.cu`` and ``csrc/fused_conv1.cu`` for
   sm_90a from this checkout, both at once;
3. kernel vs plain: the wavelet-packet kernel against the plain PyTorch
   cascade on the card, at the serving shapes and a few other geometries;
4. serve: a seeded full-width DCNN snapshot behind ``service_from_snapshot``
   on ``cuda``, answering concurrent HTTP uploads; scores checked against
   the same snapshot scored on the CPU, and the kernel's launch count read
   over exactly this run;
5. time: CUDA-event medians of the kernel vs the plain cascade, and of the
   whole scorer (device audio -> P(fake)) with each, at batch 64 and 128;
6. fused first block vs plain: forward, moments and ``dW/db/dalpha`` of
   the conv+PReLU+pool kernels against the plain PyTorch version, at the
   training shape (B=128, 95x256, C=64; fp32 and bf16) and smaller
   geometries; two runs compared bit for bit;
7. train: a seeded wav corpus through ``run_experiment`` on ``cuda``
   (packets-sym5 level 8, full-width DCNN with the fused first block, batch
   128, 2 epochs with validation, test and snapshot), the kernels' launch
   counts read over exactly this run; the same training with and without
   the fused block compared loss by loss; the snapshot served and its
   score held against the trainer's own;
8. time: the fused kernels alone vs plain, the whole train step fused vs
   unfused, and the eval step, at batch 128;
9. profile: ``torch.profiler`` over a few fused train steps, device time
   by kernel.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12
BATCH = 128
STEPS_PER_EPOCH = 3
EPOCHS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def kernel_vs_plain(wpt_cuda, wpt):
    """Phase 3: every listed geometry, raw and (main path) with the log."""
    gen = torch.Generator().manual_seed(0)
    cases = [
        (*MAIN, 64, SR), (*MAIN, 128, SR), (*MAIN, 1, SR),
        ("haar", 8, 3, 4096), ("db4", 5, 5, 2048), ("coif4", 4, 4, 2048),
    ]
    errs = {}
    for name, level, b, t in cases:
        x = torch.randn(b, t, generator=gen).cuda()
        got = wpt_cuda.wpt_packets_cuda(x, name, level)
        want = wpt.wpt_analysis(x, name, level)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        errs[f"{name}-L{level}-B{b}-T{t}"] = err
        log(f"  raw {name} L={level} B={b} T={t}: max|err| {err:.3e} "
            f"(peak {want.abs().max().item():.3f})")
        if not err <= RAW_ATOL:
            raise AssertionError(f"kernel vs plain {name}: {err} > {RAW_ATOL}")
        if (name, level) == MAIN:
            got = wpt_cuda.wpt_packets_cuda(x, name, level, log_scale=True)
            want = wpt.log_power(want, 2.0)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=LOG_RTOL, atol=LOG_ATOL)
            lerr = (got - want).abs().max().item()
            errs[f"log-{name}-L{level}-B{b}-T{t}"] = lerr
            log(f"  log {name} L={level} B={b} T={t}: max|err| {lerr:.3e}")
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


def serve(wpt_cuda, snapshot: str):
    """Phase 4: HTTP uploads scored on the card through the kernel."""
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
            wpt_cuda.LAUNCHES = 0
            t0 = time.perf_counter()
            workers = [threading.Thread(target=client, args=(i,)) for i in range(len(results))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=300)
            health = http(url + "/healthz")
            torch.cuda.synchronize()
            launches = wpt_cuda.LAUNCHES
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

    model, transform, _ = build_scorer_from_snapshot(snapshot)
    cpu_score = make_score_fn(model, transform, "cpu")
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
    if launches < max(dispatches, 1):
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


def timing(wpt_cuda, wpt, snapshot: str, card_line: str):
    """Phase 5: kernel vs plain cascade, and the whole scorer with each."""
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
    for b in (64, 128):
        x = torch.randn(b, SR, generator=gen).cuda()
        ms = median_ms(
            {
                "plain": lambda: wpt.log_power(wpt.wpt_analysis(x, *MAIN), 2.0),
                "kernel": lambda: wpt_cuda.wpt_packets_cuda(x, *MAIN, log_scale=True),
            },
            reps=20,
        )
        audio = (0.3 * x)[:, None, :].contiguous()
        sms = median_ms(
            {
                "plain": lambda: scorers[False](audio),
                "kernel": lambda: scorers[True](audio),
            },
            reps=5,
        )
        out[b] = {
            "wpt_kernel_ms": ms["kernel"], "wpt_plain_ms": ms["plain"],
            "scorer_kernel_ms": sms["kernel"], "scorer_plain_ms": sms["plain"],
            "scorer_kernel_frames_per_s": b / sms["kernel"] * 1e3,
            "scorer_plain_frames_per_s": b / sms["plain"] * 1e3,
        }
        log(f"  B={b} [{card_line}]: WPT kernel {ms['kernel']:.4f} ms, plain "
            f"{ms['plain']:.4f} ms; scorer kernel {sms['kernel']:.3f} ms "
            f"({out[b]['scorer_kernel_frames_per_s']:.1f} frames/s), plain "
            f"{sms['plain']:.3f} ms ({out[b]['scorer_plain_frames_per_s']:.1f} frames/s)")
    return out


def bound_ms(n_bytes: float, n_flops: float):
    """Least time the card could take: (ms, "bytes" or "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def wpt_bound(wpt, b: int, t: int):
    """The frame read once and the last level written once; 2 flops per tap
    per output of every level."""
    filt_len = wpt.dec_kernel(MAIN[0], "cpu").shape[-1]
    flops, n = 0, t
    for lvl in range(MAIN[1]):
        n = (n + filt_len - 1) // 2
        flops += (2 << lvl) * n * 2 * filt_len
    return bound_ms(4 * b * (t + (2 ** MAIN[1]) * n), b * flops)


def fused_bounds(b, h, w, c, itemsize=4):
    """Training forward: x and the parameters read, out, code and moments
    written; 36 FMAs per output.  Backward: g, out, code, x and the
    parameters read, dW/db/dalpha written; 9 FMAs per output for dW, one
    add for db."""
    n_out = b * ((h + 2) // 2) * ((w + 2) // 2) * c
    params = 4 * (9 * c + c + 1)
    fwd = bound_ms(itemsize * b * h * w + params + n_out * (itemsize + 1) + 8 * c,
                   n_out * 72)
    bwd = bound_ms(itemsize * b * h * w + params + n_out * (2 * itemsize + 1) + 8 * c
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
    cot = [make(b, h2, w2, c), make(c, scale=0.01).float(), make(c, scale=0.001).float()]
    return x, params, cot


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def fused_vs_plain(fc):
    """Phase 6: kernel 2 against its plain version, and against itself."""
    out = {}
    cases = [(*TRAIN_SHAPE, torch.float32), (*TRAIN_SHAPE, torch.bfloat16),
             (2, 95, 256, 16, torch.float32), (2, 101, 256, 8, torch.float32),
             (2, 87, 256, 4, torch.float32), (2, 87, 256, 4, torch.bfloat16)]
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


def train(wpt_cuda, fused_cuda, root: str):
    """Phase 7: the training path through ``run_experiment`` on the card."""
    from audiodeepfake_detection_tpu_torch.train.experiment import run_experiment
    from audiodeepfake_detection_tpu_torch.train.serve import service_from_snapshot

    t0 = time.perf_counter()
    data = write_corpus(root)
    log(f"  corpus: 56 clips of 10 s written in {time.perf_counter() - t0:.1f} s")

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

    # the snapshot behind the serving path scores like the trainer itself
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
    return {"launches": counts, "steps": steps, "eval_steps": eval_steps,
            "losses": losses, "fused_losses": pair["fused"],
            "unfused_losses": pair["unfused"], "loss_rel_diff": worst,
            "served_vs_trainer": err, "wall_s": wall,
            "norm": [np.asarray(v).tolist() for v in trainer.norm_stats]}


def step_fns(norm, fused: bool):
    """A train step and an eval step at full width on a fixed device batch."""
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.train.steps import (
        make_eval_step, make_optimizer, make_train_step)
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)

    args = train_args("", "", "")
    transform = normalized_transform(make_transform(args), *[np.asarray(v) for v in norm])
    torch.manual_seed(0)
    model = DCNN(time_dim=12, fused_layer1=fused).cuda()
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
    longer to enqueue the 0.3 ms backward than the card to run it, and the
    events would time the host."""
    x, params, cot = fused_case(fc, *TRAIN_SHAPE, torch.float32, seed=20)
    raw = [p.detach() for p in params]
    out, code, _, _ = fused_cuda.forward(x, *raw, True, True)
    plain_graph = fc.plain_conv1_prelu_pool_stats(x, *params)
    fwd = median_ms({
        "plain": lambda: fc.plain_conv1_prelu_pool_stats(x, *params),
        "kernel": lambda: fused_cuda.forward(x, *raw, True, True),
    }, reps=10)
    bwd = median_ms({
        "plain": lambda: torch.autograd.grad(plain_graph, params, cot, retain_graph=True),
        "kernel": lambda: fused_cuda.backward(x, *raw, cot[0], out, code, cot[1], cot[2]),
    }, reps=10)
    with torch.no_grad():
        infer = median_ms({
            "plain": lambda: fc.plain_conv1_prelu_pool(x, *params),
            "kernel": lambda: fused_cuda.forward(x, *raw, False, False),
        }, reps=10)
    del plain_graph, out, code
    fused_train, fused_eval = step_fns(norm, True)
    plain_train, _ = step_fns(norm, False)
    steps = median_ms({"unfused": plain_train, "fused": fused_train}, reps=3)
    evals = median_ms({"eval": fused_eval}, reps=3)
    out = {
        "fwd_kernel_ms": fwd["kernel"], "fwd_plain_ms": fwd["plain"],
        "bwd_kernel_ms": bwd["kernel"], "bwd_plain_ms": bwd["plain"],
        "infer_fwd_kernel_ms": infer["kernel"], "infer_fwd_plain_ms": infer["plain"],
        "train_step_fused_ms": steps["fused"], "train_step_unfused_ms": steps["unfused"],
        "train_fused_frames_per_s": BATCH / steps["fused"] * 1e3,
        "train_unfused_frames_per_s": BATCH / steps["unfused"] * 1e3,
        "eval_step_ms": evals["eval"], "eval_frames_per_s": BATCH / evals["eval"] * 1e3,
    }
    log(f"  B={BATCH} [{card_line}]: fused block fwd (train) kernel {fwd['kernel']:.4f} ms, "
        f"plain {fwd['plain']:.4f} ms; bwd kernel {bwd['kernel']:.4f} ms, plain "
        f"{bwd['plain']:.4f} ms; fwd (no grad) kernel {infer['kernel']:.4f} ms, plain "
        f"{infer['plain']:.4f} ms")
    log(f"  train step fused {steps['fused']:.3f} ms ({out['train_fused_frames_per_s']:.1f} "
        f"frames/s), unfused {steps['unfused']:.3f} ms "
        f"({out['train_unfused_frames_per_s']:.1f} frames/s); eval step "
        f"{evals['eval']:.3f} ms ({out['eval_frames_per_s']:.1f} frames/s)")
    return out, fused_train


# kernel-name fragments (lower case) -> group, first match wins
KERNEL_GROUPS = (
    ("fused_conv1", ("fused_conv1",)),
    ("wpt_cascade", ("wpt_cascade",)),
    ("convolution", ("fft", "gemm", "wgrad", "dgrad", "fprop", "pointwise_mult_and_sum",
                     "region_transform", "nhwctonchw", "nchwtonhwc", "cudnn::engines",
                     "implicit", "conv")),
    ("batch_norm", ("batch_norm", "bn_")),
    ("max_pool", ("max_pool",)),
    ("optimizer", ("multi_tensor",)),
    ("reduce", ("reduce_kernel",)),
    ("softmax_loss", ("softmax", "nll_loss")),
)


def profile_train(train_step, n: int = 5):
    """Phase 9: device time by kernel over ``n`` fused train steps."""
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
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    log(f"  wall {wall_ms:.3f} ms/step (profiler on), device kernels {device_ms:.3f} ms/step "
        f"({100 * device_ms / wall_ms:.1f} % busy)")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, ms, _ in rows:
        low = name.lower()
        hit = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        groups[hit] += ms
    log("  by group (ms/step): " + ", ".join(f"{g} {ms:.3f}" for g, ms in groups.items()))
    ours = [r for r in rows if "fused_conv1" in r[0] or "wpt_cascade" in r[0]]
    for name, ms, count in ours + rows[:12]:
        log(f"    {ms:8.3f} ms  x{count:<3d} {name[:100]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "groups": groups,
            "top": [{"name": n_[:100], "ms": ms, "calls": c}
                    for n_, ms, c in ours + rows[:12]]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    from audiodeepfake_detection_tpu_torch.ops import (
        fused_conv1, fused_conv1_cuda, wpt, wpt_cuda)

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

    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # one nvcc each
        builds = list(pool.map(timed_build, (wpt_cuda, fused_conv1_cuda)))
    build_s = {}
    for mod, (report, secs) in zip((wpt_cuda, fused_conv1_cuda), builds):
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
        log("[7 train]")
        trained = train(wpt_cuda, fused_conv1_cuda, root)
    log("[8 time, training]")
    train_times, fused_step = train_timing(
        fused_conv1, fused_conv1_cuda, trained["norm"], card_line)
    log("[9 profile, fused train step]")
    prof = profile_train(fused_step)

    main_key = f"{MAIN[0]}-L{MAIN[1]}-B64-T{SR}"
    train_key = "B{}-H{}-W{}-C{}-float32".format(*TRAIN_SHAPE)
    fused_src = "audiodeepfake_detection_tpu_torch/csrc/fused_conv1.cu"
    wpt_b, wpt_by = wpt_bound(wpt, 64, SR)
    (fwd_b, fwd_by), (bwd_b, bwd_by) = fused_bounds(*TRAIN_SHAPE)
    # library_ms is null throughout: no single PyTorch call computes a
    # wavelet-packet cascade, or conv + PReLU + pool with moments, or its
    # parameter gradients from a selection code
    print(json.dumps({"kernels": [
        {
            "name": "wpt_cascade", "route": "cuda",
            "source": "audiodeepfake_detection_tpu_torch/csrc/wpt_cascade.cu",
            "replaces": "audiodeepfake_detection_tpu/ops/wpt_pallas.py:287",
            "launches": served["launches"], "train_launches": trained["launches"]["wpt"],
            "max_abs_err": errs[main_key],
            "ms": times[64]["wpt_kernel_ms"], "plain_ms": times[64]["wpt_plain_ms"],
            "bound_ms": wpt_b, "bound_by": wpt_by, "library_ms": None,
        },
        {
            "name": "fused_conv1_fwd", "route": "cuda", "source": fused_src,
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv1.py:376",
            "launches": trained["launches"]["fwd"],
            "max_abs_err": fused_errs[train_key]["fwd_max_abs_err"],
            "ms": train_times["fwd_kernel_ms"], "plain_ms": train_times["fwd_plain_ms"],
            "bound_ms": fwd_b, "bound_by": fwd_by, "library_ms": None,
        },
        {
            "name": "fused_conv1_bwd", "route": "cuda", "source": fused_src,
            "replaces": "audiodeepfake_detection_tpu/ops/fused_conv1.py:472",
            "launches": trained["launches"]["bwd"],
            "max_abs_err": fused_errs[train_key]["dW_max_abs_err"],
            "ms": train_times["bwd_kernel_ms"], "plain_ms": train_times["bwd_plain_ms"],
            "bound_ms": bwd_b, "bound_by": bwd_by, "library_ms": None,
        },
    ]}))
    trained.pop("norm")
    print(json.dumps({
        "card": card_line, "build_s": build_s, "max_abs_err": errs,
        "serve": served, "timing": times, "fused_vs_plain": fused_errs,
        "train": trained, "train_timing": train_times, "profile": prof,
    }))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
