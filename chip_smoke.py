"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure propagates and the script exits non-zero
(there is no CPU fallback):

1. device: require CUDA, print ``nvidia-smi``'s card name and power limit;
2. build: compile ``csrc/wpt_cascade.cu`` for sm_90a from this checkout;
3. kernel vs plain: the wavelet-packet kernel against the plain PyTorch
   cascade on the card, at the serving shapes and a few other geometries;
4. serve: a seeded full-width DCNN snapshot behind ``service_from_snapshot``
   on ``cuda``, answering concurrent HTTP uploads; scores checked against
   the same snapshot scored on the CPU, and the kernel's launch count read
   over exactly this run;
5. time: CUDA-event medians of the kernel vs the plain cascade, and of the
   whole scorer (device audio -> P(fake)) with each, at batch 64 and 128.

The last lines are the kernels' JSON record, the measurements with the
card's name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device")
    from audiodeepfake_detection_tpu_torch.ops import wpt, wpt_cuda

    # fp32 convolutions on both sides of every comparison (TF32 keeps ~3
    # digits); the JAX reference runs its convolutions at HIGHEST
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card_line = card()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    report = wpt_cuda.build()
    build_s = time.perf_counter() - t0
    log(f"[2 build] wpt_cascade.cu -> sm_90a in {build_s:.3f} s\n{report.strip()}")

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

    main_key = f"{MAIN[0]}-L{MAIN[1]}-B64-T{SR}"
    print(json.dumps({"kernels": [{
        "name": "wpt_cascade",
        "route": "cuda",
        "source": "audiodeepfake_detection_tpu_torch/csrc/wpt_cascade.cu",
        "replaces": "audiodeepfake_detection_tpu/ops/wpt_pallas.py:250",
        "launches": served["launches"],
        "max_abs_err": errs[main_key],
        "ms": times[64]["wpt_kernel_ms"],
        "plain_ms": times[64]["wpt_plain_ms"],
    }]}))
    print(json.dumps({
        "card": card_line, "build_s": build_s, "max_abs_err": errs,
        "serve": served, "timing": times,
    }))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
