"""Where the port's int8 convolution sites spend their time on one CUDA card.

Four modes, each printing JSON lines (the last also written to ``--out``):

``sites``: the site kernel (``adfd::int8_conv_site``, baked layout) at each
of the DCNN's six int8 sites, B = 64 (``--batch``), float32: device ms
(CUDA events around back-to-back launches queued behind a spin of the
card) with the fold's map and the bias, and with the bias alone, beside
what the same bytes cost this card in one PyTorch call each (``fill_`` of
the output, ``copy_`` of it, a sum over the input) and the site's fused
bound (``chip_smoke.int8_bound``).

``phases``: the MMA route's phases inside each CTA: a copy of
``csrc/int8_conv.cu`` built with ``%globaltimer`` stamps (the CTA's start,
its prologue's end, its K loop's end, its end) into ``build/``; per site
the median of each phase over the CTAs, the span of the launch and the
mean number of CTAs in flight.

``compare``: the site kernel's choices at each of the DCNN's six sites, B =
64, float32, timed in one process in turns (device ms, as ``sites``): the
MMA route's prologue by loads into registers against ``cp.async`` of the
halo's NCHW rows (``STAGE_LOADS`` / ``STAGE_ROWS``), each at runs of 32, 48
and 64 columns (``MAX_RUN`` / ``ROWS_RUN``; ``*`` marks the launcher's
plan), every plan's output checked against plain bit for bit; and the
codes-in mode (a launch on NHWC codes) with its loads into registers
against its ``cp.async`` of 16-byte code words (``STAGE_CODES``).

``layers --root DIR``: the checkout at ``DIR`` (this one, or an older
commit unpacked under ``build/``): each DCNN site as the model runs it
(``models/layers.py``: ``folded_bn_conv(act_scale=)`` or
``quantized_conv_bias`` on a record baked at its first call) and the DCNN
scorer (packets-sym5 level 8, random weights and BatchNorm statistics) in
float32, bf16 and int8 at B = 64 and 128, CUDA-event medians.  Run it on
two checkouts in one call, in turns (parent, change, change, parent), to
compare them on one card.

    python tools/int8_site_probe.py sites --out build/int8_sites.json
    python tools/int8_site_probe.py compare --out build/int8_compare.json
    python tools/int8_site_probe.py layers --root build/parent --out build/p1.json
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

SR = 22050
WINDOWS = 7
# (Cin, Cout, k, padding, dilation, H, W) of the DCNN's int8 sites on 1 s
# packets-sym5 (chip_smoke.py's INT8_DCNN_SITES), and those with no
# BatchNorm in front, for a checkout whose chip_smoke.py predates them
DCNN_SITES = {
    "cnn_0": (1, 64, 3, 2, 1, 95, 256), "cnn_4": (64, 64, 1, 0, 1, 48, 129),
    "cnn_7": (64, 96, 3, 1, 1, 48, 129), "cnn_11": (96, 128, 3, 1, 1, 24, 64),
    "cnn_14": (128, 32, 3, 1, 1, 24, 64), "cnn_17": (32, 64, 3, 1, 1, 24, 64),
}
UNFOLDED = ("cnn_0",)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def device_ms(fn, n: int = 20) -> float:
    """Median over 5 windows of ms per call of ``fn``: ``n`` calls queued
    behind a spin of the card, so the host's work is not in the time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / n)
    return statistics.median(times)


def events_ms(fns: dict, reps: int = 5) -> dict:
    """Median over WINDOWS windows of CUDA-event ms per call, the order of
    the functions alternating between windows (host work included)."""
    import torch

    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
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
    return {k: statistics.median(v) for k, v in times.items()}


def sites(batch: int) -> list:
    import torch

    import chip_smoke as cs
    from audiodeepfake_detection_tpu_torch.ops import int8_conv  # noqa: F401 (the op)

    gen = torch.Generator().manual_seed(5)
    op = torch.ops.adfd.int8_conv_site.default
    rows = []
    for site, (cin, cout, k, pad, dil, h, w) in cs.INT8_DCNN_SITES.items():
        x, scale, rec, const, bias = cs.int8_site_case(gen, batch, cin, cout, k, pad, dil, h, w,
                                                       torch.float32,
                                                       transposed=site in cs.INT8_TRANSPOSED)
        y = op(x, scale, rec["w_q"], rec["s_w"], rec["rows"], None, bias, pad, dil)
        z = torch.empty_like(y)
        row = {
            "site": site, "batch": batch,
            "map_bias_ms": device_ms(lambda: op(x, scale, rec["w_q"], rec["s_w"], rec["rows"],
                                                const, bias, pad, dil)),
            "bias_ms": device_ms(lambda: op(x, scale, rec["w_q"], rec["s_w"], rec["rows"], None,
                                            bias, pad, dil)),
            "fill_out_ms": device_ms(lambda: y.fill_(1.0)),
            "copy_out_ms": device_ms(lambda: z.copy_(y)),
            "sum_in_ms": device_ms(lambda: x.sum()),
            "bound_ms": cs.int8_bound(batch, cin, cout, k, pad, dil, h, w,
                                      folded=site not in cs.INT8_UNFOLDED)[0],
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def compare(batch: int) -> list:
    import torch

    import chip_smoke as cs
    from audiodeepfake_detection_tpu_torch.ops import int8_conv as ic
    from audiodeepfake_detection_tpu_torch.ops import int8_conv_cuda as icc

    icc.build()
    kept = icc.MAX_RUN, icc.ROWS_RUN  # the launcher's, restored after each plan
    gen = torch.Generator().manual_seed(8)
    rows = []
    for site, (cin, cout, k, pad, dil, h, w) in cs.INT8_DCNN_SITES.items():
        folded = site not in cs.INT8_UNFOLDED
        x, scale, rec, const, bias = cs.int8_site_case(gen, batch, cin, cout, k, pad, dil, h, w,
                                                       torch.float32, folded,
                                                       site in cs.INT8_TRANSPOSED)
        want = ic.int8_conv_site_plain(x, scale, rec["w_q"], rec["s_w"], const, bias, pad, dil)
        ho, wo = icc.output_plane(h, w, k, pad, dil)
        inv = 1.0 / scale
        fns = {}
        chosen = icc.plan_for(x, cout, k, pad, dil)
        for staging in ((icc.STAGE_LOADS,) if cin == 1 else (icc.STAGE_LOADS, icc.STAGE_ROWS)):
            for run in ((64,) if cin == 1 else (32, 48, 64)):
                icc.MAX_RUN = icc.ROWS_RUN = run
                plan = icc.site_plan(h, w, cin, cout, k, pad, dil, staging, 4)
                icc.MAX_RUN, icc.ROWS_RUN = kept
                out = torch.empty(want.shape, device="cuda")

                def fn(plan=plan, out=out):
                    icc.launch(x, rec["rows"], rec["s_w"], const, bias, out, (batch, h, w, cin),
                               k, pad, dil, plan, inv, scale)
                    return out

                if not torch.equal(fn(), want):
                    raise AssertionError(f"{site}: staging {staging}, run {run} differs from plain")
                name = f"site-{('loads', 'codes', 'rows')[staging]}-{plan.tr}x{plan.tw}"
                fns[name + ("*" if plan == chosen else "")] = fn
        x_q = ic.quantize_activation_nhwc(x, scale)
        sx = scale * rec["s_w"]
        want_q = ic.int8_conv_plain(x_q, rec["w_q"], sx, pad, dil)
        for staging in (icc.STAGE_LOADS, icc.STAGE_CODES):
            plan = icc.site_plan(h, w, cin, cout, k, pad, dil, staging)
            out = torch.empty(want_q.shape, device="cuda")

            def fn(plan=plan, out=out):
                icc.launch(x_q, rec["rows"], sx, None, None, out, (batch, h, w, cin), k, pad,
                           dil, plan, 1.0, 1.0)
                return out

            if not torch.equal(fn(), want_q):
                raise AssertionError(f"{site}: codes in, staging {staging} differs from plain")
            fns[f"codes_in-{('loads', 'codes')[staging]}"] = fn
        names = list(fns)
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(device_ms(fns[name]))
        row = {"site": site, "batch": batch, "plane": [ho, wo],
               "device_ms": {name: statistics.mean(v) for name, v in times.items()},
               "readings": times}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, rec, const, bias, want, x_q, want_q, fns
    return rows


def traced_source(src: str) -> str:
    """The kernel source with ``%globaltimer`` stamps in the MMA route."""
    src = src.replace("namespace {\n", """namespace {
__device__ unsigned long long g_trace[1 << 16][5];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
""", 1)
    src = src.replace("""  tile_of(g, b, oh0, ow0);
  const int n0 = blockIdx.y * kBN;""", """  tile_of(g, b, oh0, ow0);
  const int n0 = blockIdx.y * kBN;
  const unsigned long long t0 = gtime();""", 1)
    src = re.sub(r"(  stage_halo<kIn, [^;]*;\n)", r"\1  const unsigned long long t1 = gtime();\n",
                 src, count=1)
    src = src.replace("""  __syncthreads();  // every warp is done with the codes""",
                      """  const unsigned long long t2 = gtime();
  __syncthreads();  // every warp is done with the codes""", 1)
    end = src.rindex("}\n", 0, src.index("// Cin = 1: a CTA a tile"))
    src = src[:end] + """  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < (1 << 16)) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    g_trace[blockIdx.x][0] = t0;
    g_trace[blockIdx.x][1] = t1;
    g_trace[blockIdx.x][2] = t2;
    g_trace[blockIdx.x][3] = gtime();
    g_trace[blockIdx.x][4] = smid;
  }
""" + src[end:]
    if src.count("gtime()") != 5:
        raise RuntimeError("the kernel source no longer has the phases this probe stamps")
    return src + """
extern "C" int int8_trace_read(void* dst, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, static_cast<size_t>(n) * 40));
}
"""


def phases(batch: int) -> list:
    from pathlib import Path

    import numpy as np
    import torch

    import chip_smoke as cs
    from audiodeepfake_detection_tpu_torch.ops import int8_conv_cuda as icc

    path = Path("build") / "int8_conv_traced.cu"
    path.parent.mkdir(exist_ok=True)
    path.write_text(traced_source(icc.SOURCE.read_text()))
    icc.SOURCE = path.resolve()
    icc.build()
    lib = icc._LIB
    lib.int8_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator().manual_seed(6)
    rows = []
    for site, (cin, cout, k, pad, dil, h, w) in cs.INT8_DCNN_SITES.items():
        if cin == 1:
            continue
        x, scale, rec, const, bias = cs.int8_site_case(gen, batch, cin, cout, k, pad, dil, h, w,
                                                       torch.float32)
        for _ in range(3):
            torch.ops.adfd.int8_conv_site.default(x, scale, rec["w_q"], rec["s_w"], rec["rows"],
                                                  const, bias, pad, dil)
        torch.cuda.synchronize()
        plan = icc.plan_for(x, cout, k, pad, dil)  # the plan the op launched
        ho, wo = icc.output_plane(h, w, k, pad, dil)
        n = batch * -(-ho // plan.tr) * -(-wo // plan.tw)
        buf = np.zeros((n, 5), np.uint64)
        if lib.int8_trace_read(buf.ctypes.data, n) != 0:
            raise RuntimeError("reading the trace failed")
        t = buf.astype(np.float64)
        span = (t[:, 3].max() - t[:, 0].min()) / 1e3
        row = {
            "site": site, "batch": batch, "ctas": n, "plan": plan._asdict(),
            "span_us": span, "ctas_in_flight": float((t[:, 3] - t[:, 0]).sum() / 1e3 / span),
            "prologue_us": float(np.median(t[:, 1] - t[:, 0]) / 1e3),
            "mma_us": float(np.median(t[:, 2] - t[:, 1]) / 1e3),
            "epilogue_us": float(np.median(t[:, 3] - t[:, 2]) / 1e3),
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def layers(root: str) -> dict:
    """The checkout at ``root``: each DCNN site as the model runs it, and the
    DCNN scorer in float32, bf16 and int8, B = 64 and 128."""
    sys.path.insert(0, os.path.abspath(root))
    import copy

    import numpy as np
    import torch
    from torch import nn

    from audiodeepfake_detection_tpu_torch.models import layers as L
    from audiodeepfake_detection_tpu_torch.models.dcnn import DCNN
    from audiodeepfake_detection_tpu_torch.ops import int8_conv_cuda, wpt_cuda
    from audiodeepfake_detection_tpu_torch.train.predict import (
        make_score_fn, quantize_for_scoring)
    from audiodeepfake_detection_tpu_torch.train.transforms import (
        make_transform, normalized_transform)
    from audiodeepfake_detection_tpu_torch.utils.config import default_config

    if not L.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {L.__file__}, not from {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    int8_conv_cuda.build()
    wpt_cuda.build()
    out = {"card": card(), "root": root, "sites": {}, "scorer_ms": {}}
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for b in (64, 128):
            for site, (cin, cout, k, pad, dil, h, w) in DCNN_SITES.items():
                conv = nn.Conv2d(cin, cout, k, padding=pad, dilation=dil).cuda().eval()
                x = torch.randn(b, cin, h, w, generator=gen).cuda()
                scale = float(x.abs().max()) / 127.0
                cache = {}

                def baked(make, cache=cache):  # the record, made at the first call only
                    if "rec" not in cache:
                        cache["rec"] = make()
                    return cache["rec"]

                if site in UNFOLDED:
                    fn = lambda: L.quantized_conv_bias(conv, x, scale, baked)  # noqa: E731
                else:
                    bn = nn.BatchNorm2d(cin).cuda().eval()
                    bn.running_mean.uniform_(-0.5, 0.5)
                    bn.running_var.uniform_(0.5, 2.0)
                    fn = lambda: L.folded_bn_conv(bn, conv, x, act_scale=scale,  # noqa: E731
                                                  baked=baked)
                out["sites"][f"{site}-B{b}"] = events_ms({"layer": fn})["layer"]
        cfg = default_config()
        cfg.update(transform="packets", wavelet="sym5", num_of_scales=256, log_scale=True)
        transform = normalized_transform(make_transform(cfg), np.asarray([-5.0], np.float32),
                                         np.asarray([4.0], np.float32))
        torch.manual_seed(0)
        model = DCNN(time_dim=12).eval()
        for mod in model.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.5, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
        bf = copy.deepcopy(model)
        bf.dtype = torch.bfloat16
        audio = {b: (0.3 * torch.randn(b, 1, SR, generator=gen)).cuda() for b in (64, 128)}
        q = quantize_for_scoring(model, transform, list(audio[128][:, 0].cpu().numpy()), "cuda",
                                 64)
        scorers = {"fp32": make_score_fn(model, transform, "cuda"),
                   "bf16": make_score_fn(bf, transform, "cuda"),
                   "int8": make_score_fn(q, transform, "cuda")}
        for b, a in audio.items():
            out["scorer_ms"][b] = events_ms({k: (lambda fn=fn: fn(a)) for k, fn in scorers.items()})
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("sites", "phases", "compare", "layers"))
    parser.add_argument("--batch", type=int, default=64,
                        help="sites, phases, compare: the batch")
    parser.add_argument("--root", default=".", help="layers: the checkout to time")
    parser.add_argument("--out", help="also write the result here")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int8_site_probe: needs a CUDA device")
    if args.mode != "layers":
        sys.path.insert(0, os.getcwd())
        torch.backends.cudnn.allow_tf32 = False
    if args.mode == "sites":
        result = {"card": card(), "sites": sites(args.batch)}
    elif args.mode == "compare":
        result = {"card": card(), "compare": compare(args.batch)}
    elif args.mode == "phases":
        result = {"card": card(), "phases": phases(args.batch)}
    else:
        result = layers(args.root)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
