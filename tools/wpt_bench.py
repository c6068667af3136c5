"""Time the port's wavelet-packet kernels on one CUDA card.

Two modes, each printing one JSON line (and writing it to ``--out``):

``sweep``: every split depth and top route that fits, forced through
``wpt_packets_cuda(..., plan=...)`` at 1 s and 2 s of sym5 level 8 with the
log, for B = 1, 8, 64 and 128; each plan's output must equal the automatic
plan's bit for bit and the plain cascade within ``RAW_ATOL``.  Per plan:
the time through the launcher (CUDA events over back-to-back calls), the
time of one call replayed from a CUDA graph (device time with the gaps
between its launches, without the host) and the profiler's kernel time.

``compare --root DIR``: the public entry point of the checkout at ``DIR``
(this repository or an older commit unpacked elsewhere) at the same
geometries, with ``chip_smoke.py``'s phase-3 readings, phase-5 scorer
times and the DCNN train step with all three fusion flags from that
checkout; and the DCNN's fused first block (kernel 2, ``fused_conv1_cuda``)
at B = 128, H = 95, W = 256, C = 64 in fp32, forward and backward through
the launcher and as profiler device time, the DCNN train step with
``fused_layer1`` alone, and the copies of its block's [128, 64, 48, 129]
output or cotangent into another layout per step.  Run it on two
checkouts in one call, in turns (parent, change, change, parent), to
compare them on one card.

    python tools/wpt_bench.py sweep --out build/wpt_sweep.json
    python tools/wpt_bench.py compare --root build/parent --out build/parent-1.json
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

SR = 22050
MAIN = ("sym5", 8)
RAW_ATOL = 2e-5
WINDOWS = 7
#: (B, T): the 1 s batches and phase 20's 2 s DCNN batch
GEOMETRIES = ((1, SR), (8, SR), (64, SR), (128, SR), (64, 2 * SR))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Median over WINDOWS windows of CUDA-event ms per call of ``fn``."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 50) -> float:
    """One call of ``fn`` captured in a CUDA graph and replayed: device time
    per call with the gaps between its kernels, without the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return events_ms(graph.replay, reps)


def device_ms(wpt_cuda, fn, n: int = 20) -> float:
    """Device ms per call of ``fn`` in the WPT kernels: their mean duration
    in a profile of ``n`` calls times the kernel launches one call makes,
    read from the launch counters (this checkout's or an older one's), so
    a profile that lost a few records still reads right."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def launched():
        # the first kernel counted its calls in LAUNCHES (one launch each)
        # and LONG_LAUNCHES (one per call of ``level`` launches)
        return (wpt_cuda.LAUNCHES + getattr(wpt_cuda, "LEVEL_LAUNCHES", 0)
                + getattr(wpt_cuda, "LONG_LAUNCHES", 0) * MAIN[1])

    before = launched()
    fn()
    torch.cuda.synchronize()
    launches = launched() - before
    for _ in range(3):
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


def kernel_device_ms(fn, key: str, n: int = 20) -> float:
    """Device ms per call of ``fn`` in the kernel whose name holds ``key``
    (launched once a call): the mean duration of its records in a profile
    of ``n`` calls, so a profile that lost a few records still reads right."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that lost every record is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key]
        count = sum(e.count for e in rows)
        if count:
            return sum(e.self_device_time_total for e in rows) / count / 1e3
    raise AssertionError(f"three profiles show no {key}")


def transposing_copies(step, numel: int, n: int = 3) -> float:
    """Copies of ``numel`` elements into new memory (``contiguous``,
    ``clone``, ``to``) per call of ``step``, from the profiler's shapes; a
    deliberate copy of that size is counted first, so a profiler that
    records no shapes fails instead of reading 0."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    def count(fn, reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events()
                   if e.name == "aten::copy_" and e.input_shapes and e.input_shapes[0]
                   and int(np.prod(e.input_shapes[0])) == numel and e.cpu_parent is not None
                   and e.cpu_parent.name in ("aten::clone", "aten::_to_copy"))

    probe = torch.empty(numel, device="cuda")
    if count(lambda: probe.reshape(-1, 32).t().contiguous(), 1) != 1:
        raise AssertionError("the profiler did not show a deliberate copy")
    step()
    torch.cuda.synchronize()
    return count(step, n) / n


def first_block(fcc) -> dict:
    """Kernel 2 at the DCNN's training shape through this checkout's
    launchers: the forward with code and moments, the backward with the
    moments' cotangents.  The first kernel's backward took the output and
    an NHWC cotangent; the redesigned one takes neither the output nor
    another layout than NCHW: each gets the same values in its own."""
    import inspect

    import torch

    b, h, w, c = 128, 95, 256, 64
    h2, w2 = (h + 2) // 2, (w + 2) // 2
    gen = torch.Generator().manual_seed(20)
    x = torch.randn(b, h, w, generator=gen).cuda()
    params = [(0.3 * torch.randn(9, c, generator=gen)).cuda(),
              (0.1 * torch.randn(c, generator=gen)).cuda(), torch.tensor([0.25]).cuda()]
    g = torch.randn(b, c, h2, w2, generator=gen).cuda().permute(0, 2, 3, 1)
    gs, gq = (0.01 * torch.randn(c, generator=gen)).cuda(), (0.001 * torch.randn(c, generator=gen)).cuda()
    out, code, _, _ = fcc.forward(x, *params, True, True)

    def forward():
        fcc.forward(x, *params, True, True)

    if "out" in inspect.signature(fcc.backward).parameters:
        g = g.contiguous()

        def backward():
            fcc.backward(x, *params, g, out, code, gs, gq)
    else:
        def backward():
            fcc.backward(x, *params, g, code, gs, gq)

    return {"fwd_launcher_ms": events_ms(forward, 10), "bwd_launcher_ms": events_ms(backward, 10),
            "fwd_device_ms": kernel_device_ms(forward, "fused_conv1_fwd_kernel"),
            "bwd_device_ms": kernel_device_ms(backward, "fused_conv1_bwd_kernel")}


def sweep(batches, seconds, max_split) -> dict:
    import torch

    from audiodeepfake_detection_tpu_torch.ops import wpt, wpt_cuda

    gen = torch.Generator().manual_seed(11)
    sms, limit = wpt_cuda.device_limits(0)
    rows = []
    for b, t in [(b, s * SR) for s in seconds for b in batches]:
        x = torch.randn(b, t, generator=gen).cuda()
        auto = wpt_cuda.wpt_plan(b, t, 10, MAIN[1], sms, limit)
        ref = wpt_cuda.wpt_packets_cuda(x, *MAIN)
        plain = wpt.wpt_analysis(x, *MAIN)
        lengths = wpt_cuda.level_lengths(t, 10, MAIN[1])
        for k in range(min(MAIN[1], max_split + 1)):
            for top in (("frame",) if k <= 1 else ("path", "levels")):
                plan = wpt_cuda.make_plan(lengths, 10, k, top, b, sms, limit)
                if plan.smem_bytes > limit:
                    continue
                got = wpt_cuda.wpt_packets_cuda(x, *MAIN, plan=plan)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"B={b} T={t} {plan}: differs from {auto}")
                err = (got - plain).abs().max().item()
                if not err <= RAW_ATOL:
                    raise AssertionError(f"B={b} T={t} {plan}: {err} from plain")

                def call(plan=plan):
                    wpt_cuda.wpt_packets_cuda(x, *MAIN, log_scale=True, plan=plan)

                row = {"b": b, "t": t, "split": k, "top": top, "threads": plan.threads,
                       "smem_bytes": plan.smem_bytes, "auto": plan == auto,
                       "max_abs_err": err, "launcher_ms": events_ms(call, 20),
                       "graph_ms": graph_ms(call), "device_ms": device_ms(wpt_cuda, call)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return {"card": card(), "sweep": rows}


def compare(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke
    from audiodeepfake_detection_tpu_torch.ops import fused_conv1_cuda, wpt, wpt_cuda

    if not wpt_cuda.__file__.startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {wpt_cuda.__file__}, not from {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    wpt_cuda.build()
    out = {"card": card(), "root": root, "phase3": chip_smoke.kernel_vs_plain(wpt_cuda, wpt)}
    gen = torch.Generator().manual_seed(3)
    for b, t in GEOMETRIES:
        x = torch.randn(b, t, generator=gen).cuda()

        def call():
            wpt_cuda.wpt_packets_cuda(x, *MAIN, log_scale=True)

        out[f"wpt-B{b}-T{t}"] = {"launcher_ms": events_ms(call, 20),
                                 "graph_ms": graph_ms(call), "device_ms": device_ms(wpt_cuda, call)}
        print(json.dumps({f"wpt-B{b}-T{t}": out[f"wpt-B{b}-T{t}"]}), flush=True)
    build_root = os.path.join(os.path.abspath(root), "build")
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as tmp:
        snapshot = chip_smoke.write_snapshot(tmp)
        times = chip_smoke.timing(wpt_cuda, wpt, snapshot, out["card"])
    out["scorer_ms"] = {b: times[b]["scorer_kernel_ms"] for b in (64, 128)}
    norm = [np.asarray([-5.0]), np.asarray([4.0])]
    train_step, _ = chip_smoke.step_fns(norm, True, fused_pool=True, fused_layer2=True)
    out["dcnn_step_b_ms"] = chip_smoke.median_ms({"b": train_step}, reps=3)["b"]
    del train_step
    out["first_block"] = first_block(fused_conv1_cuda)
    print(json.dumps({"first_block": out["first_block"]}), flush=True)
    step_a, _ = chip_smoke.step_fns(norm, True)  # fused_layer1 alone
    out["dcnn_step_a_ms"] = chip_smoke.median_ms({"a": step_a}, reps=3)["a"]
    out["dcnn_step_a_transposing_copies"] = transposing_copies(step_a, 128 * 64 * 48 * 129)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("sweep", "compare"))
    parser.add_argument("--batches", default="1,8,64,128", help="sweep: batch sizes")
    parser.add_argument("--seconds", default="1,2", help="sweep: frame lengths (s)")
    parser.add_argument("--max-split", type=int, default=7, help="sweep: deepest k")
    parser.add_argument("--root", default=".", help="checkout to compare (compare mode)")
    parser.add_argument("--out", help="also write the JSON line here")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wpt_bench: needs a CUDA device")
    if args.mode == "sweep":
        sys.path.insert(0, os.getcwd())
        result = sweep([int(v) for v in args.batches.split(",")],
                       [int(v) for v in args.seconds.split(",")], args.max_split)
    else:
        result = compare(args.root)
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
