"""Run one cell of the port's benchmark on the card; print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (``setup_s``, from the start of this
process) draws weights and inputs from the seed and warms every shape the
cell uses; the window then measures for ``--seconds``.  With ``--trace 1``
the first seconds of the window are profiled and the cell's per-layer
metrics are reported in place of its end-to-end ones.  After the window
the program's state is freed and the plain reference checks what the timed
path produced; each compared number is printed beside its limit, last on
standard error and last in the result line (``checks``).  The result is
the last line of standard output.  Exit codes: 3 no card (or too few),
4 a banned module was loaded, 5 the trace kept no record of a kernel the
cell launched.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout, in place of this script's folder

from gpubench import cells, guard  # noqa: E402

#: seconds of the window a --trace 1 run profiles
TRACE_SECONDS = 3.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_query():
    """``nvidia-smi``'s card name and power limit, asked for at once and
    read (:func:`card_line`) when set-up is done, so it adds no time."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def card_line(query) -> str:
    if query is None:
        return "power limit not read"
    if query.returncode is None:
        try:
            query.output = query.communicate(timeout=30)[0]
        except subprocess.SubprocessError:
            query.kill()
            query.communicate()
            query.output = ""
    out = query.output.strip().splitlines()
    return out[0] if out else "power limit not read"


def kernel_counters() -> dict:
    """Each kernel name the work files know -> the program counter of its
    launches."""
    return {name: counter for path in (cells.BENCH_DIR / "work").glob("[!_]*.py")
            for name, counter in getattr(cells.load_module(path), "KERNELS", {}).items()}


def counters_probe():
    """Reads the program's launch counters that the work files name."""
    from gpubench import port

    names = sorted(set(kernel_counters().values()))
    return lambda: {n: port.counter(n) for n in names}


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def measure(cell: cells.Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set-up, window, trace and check of one run on ``device`` (the card
    for a result; the CPU only in tests): the result line's fields and the
    compared numbers (``checks``: name -> (value, limit))."""
    import torch

    from gpubench import inputs
    from gpubench.trace import Tracer

    run = cells.traffic_module(cell.mix["kind"]).Run(cell, seed, device, seconds)
    t_setup = time.perf_counter()
    run.setup()
    inputs.sync(device)
    # the set-up's objects leave the collector's generations: a full
    # collection over them would stall the window's threads
    gc.collect()
    gc.freeze()
    t_window = time.perf_counter()
    setup_s = t_window - T_START
    marks = [("process and card", t_setup), *run.marks[1:], ("warm-up", t_window)]
    log("set-up phases (s): " + ", ".join(
        f"{name} {b - a:.3f}" for (name, b), (_, a) in zip(marks, [("", T_START)] + marks)))
    tracer = Tracer(min(seconds, TRACE_SECONDS) if trace else None,
                    counters_probe() if trace else dict)
    out = run.window(seconds, tracer)
    cuda = torch.device(device).type == "cuda"
    line = {"attempted": out["attempted"], "failed": out["failed"], "metrics": {},
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                       "count": cell.chips,
                       "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
                       if cuda else 0}}
    log(f"set-up {setup_s:.3f} s; window: {json.dumps(out.get('notes', {}), default=float)} "
        f"attempted {out['attempted']}, failed {out['failed']}")
    if trace:
        view = tracer.view()
        view.cell = cell.config
        view.counts = {**{k: tracer.delta(k) for k in tracer.marks["start"]},
                       **run.trace_counts(tracer)}
        line["device"].update(busy_s=view.busy_s, window_s=view.window_s)
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"]).read(view)
            if value is not None:
                line["metrics"][m["name"]] = metric(value, m["unit"])
        line["breakdown"] = view.breakdown()
        log(f"trace: {len(view.device)} device records, counts {json.dumps(view.counts)}, "
            f"records kept {json.dumps(kept(view))}")
    else:
        values = {**out["metrics"], "setup_s": setup_s}
        for m in cell.end_to_end:
            line["metrics"][m["name"]] = metric(values[m["name"]], m["unit"])
    run.free()
    numbers = run.check()["program"]
    line["checks"] = {k: (float(v), float(cell.limits[k])) for k, v in numbers.items()}
    line["correct"] = (not out["failed"]
                       and all(v <= lim for v, lim in line["checks"].values()))
    return line


def kept(view) -> dict:
    """Records of each of the port's kernels over its launches in the
    traced window (CUPTI may lose some)."""
    return {name: view.kernel_ms(name)[1] / view.counts[counter]
            for name, counter in kernel_counters().items() if view.counts.get(counter)}


def finite(x):
    """``x`` with every non-finite float as None (JSON has no infinity)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = cells.load_cell(args.workload)
    # every cache the run may write lies at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    query = card_query()
    try:
        return run_cell(cell, args, query)
    finally:
        card_line(query)  # the query has ended, whatever the run did


def run_cell(cell: cells.Cell, args, query) -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return 3
    # the configuration's float32 parity mode, as the port's trainer sets it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from gpubench.trace import TraceError

    try:
        line = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"))
    except TraceError as exc:
        log(f"trace: {exc}")
        return 5
    log(f"card: {card_line(query)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    found = guard.banned_modules(sys.modules)
    if found:
        log(f"banned modules loaded: {found}")
        return 4
    for k, (v, lim) in line["checks"].items():
        log(f"check {k} {v!r} limit {lim!r}")
    keys = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
    print(json.dumps(finite({k: line[k] for k in keys if k in line})), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
