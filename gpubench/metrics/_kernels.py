"""What the kernel readers share: a kernel's roofline share over the traced
window.

Device time a step: each of the kernel's names, its mean record duration
times its launches (the program's launch counters over the window) over
the steps.  Least time a step: each launch kind's larger of bytes over
the peak bandwidth and operations over the peak product rate
(``peaks.json``), times its launches, over the steps.  A kernel the step
does not launch has no share (None); one it launches but the trace kept
no record of fails the run.
"""

from __future__ import annotations

from typing import Optional

from gpubench import cells
from gpubench.trace import TraceError, TraceView


def least_ms(flops: float, nbytes: float) -> float:
    peaks = cells.data("peaks")
    return 1e3 * max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["product_flop_per_s"])


def roofline(view: TraceView, kernel: str) -> Optional[float]:
    work = cells.work_module(kernel)
    steps = view.counts["steps"]
    launches = {c: view.counts.get(c, 0) for c in set(work.KERNELS.values())}
    device_ms = 0.0
    for name, counter in work.KERNELS.items():
        if not launches[counter]:
            continue
        mean, records = view.kernel_ms(name)
        if not records:
            raise TraceError(f"{name}: launched {launches[counter]} times in the traced "
                             "window, and the trace kept no record of it")
        device_ms += mean * launches[counter] / steps
    if not device_ms:
        return None
    least = sum(least_ms(*fb) * launches[c] / steps
                for c, fb in work.work(view.cell, view.counts["batch"]).items())
    return 100.0 * least / device_ms
