"""Tracing and step-time observability.

Counterpart of ``audiodeepfake_detection_tpu/train/profiling.py``:

* ``trace(dir)``     context manager around ``torch.profiler``: host and
  device activity, written into ``dir`` as a Chrome trace (open it in
  Perfetto or ``chrome://tracing``);
* ``annotate(name)`` a ``torch.profiler.record_function`` range, so a
  phase shows up on the trace's timeline;
* ``StepTimer``      cheap wall-clock step / frames-per-second counters the
  Trainer logs per epoch.  Kernels run asynchronously, so a rate is
  meaningful over a window that ends on a host sync (the Trainer reads it
  after fetching the epoch's losses).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body (CPU, and CUDA where a card is present) and write
    ``<log_dir>/trace_<pid>_<time>.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:  # a body that raised still leaves its trace
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named range on the trace's timeline (``with annotate("eval"):``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling step-time / throughput counter."""

    def __init__(self, frames_per_step: int) -> None:
        self.frames_per_step = frames_per_step
        self.reset()

    def reset(self) -> None:
        self.start = time.time()
        self.steps = 0

    def step(self) -> None:
        self.steps += 1

    @property
    def seconds(self) -> float:
        return time.time() - self.start

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.seconds, 1e-9)

    @property
    def frames_per_sec(self) -> float:
        return self.steps_per_sec * self.frames_per_step

    def summary(self) -> str:
        return (
            f"{self.steps} steps in {self.seconds:.1f}s "
            f"({self.steps_per_sec:.2f} steps/s, "
            f"{self.frames_per_sec:.0f} frames/s)"
        )
