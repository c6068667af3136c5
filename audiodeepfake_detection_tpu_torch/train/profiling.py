"""Step-time observability.

Counterpart of ``StepTimer`` in
``audiodeepfake_detection_tpu/train/profiling.py``: cheap wall-clock
step / frames-per-second counters the Trainer logs per epoch.  Kernels run
asynchronously, so a rate is meaningful over a window that ends on a host
sync (the Trainer reads it after fetching the epoch's losses).
"""

from __future__ import annotations

import time


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
