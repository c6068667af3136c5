"""The ``--trace 1`` run's profile: ``torch.profiler`` over the first
seconds of the measured window, reduced to what the per-layer readers need.

The profile keeps nothing on disk.  Its device records give the busy time
(the union of every kernel's, copy's and set's interval), each kernel's
mean record duration, and the idle gaps; the host records in each gap name
what the host was doing.  CUPTI may lose records: a reader takes a
kernel's mean duration times its launches, which the program counts, and
never a plain sum of the records that a loss would make read low.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


class TraceError(RuntimeError):
    """The trace holds no record of work the program did."""


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop` when ``seconds`` is set;
    with ``None`` every method does nothing.  ``probe()`` gives the
    program's counters, read at both ends beside the run's own marks."""

    def __init__(self, seconds: Optional[float], probe=dict) -> None:
        self.seconds = seconds
        self.probe = probe
        self.prof = None
        self.t0 = self.window_s = None
        self.marks: dict = {}

    @property
    def on(self) -> bool:
        return self.seconds is not None

    def start(self, **marks) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        self.marks = {"start": {**self.probe(), **marks}}

    def due(self) -> bool:
        """The profile is running and has covered its seconds."""
        return (self.prof is not None and self.window_s is None
                and time.perf_counter() - self.t0 >= self.seconds)

    def stop(self, **marks) -> None:
        if self.prof is None or self.window_s is not None:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.marks["stop"] = {**self.probe(), **marks}
        self.prof.stop()

    def delta(self, key: str) -> float:
        return self.marks["stop"][key] - self.marks["start"][key]

    def view(self) -> "TraceView":
        if self.prof is None or self.window_s is None:
            raise TraceError("the profile did not run")
        device, host = [], []
        for e in self.prof.events():
            if e.is_user_annotation:  # a range, not work (on the device's timeline too)
                continue
            span = (e.name, float(e.time_range.start), float(e.time_range.end))
            (device if e.device_type == torch.autograd.DeviceType.CUDA else host).append(span)
        return TraceView(self.window_s, device, host)


def _union(spans: List[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


@dataclass
class TraceView:
    """A profile's records: ``(name, start us, end us)`` on the device and
    on the host, and the window's length on the host clock."""

    window_s: float
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    #: filled by the run: its counts over the traced window and its cell
    counts: Dict[str, float] = field(default_factory=dict)
    cell: object = None

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.device)) / 1e6

    def kernel_ms(self, fragment: str) -> Tuple[float, int]:
        """Mean duration (ms) and number of the records whose name holds
        ``fragment``."""
        durs = [b - a for name, a, b in self.device if fragment in name]
        return (sum(durs) / len(durs) / 1e3 if durs else 0.0), len(durs)

    def groups_ms(self, groups) -> Dict[str, float]:
        """Device ms of the records in each group (``[[group, [fragment,
        ...]], ...]``, lower-case fragments, first match wins)."""
        out: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            low = name.lower()
            hit = next((g for g, keys in groups if any(k in low for k in keys)), "other")
            out[hit] += (b - a) / 1e3
        return dict(out)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host operation that spans each."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            by_name[name] += (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = _union(self.device)
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])),
                      key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            spans = [h for h in self.host if h[1] <= mid <= h[2]]
            name = min(spans, key=lambda h: h[2] - h[1])[0] if spans else "no host operation"
            named.append([name, (b - a) / 1e6])
        return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": named}
