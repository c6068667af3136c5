"""Clips scored through the port's ``ScoringService.submit``, offered in an
open loop.

Mix parameters: ``rate_frames_per_s`` (the offered load, fixed), clip
lengths in whole seconds from a lognormal (``median_s``, ``sigma``,
clipped to ``min_s`` .. ``max_s``), the service's ``batch_size`` and
``max_wait_ms``, ``pool_frames`` (distinct frames drawn from the seed;
each clip is a run of them), ``norm_frames`` (frames the normalization
pass reads) and ``sample_clips`` (clips the reference redoes).

One generator thread submits each clip when it is due
(:func:`inputs.open_loop_schedule`); a clip's latency runs from the time
it was due to the time its future resolved, so a stall also delays the
clips behind it.  A clip that fails, or has not resolved a minute after
the window closed, is a miss.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from gpubench import cells, inputs, port, stats
from gpubench.reference import _common

#: seconds past the window's close that an unanswered clip is waited for
GRACE_S = 60.0


class Run:
    def __init__(self, cell: cells.Cell, seed: int, device, seconds: float) -> None:
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.mix = cell.config, cell.mix
        self.seconds = float(seconds)

    def clip(self, i: int) -> np.ndarray:
        return self.pool[self.start[i]: self.start[i] + self.lengths[i]]

    def setup(self) -> None:
        cfg, mix = self.cfg, self.mix
        self.marks = [("start", time.perf_counter())]
        self.model = port.model(cfg, self.device, train=False)
        self.weights = inputs.make_weights(port.shapes(self.model), self.seed, self.device)
        self.model.load_state_dict(self.weights)
        self.marks.append(("model and weights", time.perf_counter()))
        audio, _ = inputs.make_audio(int(mix["pool_frames"]), cfg["frame_samples"],
                                     cfg["sample_rate"], self.seed, self.device)
        self.marks.append(("audio", time.perf_counter()))
        self.mean, self.std = port.normalization(
            cfg, audio[: int(mix["norm_frames"])], int(mix["batch_size"]))
        self.marks.append(("normalization", time.perf_counter()))
        self.pool = audio[:, 0].cpu().numpy()
        del audio
        self.due, self.lengths, self.start = inputs.open_loop_schedule(
            mix, self.seed, self.seconds, int(mix["pool_frames"]))
        self.marks.append(("pool and schedule", time.perf_counter()))
        self.service = port.service(cfg, mix, self.model, self.mean, self.std, self.device)
        self.marks.append(("service", time.perf_counter()))
        self.service.start()
        # the dispatcher's first batches (pinned buffers, a split clip)
        warm = [self.service.submit(self.clip(i)) for i in np.argsort(-self.lengths)[:4]]
        for fut in warm:
            fut.result()
        inputs.sync(self.device)

    # ------------------------------------------------------------ window

    def _offer(self, t0: float) -> None:
        late = 0.0
        for i in range(len(self.due)):
            wait = t0 + self.due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            else:
                late = max(late, -wait)
            fut = self.service.submit(self.clip(i))
            fut.add_done_callback(lambda f, i=i: self.done.__setitem__(i, time.perf_counter()))
            self.futures[i] = fut
        self.late_s = late

    def window(self, seconds: float, tracer) -> dict:
        n = len(self.due)
        self.done = [None] * n
        self.futures = [None] * n
        svc = self.service
        start = svc.n_dispatches, svc.n_scored
        # the profiler takes seconds to start: before the window, not in it
        tracer.start(dispatches=svc.n_dispatches)
        t0 = time.perf_counter()
        offer = threading.Thread(target=self._offer, args=(t0,))
        offer.start()
        if tracer.on:
            time.sleep(max(0.0, t0 + tracer.seconds - time.perf_counter()))
            tracer.stop(dispatches=svc.n_dispatches)
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        close = time.perf_counter()
        offer.join()
        for fut in self.futures:
            if fut is None:
                continue
            try:
                fut.result(timeout=max(0.0, close + GRACE_S - time.perf_counter()))
            except Exception:  # a failed or late clip is a miss, counted below
                pass
        ok = [f is not None and f.done() and f.exception() is None and d is not None
              for f, d in zip(self.futures, self.done)]
        self.results = [f.result() if good else None for f, good in zip(self.futures, ok)]
        lat = stats.latencies_ms([t0 + d for d in self.due],
                                 [d if good else None for d, good in zip(self.done, ok)])
        served = sum(int(k) for k, good, d in zip(self.lengths, ok, self.done)
                     if good and d <= t0 + seconds)
        self.missing = n - sum(ok)
        tail = {f"p{q}_ms": stats.percentile(lat, q) for q in (90, 99, 100)}
        self.window_counts = (svc.n_dispatches - start[0], svc.n_scored - start[1])
        return {"metrics": {"serve_p95_ms": stats.percentile(lat, 95),
                            "serve_p50_ms": stats.percentile(lat, 50),
                            "serve_frames_per_s": served / seconds},
                "attempted": n, "failed": self.missing,
                "notes": {"clips": n, "frames": int(self.lengths.sum()),
                          "generator_late_ms": 1e3 * self.late_s, **tail,
                          "dispatches": self.window_counts[0]}}

    def trace_counts(self, tracer) -> dict:
        return {"dispatches": tracer.delta("dispatches"),
                "batch": int(self.mix["batch_size"]),
                "window_dispatches": self.window_counts[0],
                "window_scored": self.window_counts[1]}

    # ------------------------------------------------------------ check

    def free(self) -> None:
        self.service.stop()
        del self.service, self.model
        torch.cuda.empty_cache()

    def sample(self) -> np.ndarray:
        """The clips the reference redoes: a sample drawn from the seed,
        with the longest clip in it."""
        rng = np.random.Generator(np.random.PCG64(self.seed * 4 + inputs.SAMPLE))
        n = len(self.due)
        pick = rng.choice(n, size=min(n, int(self.mix["sample_clips"])), replace=False)
        return np.unique(np.append(pick, np.argmax(self.lengths)))

    def reference(self, clips, tf32: bool = False):
        ref = cells.reference_module(self.cfg["name"])
        block = int(self.mix["batch_size"])
        norm = torch.as_tensor(self.pool[: int(self.mix["norm_frames"])],
                               device=self.device)[:, None]
        with _common.float32_products(), torch.no_grad():
            mean, std = _common.norm_stats(
                lambda i: ref.transform(norm[i * block: (i + 1) * block], tf32),
                -(-len(norm) // block))
        frames = torch.as_tensor(np.concatenate([self.clip(i) for i in clips]),
                                 device=self.device)[:, None]
        out = _common.scores(ref.forward, ref.transform, self.weights, frames, mean, std,
                             block, tf32).cpu().numpy()
        return np.split(out, np.cumsum([self.lengths[i] for i in clips])[:-1])

    def numbers(self, clips, got, want) -> dict:
        score = clip = 0.0
        for i, g, w in zip(clips, got, want):
            if g is None or len(g[1]) != len(w):
                return {"score_gap": float("inf"), "clip_gap": float("inf"),
                        "missing": float(self.missing)}
            score = max(score, float(np.abs(g[1] - w).max()))
            clip = max(clip, abs(g[0] - float(w.mean())))
        return {"score_gap": score, "clip_gap": clip, "missing": float(self.missing)}

    def check(self, control: bool = False) -> dict:
        clips = self.sample()
        want = self.reference(clips)
        got = [self.results[i] for i in clips]
        out = {"program": self.numbers(clips, got, want)}
        if control:
            lower = self.reference(clips, tf32=True)
            out["control"] = self.numbers(clips, [(float(w.mean()), w) for w in lower], want)
        return out
