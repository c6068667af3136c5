"""Inputs made from ``--seed``: weights, audio, the open-loop schedule.

Weights and audio are made on the run's device by a ``torch.Generator`` in
a few large calls; each kind draws from its own stream of the seed.  The
same seed gives the same inputs.  Both sides of the correctness check get
these tensors: the program loads copies, the reference reads them.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch

#: streams of one seed
WEIGHTS, AUDIO, SCHEDULE, SAMPLE = range(4)


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed((int(seed) * 4 + stream) % (1 << 63))
    return gen


def leaf_init(name: str, shape: Tuple[int, ...]) -> Tuple[str, float, float]:
    """How a state-dict leaf is drawn: ``(kind, scale, shift)`` of a unit
    normal ``z``: ``"lin"`` is ``shift + scale * z``, ``"exp"`` is
    ``exp(scale * z)`` (a positive variance)."""
    if name.endswith("running_var"):
        return "exp", 0.2, 0.0
    if name.endswith("running_mean"):
        return "lin", 0.1, 0.0
    if name.endswith("bias"):
        return "lin", 0.05, 0.0
    numel = math.prod(shape)
    if len(shape) == 1 and numel == 1:  # a PReLU slope
        return "lin", 0.05, 0.25
    if len(shape) == 1:  # a norm's scale
        return "lin", 0.1, 1.0
    return "lin", 1.0 / math.sqrt(numel / shape[0]), 0.0  # 1 / sqrt(fan in)


def make_weights(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """A state dict for ``shapes`` (name -> (shape, dtype)): float leaves
    drawn by :func:`leaf_init` from one normal draw, integer leaves (a
    BatchNorm's step count) zero."""
    floats = [n for n, (_, dt) in shapes.items() if dt.is_floating_point]
    sizes = [math.prod(shapes[n][0]) for n in floats]
    rules = [leaf_init(n, shapes[n][0]) for n in floats]
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(torch.tensor([r[1] for r in rules], device=device), counts)
    shift = torch.repeat_interleave(torch.tensor([r[2] for r in rules], device=device), counts)
    z = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device), device=device)
    flat = z * scale + shift
    out = {}
    for name, part, rule in zip(floats, flat.split(sizes), rules):
        shape, dtype = shapes[name]
        leaf = part.reshape(shape)
        out[name] = (leaf.exp() if rule[0] == "exp" else leaf).to(dtype)
    for name, (shape, dtype) in shapes.items():
        if not dtype.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return {n: out[n] for n in shapes}


def make_audio(n: int, win: int, sample_rate: int, seed: int, device):
    """``n`` frames ``[n, 1, win]`` of speech-like audio and balanced labels
    ``[n]``: a harmonic series on a random pitch in noise; a fake frame
    adds a weak comb of high tones (as a vocoder's artefacts)."""
    gen = generator(seed, AUDIO, device)
    u = torch.rand(n, 3, generator=gen, device=device)
    t = torch.arange(win, device=device, dtype=torch.float32) / sample_rate
    f0 = 90.0 + 210.0 * u[:, :1]
    x = torch.zeros(n, win, device=device)
    for k in range(1, 6):
        x += torch.sin(2 * math.pi * k * (f0 * t + u[:, 1:2])) / k
    x *= 0.15 * (0.5 + u[:, 2:3])
    x += 0.02 * torch.randn(n, win, generator=gen, device=device)
    labels = (torch.arange(n, device=device) % 2)[torch.randperm(n, generator=gen, device=device)]
    comb = sum(torch.sin(2 * math.pi * f * t) for f in (7350.0, 8820.0, 10290.0))
    x += 0.01 * labels[:, None].float() * comb
    return x[:, None, :], labels


def lognormal_lengths(n: int, median_s: float, sigma: float, lo: int, hi: int) -> List[int]:
    """``n`` clip lengths in whole seconds: the quantiles ``(i + 0.5) / n``
    of a lognormal, clipped to ``[lo, hi]``.  A fixed set, the same for
    every seed."""
    dist = statistics.NormalDist(math.log(median_s), sigma)
    return [min(hi, max(lo, round(math.exp(dist.inv_cdf((i + 0.5) / n))))) for i in range(n)]


def open_loop_schedule(mix: dict, seed: int, seconds: float, pool_frames: int):
    """The open loop's clips over ``seconds``: ``(due [n] s, frames [n],
    start [n])``, arrays.

    Every seed gets the same set of clip lengths and of gaps between
    arrivals (the quantiles of a lognormal and of an exponential), in an
    order of its own, so it brings the same work.  The rate is
    ``rate_frames_per_s``; the first clip is due at 0 and the last before
    ``seconds``.  ``start``: where each clip's frames begin in the pool of
    ``pool_frames`` frames.
    """
    probe = lognormal_lengths(4096, mix["median_s"], mix["sigma"], mix["min_s"], mix["max_s"])
    n = max(1, round(mix["rate_frames_per_s"] * seconds / statistics.fmean(probe)))
    lengths = np.asarray(
        lognormal_lengths(n, mix["median_s"], mix["sigma"], mix["min_s"], mix["max_s"]))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    rng = np.random.Generator(np.random.PCG64(int(seed) * 4 + SCHEDULE))
    lengths = lengths[rng.permutation(n)]
    gaps = gaps[rng.permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    start = rng.integers(0, pool_frames - lengths + 1)
    return due, lengths, start


def sync(device) -> None:
    """Wait for the device (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
