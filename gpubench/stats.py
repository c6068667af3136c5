"""Arithmetic of the metrics and of the correctness check, in plain Python."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q``-th percentile of every value, interpolated between the two
    nearest ranks (numpy's default rule).  A miss is ``math.inf``: a
    percentile that reaches one is infinite."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    frac = pos - lo
    if frac == 0.0 or xs[lo] == xs[hi]:
        return xs[lo]
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def latencies_ms(due: Sequence[float], done: Sequence[float]) -> List[float]:
    """Each request's latency in ms from the time it was due; a request
    with no ``done`` time (failed, or unanswered) is a miss (``inf``)."""
    return [math.inf if d is None else 1e3 * (d - t) for t, d in zip(due, done)]


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    """The widest gap between two runs' losses step by step, over the
    reference's largest loss of those steps (a loss that dips after a
    large step would make a gap over itself swing from seed to seed)."""
    return max(abs(g - w) for g, w in zip(got, want)) / max(abs(w) for w in want)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap between two norms (the program's and the
    reference's, not the norm of their difference), over the reference's
    norm of that leaf or of the median leaf, whichever is larger.
    ``keep``: the leaves that count (default: all of ``want``)."""
    names = list(want) if keep is None else list(keep)
    median = statistics.median(want.values())
    return {n: abs(got[n] - want[n]) / max(want[n], median) for n in names}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    return max(leaf_gaps(got, want, keep).values())


def moved_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Leaves whose gradient is not nought to rounding: a norm of at least
    ``share`` of the median leaf's (a bias ahead of a BatchNorm moves under
    Adam by round-off alone)."""
    median = statistics.median(grad_norms.values())
    return [n for n, v in grad_norms.items() if v >= share * median]
