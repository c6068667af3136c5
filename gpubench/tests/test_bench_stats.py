"""The arithmetic of the metrics: percentiles over every request, misses
counted."""

import math
import random

import numpy as np
import pytest

from gpubench import stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys_on_finite_values(q):
    values = [random.Random(q).uniform(0, 100) for _ in range(997)]
    assert stats.percentile(values, q) == pytest.approx(float(np.percentile(values, q)))


def test_percentile_counts_misses_over_all_requests():
    lat = stats.latencies_ms([0.0] * 20, [0.010] * 18 + [None, None])
    assert lat.count(math.inf) == 2
    # 2 misses of 20: the 95th percentile interpolates into a miss
    assert stats.percentile(lat, 95) == math.inf
    assert stats.percentile(lat, 50) == pytest.approx(10.0)
    assert stats.percentile(stats.latencies_ms([0.0] * 100, [0.01] * 99 + [None]), 95) \
        == pytest.approx(10.0)


def test_latency_runs_from_due_time():
    assert stats.latencies_ms([1.0, 2.0], [1.5, 2.001]) == pytest.approx([500.0, 1.0])


def test_loss_gap_over_the_largest_loss():
    assert stats.loss_gap([1.0, 10.0, 0.5], [1.0, 10.001, 0.4999]) == pytest.approx(1e-3 / 10.001)


def test_leaf_gaps():
    want = {"a": 1.0, "b": 2.0, "c": 1e-9, "d": 4.0}
    got = {"a": 1.1, "b": 2.0, "c": 5e-9, "d": 4.0}
    # c's gap is taken against the median leaf (1.5), not its own tiny norm
    assert stats.worst_leaf_gap(got, want) == pytest.approx(0.1 / 1.5)
    assert stats.moved_leaves(want) == ["a", "b", "d"]
    assert stats.worst_leaf_gap(got, want, ["b", "d"]) == 0.0
