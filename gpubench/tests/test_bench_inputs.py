"""Inputs repeat from a seed; every seed of a mix brings the same work."""

import numpy as np
import pytest
import torch

from gpubench import cells, inputs

MIX = cells.mix("clips-4s-dcnn")


def test_schedule_repeats_from_a_seed():
    a = inputs.open_loop_schedule(MIX, 2**31 + 5, 10.0, 2048)
    b = inputs.open_loop_schedule(MIX, 2**31 + 5, 10.0, 2048)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3_000_000_001])
def test_every_seed_the_same_work_in_its_own_order(seed):
    ref_due, ref_len, _ = inputs.open_loop_schedule(MIX, 1, 10.0, 2048)
    due, lengths, start = inputs.open_loop_schedule(MIX, seed, 10.0, 2048)
    np.testing.assert_array_equal(np.sort(lengths), np.sort(ref_len))
    # the gaps sum to the window: the last is what the last due time leaves
    gaps = np.sort(np.append(np.diff(due), 10.0 - due[-1]))
    np.testing.assert_allclose(gaps, np.sort(np.append(np.diff(ref_due), 10.0 - ref_due[-1])),
                               rtol=1e-9, atol=1e-12)
    assert due[0] == 0.0 and np.all(np.diff(due) > 0) and due[-1] < 10.0
    assert lengths.min() >= MIX["min_s"] and lengths.max() <= MIX["max_s"]
    assert np.all(start >= 0) and np.all(start + lengths <= 2048)
    assert abs(lengths.sum() / 10.0 - MIX["rate_frames_per_s"]) < 0.01 * MIX["rate_frames_per_s"]
    if seed != 1:
        assert not np.array_equal(lengths, ref_len)


def test_lognormal_lengths_median():
    lengths = inputs.lognormal_lengths(1001, 4.0, 0.6, 1, 30)
    assert sorted(lengths)[500] == 4 and lengths == sorted(lengths)


def test_audio_and_weights_repeat_from_a_seed():
    a, la = inputs.make_audio(8, 2205, 22050, 99, "cpu")
    b, lb = inputs.make_audio(8, 2205, 22050, 99, "cpu")
    c, _ = inputs.make_audio(8, 2205, 22050, 98, "cpu")
    assert torch.equal(a, b) and torch.equal(la, lb) and not torch.equal(a, c)
    assert a.shape == (8, 1, 2205) and int(la.sum()) == 4
    shapes = {"conv.weight": ((4, 2, 3, 3), torch.float32), "conv.bias": ((4,), torch.float32),
              "bn.running_var": ((4,), torch.float32), "act.weight": ((1,), torch.float32),
              "bn.num_batches_tracked": ((), torch.int64)}
    w1 = inputs.make_weights(shapes, 5, "cpu")
    w2 = inputs.make_weights(shapes, 5, "cpu")
    assert list(w1) == list(shapes)
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert bool((w1["bn.running_var"] > 0).all()) and int(w1["bn.num_batches_tracked"]) == 0
    assert abs(float(w1["act.weight"]) - 0.25) < 0.3
    assert abs(float(w1["conv.weight"].std()) - 1 / 18 ** 0.5) < 0.15
