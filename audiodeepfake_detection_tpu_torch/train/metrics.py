"""Evaluation metrics: EER and per-label accuracy aggregation.

Copy of ``audiodeepfake_detection_tpu/train/metrics.py``, except that the
ROC curve is computed here in numpy (``_roc_curve``) instead of through
scikit-learn, which the port does not need.

Parity targets (reference: src/audiofakedetect/train_classifier.py:347-574):

* ``calculate_eer`` — equal error rate as the root of
  ``1 - x - interp1d(fpr, tpr)(x)`` over the ROC curve (a widely
  used scikit-learn recipe, which the reference also follows).  NOTE: for parity the trainer feeds *argmax decisions*, not
  scores, exactly like the reference (train_classifier.py:479-481); a
  score-based EER is available via the same function by passing scores.
* ``calculate_acc_label`` / ``calculate_acc_dict`` — accuracy per label over
  per-process gathered dicts; the API mirrors the reference so its
  hand-built two-rank test vectors (reference tests/test_trainer.py) apply.

On-device, eval statistics are accumulated as dense per-label count tensors
(see ``train/steps.py``) — the dict-based functions here exist for API
parity and host-side post-processing.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple, Union

import numpy as np


def _roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """``(fpr, tpr)`` at every distinct score, highest first, starting at
    (0, 0): the curve ``sklearn.metrics.roc_curve(pos_label=1)`` draws (it
    only drops points that lie on a straight line between their
    neighbours)."""
    y_true = np.asarray(y_true) == 1
    y_score = np.asarray(y_score)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    ends = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true)[ends]
    fps = 1 + ends - tps
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    return fps / fps[-1], tps / tps[-1]


def calculate_eer(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Equal error rate for a binary classifier output."""
    from scipy.interpolate import interp1d
    from scipy.optimize import brentq

    fpr, tpr = _roc_curve(y_true, y_score)
    return float(brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0))


def safe_eer(y_true: np.ndarray, y_score: np.ndarray, what: str = "eer") -> float:
    """``calculate_eer`` that degrades to NaN instead of crashing.

    A single-class eval set (e.g. a cross-generator directory that is all
    fake) makes ``roc_curve`` degenerate and ``brentq`` raise.  The
    reference crashes there (train_classifier.py:479-481); per-label
    accuracy is still meaningful, so eval must survive.
    """
    y_true = np.asarray(y_true)
    if y_true.size == 0 or len(np.unique(y_true)) < 2:
        print(
            f"warning: {what} undefined (single-class eval set); reporting NaN"
        )
        return float("nan")
    try:
        return calculate_eer(y_true, y_score)
    except Exception as exc:
        print(f"warning: {what} computation failed ({exc}); reporting NaN")
        return float("nan")


def calculate_acc_label(
    count_dict_gathered: List[dict], ok_dict_gathered: List[dict], key: int
) -> float:
    """Accuracy for one label over gathered per-process dicts.

    Raises KeyError when the label is missing from any gathered dict and
    TypeError for non-numeric accumulations, matching the reference contract
    exercised by its unit tests.
    """
    all_keys: Set = set()
    for count_dict in count_dict_gathered:
        all_keys.update(count_dict.keys())
    all_keys = all_keys.intersection(*[set(d.keys()) for d in count_dict_gathered])
    all_keys = all_keys.intersection(*[set(d.keys()) for d in ok_dict_gathered])

    if key not in all_keys:
        raise KeyError(
            f"Key {key} does not exist in both dictionaries. "
            f"Only available keys: {sorted(all_keys)}."
        )

    num = sum(float(sum(ok_d[key])) for ok_d in ok_dict_gathered)
    den = sum(count_d[key] for count_d in count_dict_gathered)
    acc = num / den
    if not isinstance(acc, float):
        raise TypeError("Result should either be float or tensor.")
    return acc


def calculate_acc_dict(
    label_names: Union[Dict[int, str], callable],
    common_keys: Sequence,
    ok_dict_gathered: List[dict],
    count_dict_gathered: List[dict],
) -> List[Tuple[Union[str, int], float]]:
    """Per-label accuracy list like ``[("ljspeech", 0.74), ("melgan", 0.81)]``."""
    if callable(label_names):
        name = label_names
    else:
        name = lambda k: label_names.get(k, f"John Doe Generator {k}")  # noqa: E731
    return [
        (name(key), calculate_acc_label(count_dict_gathered, ok_dict_gathered, key))
        for key in common_keys
    ]


def dense_counts_to_dicts(
    ok_counts: np.ndarray, totals: np.ndarray
) -> Tuple[dict, dict]:
    """Convert dense per-label count vectors into the reference's dict form."""
    ok_dict, count_dict = {}, {}
    for label, total in enumerate(np.asarray(totals)):
        if total > 0:
            count_dict[label] = int(total)
            # calculate_acc_label only ever reduces this value with
            # ``sum(...)`` (like the reference sums its gathered bool
            # lists), so a one-element count list is equivalent without
            # materializing a corpus-sized [True]*ok + [False]*rest list.
            ok_dict[label] = [int(ok_counts[label])]
    return ok_dict, count_dict
