"""Misclassification diff analysis between two trained models.

Counterpart of ``audiodeepfake_detection_tpu/analysis/model_diffs.py``
(reference scripts/analyze_model_diffs.py): the set difference of two
models' correct-index dumps (``true_ind_*.npy``, written by
``train.experiment.dump_true_indices``), exporting a few clips that one
model classifies correctly and the other does not.
"""

from __future__ import annotations

import os
import wave
from typing import Dict

import numpy as np

from ..data.wavio import audio_read


def load_true_indices(path: str) -> Dict[str, np.ndarray]:
    return np.load(path, allow_pickle=True).item()


def diff_indices(a: Dict, b: Dict, key: str = "unknown") -> np.ndarray:
    """Indices model A got right but model B did not."""
    return np.asarray(sorted(set(a[key].tolist()) - set(b[key].tolist())))


def export_diff_audio(
    a_path: str,
    b_path: str,
    out_dir: str,
    key: str = "unknown",
    count: int = 10,
) -> np.ndarray:
    """Export up to ``count`` differing clips as wav files; returns indices.

    Clips are stamped with their file's true sample rate and read through
    the format-dispatching ``audio_read``, so flac corpora work.
    """
    a = load_true_indices(a_path)
    b = load_true_indices(b_path)
    diff = diff_indices(a, b, key)
    # (N, 4) rows: path, frame_idx, win_size, label.  "known" indices index
    # the known test set, stored under "dataset_known"; a reference-made
    # dump has only "dataset"
    if key == "known" and "dataset_known" in a:
        dataset = a["dataset_known"]
    else:
        dataset = a["dataset"]
    os.makedirs(out_dir, exist_ok=True)
    for i, idx in enumerate(diff[:count]):
        path, frame_idx, win, label = dataset[int(idx)]
        audio, sr = audio_read(str(path), int(frame_idx) * int(win), int(win))
        out = os.path.join(out_dir, f"diff_{i}_label{label}_idx{int(idx)}.wav")
        with wave.open(out, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(int(sr))
            pcm = np.clip(audio * 32767, -32768, 32767).astype("<i2")
            w.writeframes(pcm.tobytes())
    return diff
