"""Corpus statistics: average STFT energy, spectral centroid, YIN pitch.

Counterpart of ``audiodeepfake_detection_tpu/analysis/stats.py``
(reference scripts/freq_visual/avg_energy_stft.py): per-frequency average
STFT energy and the spectral centroid through the port's
``ops/stft.py::spectrogram`` on ``device``, and a from-scratch YIN pitch
tracker (de Cheveigne & Kawahara 2002) in numpy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.stft import spectrogram


def _spectrogram(clip: np.ndarray, n_fft: int, hop: int, power: float,
                 device: torch.device | str) -> np.ndarray:
    audio = torch.as_tensor(np.asarray(clip, np.float32)[None], device=device)
    return spectrogram(audio, n_fft=n_fft, hop_length=hop, power=power)[0].cpu().numpy()


def average_energy(
    clips: Sequence[np.ndarray], n_fft: int = 2048, hop: int = 512,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Mean power per frequency bin over all clips -> [n_fft//2 + 1]."""
    acc = np.zeros(n_fft // 2 + 1)
    frames = 0
    for clip in clips:
        spec = _spectrogram(clip, n_fft, hop, 2.0, device)
        acc += spec.sum(-1)
        frames += spec.shape[-1]
    return acc / max(frames, 1)


def corpus_stats(
    clips: Sequence[np.ndarray],
    rates: Sequence[int],
    n_fft: int = 2048,
    hop: int = 512,
    device: torch.device | str = "cuda",
) -> dict:
    """Per-clip centroid / pitch statistics aggregated over a corpus.

    As the reference's avg_energy_stft aggregation
    (scripts/freq_visual/avg_energy_stft.py:66-84): for every clip the MEAN
    of its per-frame spectral centroid and the MEAN and STD of its pitch
    track; corpus summaries are the means of those per-clip values.

    Returns a dict with ``centroids`` [N], ``pitch_means`` [N],
    ``pitch_stds`` [N] and scalar ``centroid_mean`` / ``pitch_mean`` /
    ``pitch_std_mean`` summaries.
    """
    cents, p_means, p_stds = [], [], []
    for clip, sr in zip(clips, rates):
        cent = spectral_centroid(clip, sr, n_fft=n_fft, hop=hop, device=device)
        cents.append(float(cent.mean()) if cent.size else 0.0)
        pitch = yin_pitch(clip, sr, frame_length=n_fft, hop=hop)
        p_means.append(float(pitch.mean()) if pitch.size else 0.0)
        p_stds.append(float(pitch.std()) if pitch.size else 0.0)
    centroids = np.asarray(cents)
    pitch_means = np.asarray(p_means)
    pitch_stds = np.asarray(p_stds)
    return {
        "centroids": centroids,
        "pitch_means": pitch_means,
        "pitch_stds": pitch_stds,
        "centroid_mean": float(centroids.mean()) if centroids.size else 0.0,
        "pitch_mean": float(pitch_means.mean()) if pitch_means.size else 0.0,
        "pitch_std_mean": float(pitch_stds.mean()) if pitch_stds.size else 0.0,
    }


def spectral_centroid(
    clip: np.ndarray, sample_rate: int, n_fft: int = 2048, hop: int = 512,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Per-frame spectral centroid in Hz (librosa-compatible definition)."""
    spec = _spectrogram(clip, n_fft, hop, 1.0, device)
    freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    denom = spec.sum(0)
    return (freqs[:, None] * spec).sum(0) / np.where(denom > 0, denom, 1.0)


def yin_pitch(
    clip: np.ndarray,
    sample_rate: int,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop: int = 512,
    threshold: float = 0.1,
) -> np.ndarray:
    """YIN fundamental-frequency track (Hz), one value per frame.

    Cumulative-mean-normalized difference with absolute threshold and
    parabolic interpolation — the same estimator family librosa.yin uses.
    """
    tau_min = max(1, int(sample_rate / fmax))
    tau_max = min(frame_length // 2, int(sample_rate / fmin))
    n_frames = max(0, 1 + (len(clip) - frame_length) // hop)
    pitches = np.zeros(n_frames)
    for f in range(n_frames):
        frame = clip[f * hop : f * hop + frame_length].astype(np.float64)
        # difference function d(tau) = sum_{j<W} (x[j] - x[j+tau])^2
        #                   = r1 + r2(tau) - 2 c(tau), windowed at W
        w = frame_length // 2
        c = np.correlate(frame, frame[:w], "valid")  # c[tau], tau in [0, W]
        energy = np.cumsum(frame**2)
        r1 = energy[w - 1]
        r2 = energy[w - 1 : w - 1 + len(c)] - np.concatenate(
            ([0.0], energy[: len(c) - 1])
        )
        d = np.maximum((r1 + r2 - 2 * c)[: tau_max + 1], 0.0)
        # cumulative mean normalization
        cmnd = np.ones_like(d)
        cumsum = np.cumsum(d[1:])
        cmnd[1:] = d[1:] * np.arange(1, len(d)) / np.where(cumsum > 0, cumsum, 1.0)
        # first tau under threshold, else global min — tau_max INCLUSIVE,
        # so a tone exactly at fmin resolves to its true lag
        tau = 0
        for t in range(tau_min, tau_max + 1):
            if cmnd[t] < threshold:
                while t + 1 <= tau_max and cmnd[t + 1] < cmnd[t]:
                    t += 1
                tau = t
                break
        if tau == 0:
            tau = int(np.argmin(cmnd[tau_min : tau_max + 1])) + tau_min
        # parabolic interpolation around tau
        if 1 <= tau < len(cmnd) - 1:
            a, b, c = cmnd[tau - 1], cmnd[tau], cmnd[tau + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            tau = tau + float(np.clip(shift, -0.5, 0.5))
        pitches[f] = sample_rate / tau
    return pitches
