"""Host-side resampling (numpy).

Copy of ``resample_kernel`` / ``resample`` from
``audiodeepfake_detection_tpu/ops/audio.py``: windowed-sinc polyphase
resampling matching ``torchaudio.functional.resample`` (sinc_interp_hann,
lowpass_filter_width=6, rolloff=0.99).  The training augmentations
(``contrast``, ``add_noise``, ``augment``) wait for the training slice.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=32)
def resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> tuple[np.ndarray, int]:
    """Polyphase sinc kernel, matching torchaudio sinc_interp_hann.

    Returns (kernels [new_freq_r, width*2 + orig_freq_r], width) with the
    frequencies reduced by their gcd.
    """
    gcd = math.gcd(orig_freq, new_freq)
    orig_freq_r, new_freq_r = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig_freq_r, new_freq_r) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq_r / base_freq)
    idx = np.arange(-width, width + orig_freq_r, dtype=np.float64)[None] / orig_freq_r
    t = np.arange(0, -new_freq_r, -1, dtype=np.float64)[:, None] / new_freq_r + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t *= np.pi
    scale = base_freq / orig_freq_r
    kernels = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * scale
    return kernels.astype(np.float32), width


def resample(waveform: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Host-side polyphase resample of ``[..., T]`` (numpy, float32).

    Matches ``torchaudio.functional.resample`` defaults.  The data pipeline
    only ever downsamples (the reference raises on upsampling attempts,
    data_loader.py:346-349), but this implementation handles both.
    """
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(orig_freq, new_freq)
    orig_freq_r, new_freq_r = orig_freq // gcd, new_freq // gcd
    kernels, width = resample_kernel(orig_freq, new_freq)
    shape = waveform.shape
    x = waveform.reshape(-1, shape[-1]).astype(np.float32)
    length = x.shape[-1]
    x = np.pad(x, ((0, 0), (width, width + orig_freq_r)))
    # strided polyphase: output[p, f] = sum_k x[f*orig + k] * kernels[p, k]
    num_frames = (x.shape[-1] - kernels.shape[-1]) // orig_freq_r + 1
    idx = (
        np.arange(num_frames)[:, None] * orig_freq_r
        + np.arange(kernels.shape[-1])[None, :]
    )
    frames = x[:, idx]  # [B, F, K]
    out = np.einsum("bfk,pk->bpf", frames, kernels)  # [B, P, F]
    out = out.transpose(0, 2, 1).reshape(x.shape[0], -1)
    target_length = math.ceil(new_freq_r * length / orig_freq_r)
    out = out[:, :target_length]
    return out.reshape(*shape[:-1], target_length)
