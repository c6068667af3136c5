"""Waveform utilities: training augmentations and host-side resampling.

Counterpart of ``audiodeepfake_detection_tpu/ops/audio.py``:

* ``contrast``   -- sox contrast enhancement waveshaper
  (``torchaudio.functional.contrast``; reference utils.py:398-401).
* ``add_noise``  -- noise mixed in at a given SNR
  (``torchaudio.functional.add_noise``; reference utils.py:404-409).
* ``augment``    -- the reference's random draws around both, from an
  explicit ``torch.Generator`` on the waveform's device.
* ``resample_kernel`` / ``resample`` -- numpy copy of the windowed-sinc
  polyphase resampling matching ``torchaudio.functional.resample``
  (sinc_interp_hann, lowpass_filter_width=6, rolloff=0.99).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def contrast(waveform: torch.Tensor, enhancement_amount) -> torch.Tensor:
    """Sox contrast effect; enhancement_amount in [0, 100]."""
    scale = enhancement_amount / 750.0
    temp1 = waveform * (math.pi / 2.0)
    temp2 = scale * torch.sin(temp1 * 4.0)
    return torch.sin(temp1 + temp2)


def add_noise(
    waveform: torch.Tensor, noise: torch.Tensor, snr_db: torch.Tensor
) -> torch.Tensor:
    """Mix ``noise`` into ``waveform`` at ``snr_db`` (per leading-batch entry)."""
    energy_signal = torch.sum(waveform**2, dim=-1)
    energy_noise = torch.sum(noise**2, dim=-1)
    original_snr_db = 10.0 * (torch.log10(energy_signal) - torch.log10(energy_noise))
    scale = 10.0 ** ((original_snr_db - snr_db) / 20.0)
    return waveform + scale[..., None] * noise


def augment(
    generator: torch.Generator,
    waveform: torch.Tensor,
    use_contrast: bool = False,
    use_noise: bool = False,
) -> torch.Tensor:
    """The reference's training augmentations, drawn from ``generator``
    (which must live on ``waveform``'s device; no value reaches the host).

    contrast: enhancement ~ U(5, 20); noise: white, SNR ~ U(30, 40) dB
    (reference utils.py:398-409, applied to the raw waveform before the
    transform at train_classifier.py:959-962).
    """

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = torch.rand((), generator=generator, device=waveform.device)
        return lo + (hi - lo) * u

    if use_contrast:
        waveform = contrast(waveform, uniform(5.0, 20.0))
    if use_noise:
        noise = torch.randn(
            waveform.shape, generator=generator,
            device=waveform.device, dtype=waveform.dtype,
        )
        snr = uniform(30.0, 40.0).expand(waveform.shape[:-1])
        waveform = add_noise(waveform, noise, snr)
    return waveform


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
