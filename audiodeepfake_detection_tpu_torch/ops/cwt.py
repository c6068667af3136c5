"""Continuous wavelet transform (pywt/ptwt-compatible semantics).

Counterpart of ``audiodeepfake_detection_tpu/ops/cwt.py``, used by the
analysis layer for scalogram figures (reference:
src/audiofakedetect/plot_util.py:232-262 calls ``ptwt.cwt`` with a complex
Shannon wavelet ``shan{bandwidth}-{center_freq}``).

Algorithm follows pywt's ``cwt``: the mother wavelet's antiderivative is
sampled per scale, convolved with the signal, differentiated and scaled by
``-sqrt(scale)``.  :func:`cwt` shares ONE signal FFT across all scales and
runs the per-scale kernel FFTs and spectral products as one batched
``torch.fft`` round trip at the largest padded size, in complex64 on the
given device (cuFFT on a GPU): three FFT calls whatever the number of
scales.  :func:`cwt_reference` keeps the per-scale numpy float64 evaluation
as the oracle for the batched path.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np
import torch


def shannon_wavelet(bandwidth: float, center_freq: float, precision: int = 10):
    """Complex Shannon wavelet psi on pywt's default [-8, 8] grid."""
    n = 2**precision
    x = np.linspace(-8.0, 8.0, n)
    psi = (
        np.sqrt(bandwidth)
        * np.sinc(bandwidth * x)
        * np.exp(2j * np.pi * center_freq * x)
    )
    return psi, x


def _parse_wavelet(name: str) -> Tuple[float, float]:
    m = re.match(r"^shan([0-9.]+)-([0-9.]+)$", name)
    if not m:
        raise ValueError(
            f"Unsupported CWT wavelet {name!r}; expected 'shan<bw>-<fc>'."
        )
    return float(m.group(1)), float(m.group(2))


def scale2frequency(wavelet: str, scales: np.ndarray) -> np.ndarray:
    """Center frequency of the scaled wavelet in cycles per sample."""
    _, fc = _parse_wavelet(wavelet)
    return fc / np.asarray(scales, dtype=np.float64)


def _scale_kernels(
    scales: np.ndarray, wavelet: str, precision: int
) -> List[np.ndarray]:
    """Per-scale integrated-wavelet FIR kernels (pywt's ``int_psi[j][::-1]``)."""
    bandwidth, center = _parse_wavelet(wavelet)
    psi, x = shannon_wavelet(bandwidth, center, precision)
    int_psi = np.cumsum(psi) * (x[1] - x[0])
    kernels = []
    for scale in scales:
        j = np.arange(scale * (x[-1] - x[0]) + 1) / (scale * (x[1] - x[0]))
        j = j.astype(np.int64)
        j = j[j < int_psi.size]
        kernels.append(int_psi[j][::-1])
    return kernels


def _finalize(conv: np.ndarray, scale: float, k: int, t: int) -> np.ndarray:
    """diff + ``-sqrt(scale)`` scaling + pywt's centered crop to ``t``."""
    coef = -np.sqrt(scale) * np.diff(conv[..., : t + k - 1], axis=-1)
    d = (coef.shape[-1] - t) / 2.0
    start = int(np.floor(d))
    return coef[..., start : start + t] if d > 0 else coef


def cwt(
    data: np.ndarray,
    scales: np.ndarray,
    wavelet: str,
    sampling_period: float = 1.0,
    precision: int = 10,
    device: torch.device | str = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """pywt-style CWT, batched over scales on ``device``.

    One signal FFT (shared by every scale), one batched kernel FFT, one
    batched inverse FFT, all at the largest padded length, in complex64.
    The diff / crop tail per scale runs in numpy on the fetched result
    (kernel lengths differ per scale).

    Args:
        data: ``[..., T]`` real signal.
        scales: 1-D array of dilation scales.
        wavelet: ``"shan<bw>-<fc>"`` complex Shannon spec.
        device: where the FFTs run (``"cpu"`` must be asked for).

    Returns:
        (coefficients ``[num_scales, ..., T]`` complex, frequencies in Hz).
    """
    scales = np.asarray(scales, dtype=np.float64)
    data = np.asarray(data)
    t = data.shape[-1]
    flat = data.reshape(-1, t)

    kernels = _scale_kernels(scales, wavelet, precision)
    k_max = max(k.size for k in kernels)
    n_fft = int(2 ** np.ceil(np.log2(t + k_max - 1)))
    ker = np.zeros((len(scales), n_fft), np.complex64)
    for i, kk in enumerate(kernels):
        ker[i, : kk.size] = kk

    device = torch.device(device)
    sig = torch.as_tensor(flat.astype(np.complex64), device=device)
    sig_f = torch.fft.fft(sig, n_fft, dim=-1)
    ker_f = torch.fft.fft(torch.as_tensor(ker, device=device), dim=-1)
    conv = torch.fft.ifft(ker_f[:, None, :] * sig_f[None, :, :], dim=-1)
    conv = conv.cpu().numpy()  # [S, B, n_fft]

    coefs = [
        _finalize(conv[i], scale, kernels[i].size, t)
        for i, scale in enumerate(scales)
    ]
    out = np.stack(coefs).reshape((len(scales),) + data.shape)
    freqs = scale2frequency(wavelet, scales) / sampling_period
    return out, freqs


def cwt_reference(
    data: np.ndarray,
    scales: np.ndarray,
    wavelet: str,
    sampling_period: float = 1.0,
    precision: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-scale float64 numpy evaluation (pywt's own loop structure).

    Kept as the cross-test oracle for :func:`cwt`; same semantics, minimal
    padded length per scale, no shared FFTs.
    """
    scales = np.asarray(scales, dtype=np.float64)
    data = np.asarray(data)
    t = data.shape[-1]
    flat = data.reshape(-1, t).astype(np.float64)

    kernels = _scale_kernels(scales, wavelet, precision)
    coefs = []
    for scale, kernel in zip(scales, kernels):
        k = kernel.size
        n_fft = int(2 ** np.ceil(np.log2(t + k - 1)))
        sig_f = np.fft.fft(flat, n_fft, axis=-1)
        ker_f = np.fft.fft(kernel, n_fft)
        conv = np.fft.ifft(sig_f * ker_f, axis=-1)
        coefs.append(_finalize(conv, scale, k, t))
    out = np.stack(coefs).reshape((len(scales),) + data.shape)
    freqs = scale2frequency(wavelet, scales) / sampling_period
    return out, freqs
