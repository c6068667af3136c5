"""STFT spectrogram front-end.

Counterpart of ``audiodeepfake_detection_tpu/ops/stft.py`` (the reference's
``torchaudio.transforms.Spectrogram``, src/audiofakedetect/wavelet_math.py:
25-68): ``center=True`` reflect padding, periodic Hann window, onesided
transform, magnitude raised to ``power``.  The default geometry
``n_fft=511, hop=220`` maps 1 s at 22050 Hz to a ``(256, 101)`` image.

The JAX package computes the windowed DFT as one matrix product because its
device has no FFT unit; here ``torch.stft`` runs the FFT library of the
device the audio lies on (cuFFT on a GPU), so there is no ``method`` knob.
"""

from __future__ import annotations

import numpy as np
import torch

from .library import tensor_cache


@tensor_cache(maxsize=16)
def _window(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    k = np.arange(n)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)  # float64, rounded once
    return torch.as_tensor(w, dtype=dtype, device=device)


def hann_window(
    n: int, dtype: torch.dtype = torch.float32, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(periodic=True)``), built in
    float64 and rounded once; one copy is kept per size, type and device."""
    return _window(int(n), dtype, torch.device(device))


def spectrogram(
    audio: torch.Tensor,
    n_fft: int = 511,
    hop_length: int = 220,
    power: float = 2.0,
    center: bool = True,
    log_scale: bool = False,
) -> torch.Tensor:
    """``|stft|**power`` like ``torchaudio.transforms.Spectrogram``.

    Args:
        audio: ``[..., T]`` waveform.
        power: exponent on the magnitude (2.0 = power spectrogram).
        log_scale: apply ``log(x + 1e-12)`` (reference STFTLayer.log_scale).

    Returns:
        ``[..., n_fft//2 + 1, n_frames]`` spectrogram, time last.
    """
    lead = audio.shape[:-1]
    spec = torch.stft(
        audio.reshape(-1, audio.shape[-1]),
        n_fft=n_fft,
        hop_length=hop_length,
        win_length=n_fft,
        window=hann_window(n_fft, audio.dtype, audio.device),
        center=center,
        pad_mode="reflect",
        normalized=False,
        onesided=True,
        return_complex=True,
    )  # [N, n_bins, n_frames]
    # re^2 + im^2, not abs()**2: no square root to undo for the power image
    sq = spec.real.square() + spec.imag.square()
    if power == 2.0:
        mag = sq
    elif power == 1.0:
        mag = sq.sqrt()
    else:
        mag = sq ** (power / 2.0)
    out = mag.reshape(*lead, *mag.shape[-2:])
    if log_scale:
        out = torch.log(out + 1e-12)
    return out
