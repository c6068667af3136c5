"""Linear-frequency cepstral coefficients (LFCC) and delta features.

Counterpart of ``audiodeepfake_detection_tpu/ops/lfcc.py`` (the reference's
``LFCC`` module and its ``torchaudio.transforms.ComputeDeltas`` usage,
src/audiofakedetect/wavelet_math.py:71-164, 316-323).  The filterbank and
DCT matrices follow ``torchaudio.functional.linear_fbanks`` /
``create_dct`` and are built in numpy exactly as in the JAX package; on the
device the feature stack is two matrix products plus elementwise work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .library import tensor_cache


def linear_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_filter: int,
    sample_rate: int,
) -> np.ndarray:
    """Triangular linear filterbank, shape ``(n_freqs, n_filter)``.

    Matches ``torchaudio.functional.linear_fbanks``.
    """
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = np.linspace(f_min, f_max, n_filter + 2)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_filter + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_filter + 2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


def create_dct(n_mfcc: int, n_mels: int, norm: str | None = "ortho") -> np.ndarray:
    """DCT-II basis, shape ``(n_mels, n_mfcc)`` (torchaudio.functional.create_dct)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)  # (n_mfcc, n_mels)
    if norm is None:
        dct *= 2.0
    else:
        if norm != "ortho":
            raise ValueError(f"norm must be None or 'ortho': {norm!r}")
        dct[0] *= 1.0 / np.sqrt(2.0)
        dct *= np.sqrt(2.0 / n_mels)
    return dct.T.astype(np.float32)


@tensor_cache(maxsize=16)
def _matrices(
    num_of_scales: int, f_min: float, f_max: float, n_lin: int, n_lfcc: int,
    sample_rate: int, device: torch.device,
):
    """``(filterbank [F, n_lin], dct [n_lin, n_lfcc])`` on ``device``."""
    fb = linear_fbanks(num_of_scales, f_min, f_max, n_lin, sample_rate)
    dct = create_dct(n_lfcc, n_lin, "ortho")
    return torch.as_tensor(fb, device=device), torch.as_tensor(dct, device=device)


def amplitude_to_db(
    x: torch.Tensor, top_db: float = 80.0, amin: float = 1e-10
) -> torch.Tensor:
    """Power -> dB with per-sample top_db clamp (torchaudio AmplitudeToDB)."""
    db = 10.0 * torch.log10(torch.clamp(x, min=amin))
    peak = db.amax(dim=tuple(range(1, x.ndim)), keepdim=True)
    return torch.maximum(db, peak - top_db)


def lfcc(
    specgram: torch.Tensor,
    sample_rate: int = 22050,
    n_lin: int = 20,
    n_lfcc: int = 20,
    f_min: float = 0.0,
    f_max: float = 11025.0,
    num_of_scales: int = 150,
    log_lf: bool = True,
) -> torch.Tensor:
    """LFCC features from a spectrogram/scalogram ``[..., F, T]``.

    Mirrors the reference forward (src/audiofakedetect/wavelet_math.py:
    138-164): filterbank product, log (or dB) scaling, DCT product.  Leading
    axes are collapsed and returned as ``[B, 1, n_lfcc, T]`` exactly like
    the reference (which drops the original channel axis via
    ``unsqueeze(1)``).
    """
    f, t = specgram.shape[-2], specgram.shape[-1]
    x = specgram.reshape(-1, f, t)
    fb, dct = _matrices(
        int(num_of_scales), float(f_min), float(f_max), int(n_lin), int(n_lfcc),
        int(sample_rate), x.device,
    )
    x = torch.einsum("bft,fl->blt", x, fb.to(x.dtype))[:, None]  # [B, 1, n_lin, T]
    if log_lf:
        x = torch.log(x + 1e-12)
    else:
        x = amplitude_to_db(x)
    return torch.einsum("bclt,lk->bckt", x, dct.to(x.dtype))


def compute_deltas(x: torch.Tensor, win_length: int = 5) -> torch.Tensor:
    """Delta features over the last axis (torchaudio ComputeDeltas,
    replicate padding)."""
    n = (win_length - 1) // 2
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    t = x.shape[-1]
    xp = F.pad(x.reshape(1, -1, t), (n, n), mode="replicate").reshape(*x.shape[:-1], t + 2 * n)
    out = torch.zeros_like(x)
    for i, c in enumerate(range(-n, n + 1)):
        out = out + (c / denom) * xp[..., i : i + t]
    return out
