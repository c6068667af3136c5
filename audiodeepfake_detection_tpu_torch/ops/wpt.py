"""Wavelet packet transform (WPT): the plain PyTorch version.

Counterpart of ``audiodeepfake_detection_tpu/ops/wpt.py``.  Semantics match
ptwt's ``WaveletPacket(data, wavelet, mode="reflect")`` + ``get_level``:

* per level, the signal is reflect-padded with ``padl = (2L-3)//2`` and
  ``padr = padl + (n % 2)`` and cross-correlated with the *flipped*
  decomposition filters at stride 2, so ``n' = floor((n + L - 1)/2)``;
* ``get_level`` enumerates nodes in Gray-code ("frequency") order:
  frequency index ``i`` is natural tree index ``i ^ (i >> 1)``.

Each level is one stride-2 ``F.conv1d`` with the node axis folded into the
batch.  This is the reference the CUDA kernel (``wpt_cuda.py``) is held
against, and what a CPU tensor runs.  The synthesis (inverse) transform
(:func:`wpt_synthesis`) is one stride-2 ``F.conv_transpose1d`` a level; no
kernel reaches it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .library import tensor_cache
from .wavelets import get_wavelet


def graycode_permutation(level: int) -> np.ndarray:
    """Frequency-order -> natural-order node index map for ``2**level`` nodes.

    Entry ``i`` is the natural (binary: 'a'=0, 'd'=1, first filter = MSB)
    index of the ``i``-th frequency-ordered node (ptwt
    ``WaveletPacket.get_graycode_order``).
    """
    idx = np.arange(2**level)
    return idx ^ (idx >> 1)


def wpt_output_length(n: int, filt_len: int, level: int) -> int:
    """pywt length rule applied ``level`` times: n' = floor((n + L - 1)/2)."""
    for _ in range(level):
        n = (n + filt_len - 1) // 2
    return n


def reflect_indices(n: int, padl: int, padr: int) -> np.ndarray:
    """Source index of every sample of the reflect-padded length-``n`` signal.

    Whole-point reflection, repeated while an index is out of range — so a
    pad longer than the signal (``padl >= n``, e.g. coif4 deep in the
    cascade) folds back and forth like ``numpy.pad(mode="reflect")``.
    ``F.pad(mode="reflect")`` refuses such pads, hence the gather.
    """
    t = np.arange(-padl, n + padr)
    if n == 1:
        return np.zeros_like(t)
    while ((t < 0) | (t >= n)).any():
        t = np.where(t < 0, -t, t)
        t = np.where(t >= n, 2 * (n - 1) - t, t)
    return t


@tensor_cache(maxsize=64)
def _reflect_index_tensor(n: int, padl: int, padr: int, device: str) -> torch.Tensor:
    # cached per device: the plain cascade is timed on the GPU against the
    # kernel, and a fresh host->device index copy per level would be timed
    # too (not while tracing: see library.tensor_cache)
    return torch.as_tensor(reflect_indices(n, padl, padr), device=device)


@tensor_cache(maxsize=64)
def dec_kernel(wavelet_name: str, device: str) -> torch.Tensor:
    """Stacked ``[2, 1, L]`` float32 analysis kernel (flipped dec_lo /
    dec_hi), built in float64 and cast once."""
    wavelet = get_wavelet(wavelet_name)
    dec_lo = np.asarray(wavelet.dec_lo, dtype=np.float64)[::-1]
    dec_hi = np.asarray(wavelet.dec_hi, dtype=np.float64)[::-1]
    k = np.stack([dec_lo, dec_hi])[:, None, :].astype(np.float32)
    return torch.as_tensor(k, device=device)


@tensor_cache(maxsize=16)
def _gray_index_tensor(level: int, device: str) -> torch.Tensor:
    return torch.as_tensor(graycode_permutation(level), device=device)


def dwt_level(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """One analysis level on ``[B, N, n]`` -> ``[B, 2N, n']`` (natural order)."""
    b, nodes, n = x.shape
    filt_len = kernel.shape[-1]
    padl = (2 * filt_len - 3) // 2
    padr = padl + (n % 2)
    idx = _reflect_index_tensor(n, padl, padr, str(x.device))
    y = x.reshape(b * nodes, 1, n).index_select(-1, idx)
    y = F.conv1d(y, kernel, stride=2)
    return y.reshape(b, 2 * nodes, y.shape[-1])


def wpt_analysis(
    x: torch.Tensor,
    wavelet_name: str,
    level: int,
    natural_order: bool = False,
) -> torch.Tensor:
    """Full wavelet packet decomposition ``[B, T] -> [B, 2**level, n_level]``."""
    kernel = dec_kernel(wavelet_name, str(x.device)).to(x.dtype)
    y = x[:, None, :]
    for _ in range(level):
        y = dwt_level(y, kernel)
    if not natural_order:
        y = y.index_select(1, _gray_index_tensor(level, str(x.device)))
    return y


def idwt_level(y: torch.Tensor, kernel: torch.Tensor, out_len: int) -> torch.Tensor:
    """Inverse of :func:`dwt_level`: ``[B, 2N, n'] -> [B, N, out_len]``.

    Synthesis is ``x[t] = sum_c sum_s y_c[s] * rec_c[t - 2s]``: a stride-2
    transposed convolution with the rec filters, which are the flipped dec
    filters, i.e. the analysis ``kernel`` as it is.  The result covers the
    reflect-padded analysis signal; cropping ``padl`` from the left leaves
    the original samples.
    """
    b, nodes2, n = y.shape
    nodes = nodes2 // 2
    filt_len = kernel.shape[-1]
    padl = (2 * filt_len - 3) // 2
    x = F.conv_transpose1d(y.reshape(b * nodes, 2, n), kernel, stride=2)
    return x[:, 0, padl : padl + out_len].reshape(b, nodes, out_len)


def wpt_synthesis(
    packets: torch.Tensor,
    wavelet_name: str,
    level: int,
    out_len: int,
    natural_order: bool = False,
) -> torch.Tensor:
    """Inverse WPT: ``[B, 2**level, n_level] -> [B, out_len]``."""
    kernel = dec_kernel(wavelet_name, str(packets.device)).to(packets.dtype)
    if not natural_order:
        inv = np.argsort(graycode_permutation(level))
        packets = packets.index_select(1, torch.as_tensor(inv, device=packets.device))
    filt_len = kernel.shape[-1]
    lengths = [out_len]
    for _ in range(level - 1):
        lengths.append(wpt_output_length(lengths[-1], filt_len, 1))
    y = packets
    for lev in range(level):
        y = idwt_level(y, kernel, lengths[level - 1 - lev])
    return y[:, 0, :]


def log_power(wp: torch.Tensor, power: float) -> torch.Tensor:
    """``log(|x|**power + 1e-12)``, the packet image's log scaling."""
    return torch.log(torch.abs(wp) ** power + 1e-12)


def packet_image(
    audio: torch.Tensor,
    wavelet_name: str,
    level: int = 8,
    log_scale: bool = False,
    loss_less: bool = False,
    power: float = 2.0,
    block_norm: bool = False,
    block_norm_scale: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Packet time-frequency image, matching the reference ``Packets`` module.

    Reference: src/audiofakedetect/wavelet_math.py:167-263 — WPT, optional
    per-node block normalisation, optional ``log(|x|**power + 1e-12)``
    scaling, optional sign channel ("loss_less").

    Args:
        audio: ``[B, T]`` or ``[B, 1, T]`` waveform batch.
        block_norm: divide each node by its max absolute value over the
            whole batch (the reference's runtime block normalisation,
            wavelet_math.py:202-203; depends on batch composition).
        block_norm_scale: optional precomputed per-node scale ``[2**level]``.
        use_kernel: run the cascade through the op ``adfd::wpt_packets``
            (``wpt_cuda.wpt_packets``: the CUDA kernel for a CUDA tensor,
            this module's plain version for a CPU tensor); ``False`` forces
            the plain version on any device, which is what the kernel is
            timed against.

    Returns:
        ``[B, C, 2**level, n_level]`` with C = 2 if ``loss_less`` else 1.
    """
    if audio.ndim == 3:
        audio = audio.reshape(audio.shape[0] * audio.shape[1], audio.shape[-1])
    if use_kernel:
        from .wpt_cuda import wpt_packets

        if log_scale and not (block_norm or loss_less) and block_norm_scale is None:
            # nothing needs the raw coefficients: the log runs at the
            # kernel's store
            return wpt_packets(audio, wavelet_name, level, True, float(power))[:, None]
        wp = wpt_packets(audio, wavelet_name, level, False, float(power))
    else:
        wp = wpt_analysis(audio, wavelet_name, level)
    if block_norm:
        wp = wp / torch.amax(torch.abs(wp), dim=(0, 2), keepdim=True)
    if block_norm_scale is not None:
        wp = wp / block_norm_scale[None, :, None]
    if log_scale:
        wp_log = log_power(wp, power)
        if loss_less:
            sign = torch.where(wp < 0, -1.0, 1.0).to(wp.dtype)
            return torch.stack([wp_log, sign], dim=1)
        return wp_log[:, None]
    return wp[:, None]
