"""GAN "fingerprint" extraction: mean WPT / rFFT spectra per generator.

Counterpart of ``audiodeepfake_detection_tpu/analysis/fingerprints.py``
(reference scripts/freq_visual/fingerprints.py): per-generator mean
absolute level-14 Haar wavelet-packet spectra over whole clips (:105-126)
and mean absolute rFFT spectra with an audible reconstruction of the
fingerprint (:38-86), plus differences against the real corpus.

The level-14 packets of a whole clip go through the op
``adfd::wpt_packets`` (``ops/wpt_cuda.py``): on a CUDA device the CUDA
kernel, whose plan sends the top levels through device memory
(``wpt_level_kernel``) when a subtree does not fit one CTA; on the CPU the
plain cascade.  The JAX function runs its plain ``wpt_analysis`` even on a
TPU; it is the same function.

With a ``mesh`` (``parallel/mesh.py``) a clip cropped to a multiple of
``ranks * 2**level`` and at least ``sp_wpt_min_len`` long takes the
sequence-parallel cascade (``parallel/sequence.py``: its time axis sharded
over the ranks, a stride-2 ``conv1d`` a level); a shorter clip takes the
dense op, kernel 1 on the card.  That routing is the JAX function's own
(JAX ``fingerprints.py:50-75``), not a fallback: the sharded cascade needs
an aligned clip whose blocks outlast the filter, and the two transforms are
equal to float32 roundoff.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..data.wavio import audio_read
from ..ops.wpt import wpt_analysis


def mean_wpt_spectrum(
    clips: Sequence[np.ndarray],
    wavelet: str = "haar",
    level: int = 14,
    device: torch.device | str = "cuda",
    use_kernel: bool = True,
    mesh=None,
) -> np.ndarray:
    """Mean |WPT| spectrum over clips: mean over time and clips -> [2**level].

    Each clip is cropped to a multiple of ``2**level`` samples; a shorter
    clip is skipped.  The per-clip spectra are summed on ``device`` and
    fetched once.  ``use_kernel=False`` runs the plain cascade on any
    device (what the kernel is held against).  ``mesh``: each clip long
    enough for it goes through the sequence-parallel cascade over the
    ranks, cropped to a multiple of ``ranks * 2**level`` (every rank passes
    the same clips and gets the same spectrum).
    """
    from ..ops.wpt_cuda import wpt_packets
    from ..parallel.mesh import mesh_size
    from ..parallel.sequence import sp_wpt_analysis, sp_wpt_min_len

    shards = mesh_size(mesh)
    min_sp_len = sp_wpt_min_len(wavelet, level, shards) if mesh is not None else 0
    acc = None
    count = 0
    for clip in clips:
        block = shards << level
        t_sp = (len(clip) // block) * block
        if mesh is not None and t_sp >= min_sp_len:
            x = torch.as_tensor(np.asarray(clip[None, :t_sp], np.float32), device=device)
            wp = sp_wpt_analysis(x, wavelet, level, mesh)
            spec = wp[0].abs().mean(-1)
            acc = spec if acc is None else acc + spec
            count += 1
            continue
        t = (len(clip) >> level) << level
        if t == 0:
            continue
        x = torch.as_tensor(np.asarray(clip[None, :t], np.float32), device=device)
        if use_kernel:
            wp = wpt_packets(x, wavelet, level, False, 2.0)
        else:
            wp = wpt_analysis(x, wavelet, level)
        spec = wp[0].abs().mean(-1)
        acc = spec if acc is None else acc + spec
        count += 1
    if acc is None:
        raise ValueError(f"no clip holds the {2**level} samples level {level} needs")
    return acc.cpu().numpy() / count


def mean_rfft_spectrum(clips: Sequence[np.ndarray], n: int = 2**14) -> np.ndarray:
    """Mean |rFFT| over fixed-length windows of the clips -> [n//2 + 1]."""
    acc = np.zeros(n // 2 + 1)
    count = 0
    for clip in clips:
        for start in range(0, len(clip) - n + 1, n):
            acc += np.abs(np.fft.rfft(clip[start : start + n]))
            count += 1
    if count == 0:
        raise ValueError(f"no clip holds a window of {n} samples")
    return acc / count


def fingerprint_audio(spectrum: np.ndarray, n: int = 2**14) -> np.ndarray:
    """Reconstruct an audible waveform from an rFFT fingerprint
    (reference fingerprints.py:70-86 renders the fingerprint to wav)."""
    return np.fft.irfft(spectrum, n=n).astype(np.float32)


def load_clips(
    directory: str, max_files: int = 128, file_type: str = "wav"
) -> List[np.ndarray]:
    files = sorted(
        f for f in os.listdir(directory) if f.endswith("." + file_type)
    )[:max_files]
    return [audio_read(os.path.join(directory, f))[0] for f in files]


def generator_fingerprints(
    data_path: str,
    generators: Sequence[str],
    real_name: str = "real",
    wavelet: str = "haar",
    level: int = 14,
    max_files: int = 128,
    device: torch.device | str = "cuda",
    use_kernel: bool = True,
    mesh=None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-generator mean spectra and differences against the real corpus.

    ``data_path`` holds one directory per source, named ``<prefix>_<name>``;
    ``mesh`` shards each clip's time axis (:func:`mean_wpt_spectrum`).
    """
    dirs = {d.split("_")[-1]: d for d in os.listdir(data_path)}

    def spectra(name):
        clips = load_clips(os.path.join(data_path, dirs[name]), max_files)
        wpt = mean_wpt_spectrum(clips, wavelet, level, device=device,
                                use_kernel=use_kernel, mesh=mesh)
        return wpt, mean_rfft_spectrum(clips)

    real_wpt, real_fft = spectra(real_name)
    out: Dict[str, Dict[str, np.ndarray]] = {
        real_name: {"wpt": real_wpt, "rfft": real_fft}}
    for gen in generators:
        if gen == real_name:
            continue
        wpt, fft = spectra(gen)
        out[gen] = {
            "wpt": wpt,
            "rfft": fft,
            "wpt_diff": wpt - real_wpt,
            "rfft_diff": fft - real_fft,
        }
    return out
