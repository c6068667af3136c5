"""Figure generation: spectrograms, scalograms, attribution maps.

Counterpart of ``audiodeepfake_detection_tpu/analysis/plots.py`` (reference
src/audiofakedetect/plot_util.py, scripts/freq_visual/spectrograms.py /
scalograms.py and src/audiofakedetect/integrated_gradients.py:50-310).
``compute_spectrogram`` and ``compute_scalogram`` run the port's STFT and
CWT on ``device``; the plot functions draw with matplotlib's ``Agg``
backend, imported inside each function (the GPU machine has no
matplotlib, and scoring or training never needs it).  The reference's
tikzplotlib export is replaced by an optional ``.pgf`` next to each
``.jpg``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..data.wavio import wav_read
from ..ops.cwt import cwt, scale2frequency
from ..ops.stft import spectrogram


def load_audio(path: str, start_frame: int = 0, num_frames: int = -1):
    """Load a wav clip (reference plot_util.py:129-189)."""
    return wav_read(path, start_frame, num_frames)


def compute_spectrogram(
    audio: np.ndarray, n_fft: int = 1024, hop: int = 256, power: float = 2.0,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    x = torch.as_tensor(np.asarray(audio, np.float32)[None], device=device)
    return spectrogram(x, n_fft=n_fft, hop_length=hop, power=power)[0].cpu().numpy()


def compute_scalogram(
    audio: np.ndarray,
    sample_rate: int,
    num_scales: int = 512,
    wavelet: str = "shan0.0001-0.87",
    device: torch.device | str = "cuda",
):
    """CWT scalogram (reference plot_util.py:232-262, scalograms.py:58-87)."""
    freqs = np.linspace(sample_rate / 2, 80.0, num_scales)
    fc = scale2frequency(wavelet, np.ones(1))[0]
    scales = fc * sample_rate / freqs
    coef, out_freqs = cwt(audio, scales, wavelet, sampling_period=1.0 / sample_rate,
                          device=device)
    return np.abs(coef), out_freqs


def plot_spectrogram(
    spec: np.ndarray,
    sample_rate: int,
    hop: int,
    path: str,
    log_scale: bool = True,
    cmap: str = "inferno",
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = 10 * np.log10(spec + 1e-12) if log_scale else spec
    fig, ax = plt.subplots(figsize=(6, 4))
    extent = [0, spec.shape[1] * hop / sample_rate, 0, sample_rate / 2 / 1000]
    im = ax.imshow(data, aspect="auto", origin="lower", cmap=cmap, extent=extent)
    ax.set_xlabel("time [sec]")
    ax.set_ylabel("frequency [kHz]")
    fig.colorbar(im, ax=ax)
    save_plot(fig, path)


def plot_scalogram(
    scal: np.ndarray,
    freqs: np.ndarray,
    sample_rate: int,
    path: str,
    cmap: str = "inferno",
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(
        20 * np.log10(scal + 1e-12),
        aspect="auto",
        cmap=cmap,
        extent=[0, scal.shape[-1] / sample_rate, freqs[-1] / 1000, freqs[0] / 1000],
    )
    # freqs are descending, so the extent already puts high frequencies at
    # the top — the reference scalogram has no y-inversion
    # (plot_util.py:417-426)
    ax.set_xlabel("time [sec]")
    ax.set_ylabel("frequency [kHz]")
    fig.colorbar(im, ax=ax)
    save_plot(fig, path)


def save_plot(fig, path: str) -> None:
    """Save as jpg + pgf/tex when possible (reference save_plot analogue)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path + ".jpg", dpi=200)
    try:
        fig.savefig(path + ".pgf")
    except RuntimeError:  # no TeX system for the pgf backend: the jpg stands
        pass
    import matplotlib.pyplot as plt

    plt.close(fig)


def bar_plot(data: np.ndarray, x_ticks, x_labels, path: str) -> None:
    """Frequency-attribution histogram (reference integrated_gradients.py:50-63)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 1, sharey=True, tight_layout=True)
    axs.set_xticks(x_ticks)
    axs.set_xticklabels(x_labels)
    axs.set_xlabel("frequency [kHz]")
    axs.bar(x=list(range(data.shape[0])), height=np.flipud(data), color="crimson")
    save_plot(fig, path)


def im_plot(
    data: np.ndarray,
    path: str,
    cmap,
    x_ticks,
    x_labels,
    y_ticks,
    y_labels,
    norm=None,
) -> None:
    """Attribution heatmap (reference integrated_gradients.py:66-89)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 1)
    im = axs.imshow(np.flipud(data), aspect="auto", norm=norm, cmap=cmap)
    axs.set_xlabel("time [sec]")
    axs.set_ylabel("frequency [kHz]")
    axs.set_xticks(x_ticks)
    axs.set_xticklabels(x_labels)
    axs.set_yticks(y_ticks)
    axs.set_yticklabels(y_labels)
    fig.colorbar(im, ax=axs)
    axs.invert_yaxis()
    save_plot(fig, path)


def plot_attribution_targets(
    seconds: float,
    sample_rate: int,
    num_of_scales: int,
    path: str,
    ig_0: np.ndarray,
    ig_1: np.ndarray,
    ig_01: np.ndarray,
) -> None:
    """Real/fake/both attribution triptych
    (reference integrated_gradients.py:177-266)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.linspace(0, seconds, int(seconds * sample_rate))
    n = list(range(int(num_of_scales)))
    freqs = (sample_rate / 2) * (np.asarray(n) / num_of_scales)

    x_ticks = list(range(ig_0.shape[-1]))[:: max(1, ig_0.shape[-1] // 4)]
    x_labels = np.around(np.linspace(t.min(), t.max(), ig_0.shape[-1]), 2)[
        :: max(1, ig_0.shape[-1] // 4)
    ]
    y_ticks = n[:: max(1, freqs.shape[0] // 6)]
    y_labels = np.around(freqs[:: max(1, freqs.shape[0] // 6)] / 1000, 1)

    cmap = plt.get_cmap("inferno")
    fig, axs = plt.subplots(nrows=1, ncols=3, squeeze=False, figsize=(12, 4))
    v_min, v_max = -ig_1.max(), ig_1.max()
    titles = [
        "Attribution on Real Neuron",
        "Attribution on Fake Neuron",
        "Attribution Real and Fake",
    ]
    for col, (ig, title) in enumerate(zip((ig_0, ig_1, ig_01), titles)):
        axs[0, col].set_title(title)
        im = axs[0, col].imshow(
            np.flipud(ig * 3), aspect="auto", cmap=cmap, vmin=v_min, vmax=v_max
        )
        axs[0, col].set_xlabel("time [sec]")
        axs[0, col].set_xticks(x_ticks)
        axs[0, col].set_xticklabels(x_labels)
        axs[0, col].set_yticks(y_ticks)
        axs[0, col].set_yticklabels(y_labels)
        axs[0, col].invert_yaxis()
    axs[0, 0].set_ylabel("frequency [kHz]")
    fig.colorbar(im, ax=axs)
    save_plot(fig, path + "_integrated_gradients")


def plot_attribution(
    transformations: Sequence[str],
    wavelets: Sequence[str],
    cross_sources: Sequence[str],
    plot_path: str,
    seconds: float = 1,
    sample_rate: int = 22050,
    num_of_scales: int = 256,
) -> None:
    """Batch-plot saved attribution scores
    (reference integrated_gradients.py:269-310)."""
    for transformation in transformations:
        for wavelet in wavelets:
            for cross_source in cross_sources:
                path = (
                    f"{plot_path}/{transformation}_{sample_rate}"
                    f"_{seconds}_0_fbmelgan_{wavelet}_2.0_False_"
                    f"ljspeech-{cross_source}x2500_target"
                )
                parts = {}
                for tgt in ("0", "1", "01"):
                    f = path + f"-{tgt}_integrated_gradients.npy"
                    if os.path.exists(f):
                        parts[tgt] = np.load(f)
                if len(parts) != 3:
                    continue
                plot_attribution_targets(
                    seconds,
                    sample_rate,
                    num_of_scales,
                    path,
                    parts["0"],
                    parts["1"],
                    parts["01"],
                )
