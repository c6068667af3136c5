"""Transform pipeline factory: audio batch -> normalized model input image.

Counterpart of ``audiodeepfake_detection_tpu/train/transforms.py`` (the
reference's ``get_transforms``, src/audiofakedetect/wavelet_math.py:
266-452): the wavelet-packet and STFT front-ends with the optional LFCC /
delta feature stack.  A transform is a plain function on tensors; it runs on
the device its input lies on.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ..ops.lfcc import compute_deltas, lfcc
from ..ops.library import tensor_cache
from ..ops.normalize import (
    normalize,
    welford_finalize,
    welford_init,
    welford_update,
)
from ..ops.stft import spectrogram
from ..ops.wpt import packet_image
from ..utils.config import DotDict
from ..utils.naming import norm_cache_prefix

TransformFn = Callable[[torch.Tensor], torch.Tensor]


def make_transform(args: DotDict, use_kernel: bool = True) -> TransformFn:
    """Build the time-frequency transform: ``[B, 1, T] -> [B, C, F, T']``.

    ``transform="stft"`` is the power spectrogram (``n_fft = 2 *
    num_of_scales - 1``), ``"packets"`` the wavelet-packet image;
    ``features`` stacks ``lfcc`` and one or two ``compute_deltas`` on top, in
    the reference's order.  The log scaling applies to the base image only
    when no features follow (the LFCC takes its own log).
    ``use_kernel=False`` runs the plain PyTorch wavelet-packet cascade on
    any device (what the CUDA kernel is timed against).
    """
    features = args.features or "none"
    log_scale = bool(features == "none" and args.log_scale)
    loss_less = args.loss_less == "True" or args.loss_less is True

    if args.transform == "stft":
        if loss_less:
            raise ValueError(
                "Sign channel not possible for stft due to complex data type."
            )
        n_fft = int(args.num_of_scales) * 2 - 1

        def base(audio: torch.Tensor) -> torch.Tensor:
            return spectrogram(
                audio,
                n_fft=n_fft,
                hop_length=int(args.hop_length),
                power=args.power,
                log_scale=log_scale,
            )

    elif args.transform == "packets":
        level = int(math.log2(args.num_of_scales))

        def base(audio: torch.Tensor) -> torch.Tensor:
            return packet_image(
                audio,
                args.wavelet,
                level=level,
                log_scale=log_scale,
                loss_less=loss_less,
                power=args.power,
                block_norm=bool(args.block_norm),
                use_kernel=use_kernel,
            )

    else:
        raise ValueError(f"Unknown transform {args.transform!r}")

    stack = [base]
    if "lfcc" in features or "delta" in features:

        def lfcc_step(x: torch.Tensor) -> torch.Tensor:
            return lfcc(
                x,
                sample_rate=args.sample_rate,
                f_min=args.f_min,
                f_max=args.f_max,
                num_of_scales=args.num_of_scales,
            )

        stack.append(lfcc_step)
    if "delta" in features:
        stack.append(compute_deltas)
    if "doubledelta" in features:
        stack.append(compute_deltas)

    def transform(audio: torch.Tensor) -> torch.Tensor:
        x = audio
        for fn in stack:
            x = fn(x)
        return x

    return transform


def compute_normalization(
    transform: TransformFn,
    batches: Iterable,
    num_channels: int,
    device: torch.device | str,
) -> Tuple[np.ndarray, np.ndarray]:
    """Welford mean/std of the transformed batches, per channel.

    ``batches`` yields host audio arrays ``[B, 1, T]``; the reduction runs
    over (batch, time, freq) keeping channels (reference
    wavelet_math.py:419-441, permute at :440).
    """
    state = welford_init(num_channels, device)
    with torch.inference_mode():
        for batch in batches:
            image = transform(torch.as_tensor(batch, device=device))
            state = welford_update(state, image.permute(0, 3, 2, 1))
        mean, std = welford_finalize(state)
    return mean.cpu().numpy(), std.cpu().numpy()


def compute_block_norm_stats(
    args: DotDict,
    batches: Iterable,
    device: torch.device | str,
) -> dict:
    """Per-packet-node Welford statistics over the training set.

    The reference collects a Welford estimator per WPT node while computing
    normalization (wavelet_math.py:194-200) and stores the finalized
    ``{node: {mean, std}}`` dict (the ``*_mean_std_bn`` cache).  The raw
    packets come from the op ``adfd::wpt_packets`` without the log (the
    CUDA kernel on a GPU); node keys are the Gray-code frequency indices.
    """
    from ..ops.wpt_cuda import wpt_packets

    level = int(math.log2(args.num_of_scales))
    state = welford_init(int(args.num_of_scales), device)
    with torch.inference_mode():
        for batch in batches:
            audio = torch.as_tensor(batch, device=device)
            if audio.ndim == 3:
                audio = audio.reshape(-1, audio.shape[-1])
            wp = wpt_packets(audio.contiguous(), args.wavelet, level, False, 2.0)
            state = welford_update(state, wp.permute(0, 2, 1))
        mean, std = welford_finalize(state)
    mean = mean.cpu().numpy()
    std = std.cpu().numpy()
    return {
        int(node): {"mean": float(mean[node]), "std": float(std[node])}
        for node in range(int(args.num_of_scales))
    }


def get_transforms(
    args: DotDict,
    train_batches: Optional[Callable[[], Iterable]] = None,
    device: torch.device | str = "cuda",
    verbose: bool = True,
) -> Tuple[TransformFn, np.ndarray, np.ndarray]:
    """Build transform + normalization stats with the reference's caching.

    Returns ``(transform, mean, std)``; pass the stats to
    :func:`normalized_transform`.  With ``calc_normalization`` the Welford
    pass over ``train_batches()`` runs on ``device`` and its result is
    cached as a pickle under ``<log_dir>/norms/``, keyed like the
    reference's (``utils.naming.norm_cache_prefix``).  With ``block_norm``
    the stats are zeros / ones, and the per-node statistics
    (:func:`compute_block_norm_stats`) are cached for analysis as
    ``*_mean_std_bn.pkl``.
    """
    transform = make_transform(args)
    loss_less = args.loss_less == "True" or args.loss_less is True
    num_channels = 2 if loss_less else 1

    if args.block_norm:
        # block normalisation replaces dataset mean/std (reference
        # wavelet_math.py:373-375); per-node Welford stats are cached for
        # analysis like the reference's *_mean_std_bn file (which it saves
        # as .pkl and loads as .pt; one path here)
        if (
            args.data_path is not None
            and args.log_dir is not None
            and train_batches is not None
        ):
            cache = norm_cache_prefix(args) + "_mean_std_bn.pkl"
            if not os.path.exists(cache) and args.calc_normalization:
                stats = compute_block_norm_stats(args, train_batches(), device)
                os.makedirs(os.path.dirname(cache), exist_ok=True)
                with open(cache, "wb") as fh:
                    pickle.dump(stats, fh)
        return (
            transform,
            np.zeros(num_channels, np.float32),
            np.ones(num_channels, np.float32),
        )

    mean = np.asarray(args.mean, dtype=np.float32)
    std = np.asarray(args.std, dtype=np.float32)
    if args.data_path is not None and args.log_dir is not None:
        cache = norm_cache_prefix(args) + "_mean_std.pkl"
        if os.path.exists(cache):
            if verbose:
                print("Loading pre calculated mean and std from file.")
            with open(cache, "rb") as fh:
                mean, std = pickle.load(fh)
            mean = np.asarray(mean, dtype=np.float32)
            std = np.asarray(std, dtype=np.float32)
        elif args.calc_normalization and train_batches is not None:
            if verbose:
                print("computing mean and std values.", flush=True)
            mean, std = compute_normalization(
                transform, train_batches(), num_channels, device
            )
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            with open(cache, "wb") as fh:
                pickle.dump([mean, std], fh)
    return transform, mean, std


def normalized_transform(
    transform: TransformFn, mean: np.ndarray, std: np.ndarray
) -> TransformFn:
    """``transform`` followed by per-channel ``(x - mean) / std``.

    The stats are copied to each device once, not on every call (nor kept
    from inside a trace: ``ops.library.tensor_cache``).
    """

    @tensor_cache(maxsize=None)
    def stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        return (
            torch.as_tensor(np.asarray(mean, np.float32), device=device),
            torch.as_tensor(np.asarray(std, np.float32), device=device),
        )

    def fn(audio: torch.Tensor) -> torch.Tensor:
        image = transform(audio)
        m, s = stats(image.device)
        return normalize(image, m, s)

    return fn
