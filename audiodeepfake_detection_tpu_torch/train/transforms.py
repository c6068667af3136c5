"""Transform pipeline factory: audio batch -> normalized model input image.

Counterpart of ``audiodeepfake_detection_tpu/train/transforms.py`` (the
reference's ``get_transforms``, src/audiofakedetect/wavelet_math.py:
266-452) for the wavelet-packet front-end.  A transform is a plain function
on tensors; it runs on the device its input lies on.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..ops.normalize import (
    normalize,
    welford_finalize,
    welford_init,
    welford_update,
)
from ..ops.wpt import packet_image
from ..utils.config import DotDict
from ..utils.naming import norm_cache_prefix

TransformFn = Callable[[torch.Tensor], torch.Tensor]


def make_transform(args: DotDict, use_kernel: bool = True) -> TransformFn:
    """Build the time-frequency transform: ``[B, 1, T] -> [B, C, F, T']``.

    ``use_kernel=False`` runs the plain PyTorch wavelet-packet cascade on
    any device (what the CUDA kernel is timed against).  Ported: the
    ``packets`` transform without extra features, for serving and for
    training.  The ``stft`` transform and the ``lfcc`` / ``delta`` features
    raise ``NotImplementedError`` naming the ROADMAP slice that ports them.
    """
    features = args.features or "none"
    if args.transform == "stft":
        raise NotImplementedError(
            "transform='stft' is not ported yet (ROADMAP.md queue 1, slice 3: "
            "STFT through torch.stft); ported: transform='packets'"
        )
    if args.transform != "packets":
        raise ValueError(f"Unknown transform {args.transform!r}")
    if features != "none":
        raise NotImplementedError(
            f"features={features!r} (lfcc/delta) are not ported yet "
            "(ROADMAP.md queue 1, slice 4: LCNN); ported: features='none'"
        )
    level = int(math.log2(args.num_of_scales))
    log_scale = bool(args.log_scale)
    loss_less = args.loss_less == "True" or args.loss_less is True

    def transform(audio: torch.Tensor) -> torch.Tensor:
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
    reference's (``utils.naming.norm_cache_prefix``).
    """
    transform = make_transform(args)
    loss_less = args.loss_less == "True" or args.loss_less is True
    num_channels = 2 if loss_less else 1

    if args.block_norm:
        # block normalisation replaces dataset mean/std (reference
        # wavelet_math.py:373-375)
        if args.calc_normalization:
            raise NotImplementedError(
                "per-node block-norm statistics (the *_mean_std_bn cache) "
                "are not ported yet (ROADMAP.md queue 1, slice 9: analysis)"
            )
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

    The stats are copied to each device once, not on every call.
    """
    on_device: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def fn(audio: torch.Tensor) -> torch.Tensor:
        image = transform(audio)
        if image.device not in on_device:
            on_device[image.device] = (
                torch.as_tensor(np.asarray(mean, np.float32), device=image.device),
                torch.as_tensor(np.asarray(std, np.float32), device=image.device),
            )
        m, s = on_device[image.device]
        return normalize(image, m, s)

    return fn
