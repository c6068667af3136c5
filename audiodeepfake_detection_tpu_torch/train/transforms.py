"""Transform pipeline factory: audio batch -> normalized model input image.

Counterpart of ``audiodeepfake_detection_tpu/train/transforms.py`` (the
reference's ``get_transforms``, src/audiofakedetect/wavelet_math.py:
266-452) for the wavelet-packet front-end.  A transform is a plain function
on tensors; it runs on the device its input lies on.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

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

TransformFn = Callable[[torch.Tensor], torch.Tensor]


def make_transform(args: DotDict, use_kernel: bool = True) -> TransformFn:
    """Build the time-frequency transform: ``[B, 1, T] -> [B, C, F, T']``.

    ``use_kernel=False`` runs the plain PyTorch wavelet-packet cascade on
    any device (what the CUDA kernel is timed against).  Only the
    ``packets`` transform without extra features is ported; the others
    raise ``NotImplementedError`` naming the ROADMAP slice that ports them.
    """
    features = args.features or "none"
    if args.transform == "stft":
        raise NotImplementedError(
            "the stft transform is not ported yet (ROADMAP.md queue 1, "
            "slice 3: STFT)"
        )
    if args.transform != "packets":
        raise ValueError(f"Unknown transform {args.transform!r}")
    if features != "none":
        raise NotImplementedError(
            f"features={features!r} (lfcc/delta) are not ported yet "
            "(ROADMAP.md queue 1, slice 4: LCNN)"
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
