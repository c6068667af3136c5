"""Dataset normalization statistics (Welford) and per-channel normalize.

Counterpart of ``audiodeepfake_detection_tpu/ops/normalize.py``: the
reference's ``WelfordEstimator`` (src/audiofakedetect/data_loader.py:27-71)
as pure functions over a small float32 state on the batch's device, and
``torchvision.transforms.Normalize`` on NCHW images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WelfordState(NamedTuple):
    """Running statistics over all axes except the last (channel) axis."""

    count: torch.Tensor  # scalar f32
    mean: torch.Tensor  # [C]
    m2: torch.Tensor  # [C]


def welford_init(
    num_channels: int, device: torch.device | str = "cpu"
) -> WelfordState:
    zeros = torch.zeros((num_channels,), dtype=torch.float32, device=device)
    return WelfordState(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=zeros,
        m2=zeros.clone(),
    )


def welford_update(state: WelfordState, batch: torch.Tensor) -> WelfordState:
    """Batched Welford update; reduces every axis except the last.

    Same update order as the reference (delta against the pre-update mean,
    delta2 against the post-update mean; data_loader.py:41-63).
    """
    axes = tuple(range(batch.ndim - 1))
    count = state.count + float(batch[..., 0].numel())
    delta = batch - state.mean
    mean = state.mean + torch.sum(delta / count, dim=axes)
    delta2 = batch - mean
    m2 = state.m2 + torch.sum(delta * delta2, dim=axes)
    return WelfordState(count, mean, m2)


def welford_finalize(state: WelfordState):
    """Return (mean, std); std = sqrt(m2 / count) (population convention)."""
    return state.mean, torch.sqrt(state.m2 / state.count)


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Per-channel ``(x - mean) / std`` on ``[B, C, ...]`` images (channel
    axis 1, like ``torchvision.transforms.Normalize``)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device).reshape(shape)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device).reshape(shape)
    return (x - mean) / std
