"""Layers that ``torch.nn`` does not hold.

Counterparts in ``audiodeepfake_detection_tpu/models/layers.py``:

* :func:`batch_norm_from_moments` -- ``_torch_bn_stats(..., stats=(sum,
  sumsq))``: the DCNN's fused first block returns the per-channel ``(sum,
  sumsq)`` of its output, and the BatchNorm that follows normalises with
  them instead of reading the activation again;
* :func:`batch_norm_scale_shift` -- ``BatchNormStats``: the per-channel
  ``(s, t)`` of ``BN(x) = x * s + t``, for the DCNN's fused second block,
  whose kernel takes the BatchNorm folded into its weights (``weight * s``)
  and an additive map (the convolution of the constant ``t``);
* :class:`MaxFeatureMap2D` -- ``max_feature_map_2d``, the LCNN's maxout
  over channel halves (reference src/audiofakedetect/models.py:161-209);
* :class:`BLSTMLayer` -- the bidirectional LSTM that keeps the sequence
  length (reference models.py:212-237).

Everything else the JAX module holds (``Conv2d``, ``PReLU``, ...) is
``torch.nn`` here; its ``folded_bn_conv`` is a schedule of BatchNorm -> conv
for XLA and is ``nn.BatchNorm2d`` -> ``nn.Conv2d`` here.
"""

from __future__ import annotations

import torch
from torch import nn


def _affine_scale_shift(bn: nn.BatchNorm2d, mean, var):
    """``(scale, shift)`` with ``bn(x) = x * scale + shift`` for the given
    float32 per-channel ``mean`` and ``var``."""
    scale = torch.rsqrt(var + bn.eps)
    shift = -mean * scale
    if bn.affine:
        scale = scale * bn.weight
        shift = shift * bn.weight + bn.bias
    return scale, shift


def _train_scale_shift(bn: nn.BatchNorm2d, n: int, mean, var):
    """``(scale, shift)`` of train-mode ``bn`` from the batch's float32
    ``mean`` and biased ``var`` over ``n`` values per channel, moving
    ``bn``'s running buffers as torch does."""
    if bn.track_running_stats:
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1 - m).add_(var * (n / max(n - 1.0, 1.0)), alpha=m)
            bn.num_batches_tracked += 1
    return _affine_scale_shift(bn, mean, var)


def batch_norm_from_moments(
    bn: nn.BatchNorm2d, x: torch.Tensor, s: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """Train-mode ``bn(x)`` on ``x [B, C, H, W]`` from ``s = sum(x)`` and
    ``q = sum(x**2)`` over ``(B, H, W)``, float32 ``[C]``.

    torch semantics: ``mean = s/n``, ``var = max(q/n - mean**2, 0)``
    (biased) normalises; ``running_var`` takes the unbiased ``var*n/(n-1)``;
    ``running_mean``/``running_var`` move by ``bn.momentum`` and
    ``num_batches_tracked`` grows by one -- ``bn``'s own buffers, updated in
    place, so the state dict keeps its layout.  All statistics are float32;
    the result is differentiable through ``x``, ``s`` and ``q``.
    """
    n = x.numel() // x.shape[1]
    mean = s.float() / n
    var = torch.clamp(q.float() / n - mean * mean, min=0.0)
    scale, shift = _train_scale_shift(bn, n, mean, var)
    shape = (1, -1, 1, 1)
    # one pass over x: x * scale + shift
    y = torch.addcmul(shift.reshape(shape), x.float(), scale.reshape(shape))
    return y.to(x.dtype)


def batch_norm_scale_shift(bn: nn.BatchNorm2d, x: torch.Tensor):
    """Float32 per-channel ``(s, t)`` with ``bn(x) = x * s + t``, without
    normalising ``x``.

    In training ``s`` and ``t`` come from the batch moments of ``x [B, C, H,
    W]`` (differentiable through ``x``) and ``bn``'s running buffers and
    ``num_batches_tracked`` move exactly as in
    :func:`batch_norm_from_moments`; in eval they come from the running
    buffers.
    """
    if bn.training:
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        return _train_scale_shift(bn, x.numel() // x.shape[1], mean, var)
    return _affine_scale_shift(bn, bn.running_mean, bn.running_var)


class MaxFeatureMap2D(nn.Module):
    """Maxout over the two channel halves of ``[B, C, H, W]``: channel ``j``
    against channel ``j + C/2``, giving ``C/2`` channels."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        if c % 2:
            raise ValueError(f"MaxFeatureMap2D needs an even channel count, got {c}")
        return torch.maximum(x[:, : c // 2], x[:, c // 2 :])


class BLSTMLayer(nn.Module):
    """Bidirectional LSTM on ``[B, T, input_dim]`` keeping the sequence
    length; ``output_dim`` is both directions' hidden sizes together.

    The member is named ``l_blstm`` as in the reference, so state-dict keys
    read ``...l_blstm.weight_ih_l0`` and so on.  Gates are ordered ``i, f,
    g, o`` and both biases are added, as in the JAX package's scan.
    """

    def __init__(self, input_dim: int, output_dim: int) -> None:
        super().__init__()
        if output_dim % 2:
            raise ValueError(
                f"BLSTMLayer: output_dim {output_dim} must be even (two directions)"
            )
        self.l_blstm = nn.LSTM(
            input_dim, output_dim // 2, bidirectional=True, batch_first=True
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l_blstm(x)[0]
