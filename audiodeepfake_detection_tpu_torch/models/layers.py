"""BatchNorm from supplied moments.

Counterpart of ``_torch_bn_stats(..., stats=(sum, sumsq))`` in
``audiodeepfake_detection_tpu/models/layers.py``: the fused first block
returns the per-channel ``(sum, sumsq)`` of its output, and the BatchNorm
that follows normalises with them instead of reading the activation again.
Everything else the JAX module holds (``folded_bn_conv``, ``Conv2d``,
``PReLU``, ...) is ``torch.nn`` here.
"""

from __future__ import annotations

import torch
from torch import nn


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
    if bn.track_running_stats:
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1 - m).add_(var * (n / max(n - 1.0, 1.0)), alpha=m)
            bn.num_batches_tracked += 1
    scale = torch.rsqrt(var + bn.eps)
    shift = -mean * scale
    if bn.affine:
        scale = scale * bn.weight
        shift = shift * bn.weight + bn.bias
    shape = (1, -1, 1, 1)
    # one pass over x: x * scale + shift
    y = torch.addcmul(shift.reshape(shape), x.float(), scale.reshape(shape))
    return y.to(x.dtype)
