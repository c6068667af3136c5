"""Layers that ``torch.nn`` does not hold.

Counterparts in ``audiodeepfake_detection_tpu/models/layers.py``:

* :func:`batch_norm_from_moments` -- ``_torch_bn_stats(..., stats=(sum,
  sumsq))``: the DCNN's fused first block returns the per-channel ``(sum,
  sumsq)`` of its output, and the BatchNorm that follows normalises with
  them instead of reading the activation again;
* :class:`SyncBatchNorm2d` -- under a mesh the JAX BatchNorm normalises
  with the moments of the global batch, since its reductions run over the
  sharded batch axis ("== SyncBatchNorm", JAX ``models/layers.py:12``).
  Here each rank holds its own batch, so :func:`use_mesh` turns a model's
  ``nn.BatchNorm2d`` into this subclass: the one-pass float32 ``(sum,
  sumsq)`` (:func:`one_pass_moments`, what JAX's ``_torch_bn_stats`` takes)
  summed over the ranks by ``parallel.mesh.all_reduce_sum``, the count
  ``n`` the global one.  Moments a synchronized BatchNorm is *handed*
  (:func:`batch_norm_from_moments`, ``batch_norm_scale_shift(...,
  moments=)``, :func:`folded_bn_conv`) are taken to be global already: the
  fused blocks sum theirs over the ranks (``ops/fused_conv1.py::
  batch_shard_mapped``); moments they compute themselves are summed here;
* :func:`batch_norm_scale_shift` -- ``BatchNormStats``: the per-channel
  ``(s, t)`` of ``BN(x) = x * s + t``, for the DCNN's fused second block,
  whose kernel takes the BatchNorm folded into its weights (``weight * s``)
  and an additive map (the convolution of the constant ``t``);
* :class:`MaxFeatureMap2D` -- ``max_feature_map_2d``, the LCNN's maxout
  over channel halves (reference src/audiofakedetect/models.py:161-209);
* :class:`BLSTMLayer` -- the bidirectional LSTM that keeps the sequence
  length (reference models.py:212-237);
* :func:`run_layers` -- the CNNs' layers, in float32 as they are, or in a
  compute type (the JAX models' ``dtype``, bfloat16) with the JAX module's
  casts:
  :func:`folded_bn_conv` for every BatchNorm -> conv pair, and
  :func:`conv_in_dtype`, :func:`prelu_in_dtype`, :func:`linear_in_dtype`
  for flax's ``Conv`` / ``PReLU`` / ``Dense`` with ``dtype``; with the
  model's int8 sites, each site's convolution on the int8 path
  (``folded_bn_conv(..., act_scale=)`` for the JAX function's int8 branch,
  :func:`quantized_conv_bias` for the un-normalised sites).

Everything else the JAX module holds (``Conv2d``, ``PReLU``, ...) is
``torch.nn`` here.  In float32 its ``folded_bn_conv`` is a schedule of
BatchNorm -> conv for XLA and is ``nn.BatchNorm2d`` -> ``nn.Conv2d`` here;
in a compute type the rounding points are the result, so
:func:`folded_bn_conv` folds as the JAX function does.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_conv import int8_conv_site
from ..ops.int8_conv_cuda import output_plane
from ..ops.quantize import conv_int8_weights, conv_site_record
from ..parallel.mesh import all_reduce_sum, mesh_size


def compute_dtype(dtype):
    """A model's compute type: ``None`` for float32, or ``torch.bfloat16``
    (the JAX models' ``dtype``)."""
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be None, float32 or bfloat16: {dtype!r}")
    return None if dtype == torch.float32 else dtype


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


def _moments_mean_var(n: int, s: torch.Tensor, q: torch.Tensor):
    """Float32 ``(mean, biased var)`` from ``s = sum(x)``, ``q = sum(x**2)``
    over ``n`` values per channel."""
    mean = s.float() / n
    return mean, torch.clamp(q.float() / n - mean * mean, min=0.0)


def _bn_mesh(bn: nn.BatchNorm2d):
    """The mesh a synchronized BatchNorm sums its moments over, or None."""
    return getattr(bn, "mesh", None)


def _count(bn: nn.BatchNorm2d, x: torch.Tensor) -> int:
    """Values per channel the moments of ``bn`` cover: ``x``'s over
    ``(B, H, W)``, times the ranks when ``bn`` is synchronized (every rank
    holds a batch of the same size: the loader and ``shard_batch`` see to
    it)."""
    return x.numel() // x.shape[1] * mesh_size(_bn_mesh(bn))


def batch_moments(bn: nn.BatchNorm2d, x: torch.Tensor):
    """:func:`one_pass_moments` of ``x``, summed over the ranks when ``bn``
    is synchronized (differentiable: the cotangents are summed too)."""
    s, q = one_pass_moments(x)
    mesh = _bn_mesh(bn)
    return (s, q) if mesh is None else all_reduce_sum((s, q), mesh)


def batch_norm_from_moments(
    bn: nn.BatchNorm2d, x: torch.Tensor, s: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """Train-mode ``bn(x)`` on ``x [B, C, H, W]`` from ``s = sum(x)`` and
    ``q = sum(x**2)`` over ``(B, H, W)``, float32 ``[C]`` (over the global
    batch when ``bn`` is synchronized: then ``n`` counts every rank's).

    torch semantics: ``mean = s/n``, ``var = max(q/n - mean**2, 0)``
    (biased) normalises; ``running_var`` takes the unbiased ``var*n/(n-1)``;
    ``running_mean``/``running_var`` move by ``bn.momentum`` and
    ``num_batches_tracked`` grows by one -- ``bn``'s own buffers, updated in
    place, so the state dict keeps its layout.  All statistics are float32;
    the result is differentiable through ``x``, ``s`` and ``q``.
    """
    n = _count(bn, x)
    mean, var = _moments_mean_var(n, s, q)
    scale, shift = _train_scale_shift(bn, n, mean, var)
    shape = (1, -1, 1, 1)
    # one pass over x: x * scale + shift
    y = torch.addcmul(shift.reshape(shape), x.float(), scale.reshape(shape))
    return y.to(x.dtype)


def batch_norm_scale_shift(bn: nn.BatchNorm2d, x: torch.Tensor, moments=None):
    """Float32 per-channel ``(s, t)`` with ``bn(x) = x * s + t``, without
    normalising ``x``.

    In training ``s`` and ``t`` come from the batch moments of ``x [B, C, H,
    W]`` (differentiable through ``x``), or from ``moments``, its float32
    ``(sum, sumsq)`` when a fused block has accumulated them (differentiable
    through them), and ``bn``'s running buffers and ``num_batches_tracked``
    move exactly as in :func:`batch_norm_from_moments`; in eval they come
    from the running buffers.  A synchronized ``bn`` takes the global
    batch's moments (:func:`batch_moments`; ``moments`` it is handed are
    global already).
    """
    if bn.training:
        n = _count(bn, x)
        if moments is None and _bn_mesh(bn) is not None:
            moments = batch_moments(bn, x)
        if moments is None:
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = _moments_mean_var(n, *moments)
        return _train_scale_shift(bn, n, mean, var)
    return _affine_scale_shift(bn, bn.running_mean, bn.running_var)


def one_pass_moments(x: torch.Tensor):
    """Float32 per-channel ``(sum(x), sum(x**2))`` of ``x [B, C, H, W]``:
    the JAX package's one-pass BatchNorm statistics, which its models take
    in every compute type (``_torch_bn_stats``)."""
    x32 = x.float()
    return x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3))


class SyncBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that normalises a train-mode batch with the
    moments of the global batch over ``mesh``: the one-pass float32
    moments summed over the ranks (:func:`batch_moments`), then
    :func:`batch_norm_from_moments` with the global count, so the running
    buffers move the same on every rank (their unbiased factor takes the
    global ``n``).  Without a mesh, and in eval, it is ``nn.BatchNorm2d``;
    its state dict is ``nn.BatchNorm2d``'s.

    Not ``nn.SyncBatchNorm``: that one refuses CPU tensors under a process
    group, and its Welford moments are not the JAX package's one-pass ones.
    """

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.mesh is None:
            return super().forward(x)
        return batch_norm_from_moments(self, x, *batch_moments(self, x))


def use_mesh(model: nn.Module, mesh) -> nn.Module:
    """Put ``model`` on ``mesh`` (or take it off, ``None``), in place: each
    ``nn.BatchNorm2d`` becomes a :class:`SyncBatchNorm2d` over it (the same
    object, parameters and buffers, so an optimizer that holds them is
    unaffected), and each module with a ``mesh`` attribute (the DCNN's and
    the LCNN's fused blocks) takes it.  Returns ``model``."""
    for module in model.modules():
        if isinstance(module, nn.BatchNorm2d):
            if type(module) is nn.BatchNorm2d:
                module.__class__ = SyncBatchNorm2d
            module.mesh = mesh
        elif "mesh" in vars(module):
            module.mesh = mesh
    return model


def _conv_args(conv: nn.Conv2d):
    return conv.stride, conv.padding, conv.dilation


def folded_bn_conv(
    bn: nn.BatchNorm2d,
    conv: nn.Conv2d,
    x: torch.Tensor,
    moments=None,
    act_scale: Optional[float] = None,
    baked: Optional[Callable] = None,
) -> torch.Tensor:
    """``conv(bn(x))`` in ``x``'s compute type, folded as the JAX package's
    ``folded_bn_conv``: with ``bn(x) = x * s + t`` (float32 ``s``, ``t``),
    ``conv(x, (weight * s))`` plus the convolution of the constant map ``t``
    with ``weight`` (a batch-1 convolution, exact at the zero-padded
    borders) plus the bias.  The folded weights are rounded once to the
    compute type, and ``t``, ``weight`` and the bias are cast to it.
    ``moments``: the ``(sum, sumsq)`` of ``x`` when a fused block has
    accumulated them, else :func:`one_pass_moments` in training, as in the
    JAX function.

    ``act_scale``: the site's calibrated activation scale; the site then
    runs on the int8 path (``ops/int8_conv.py::int8_conv_site``: the main
    convolution with the weights folded in float32 and quantized per output
    channel, then the map and the bias added in the compute type; one
    kernel on the card).  ``baked`` (``Int8Sites.baked`` of the site) gives
    the site's baked record (with the map at the baked input's plane) from
    the function that makes it, or None; an eval-mode site with a baked
    record whose map fits the input computes no BatchNorm statistics."""
    dt = x.dtype
    weight = conv.weight

    def scale_shift():
        m = batch_moments(bn, x) if bn.training and moments is None else moments
        return batch_norm_scale_shift(bn, x, m)

    def fold_map(t):  # the convolution of the constant map t: [Cout, Ho, Wo]
        t_map = t.to(dt).reshape(1, -1, 1, 1).expand(1, x.shape[1], *x.shape[2:])
        return F.conv2d(t_map, weight.to(dt), None, *_conv_args(conv))[0]

    def folded():  # in float32: the codes do not inherit the compute type's rounding
        s, t = scale_shift()
        return weight.float() * s.reshape(1, -1, 1, 1), fold_map(t)

    bias = conv.bias.to(dt)
    if act_scale is None:
        s, t = scale_shift()
        y = F.conv2d(x, (weight * s.reshape(1, -1, 1, 1)).to(dt), None, *_conv_args(conv))
        return y + fold_map(t) + bias.reshape(-1, 1, 1)
    rec = baked(lambda: conv_site_record(*folded())) if baked is not None else None
    plane = (weight.shape[0], *output_plane(*x.shape[2:], weight.shape[2], conv.padding[0],
                                            conv.dilation[0]))
    const = None if rec is None or bn.training else rec.get("map")
    if rec is None:
        w32, const = folded()
        rec = conv_int8_weights(w32)
    elif const is None or const.dtype != dt or tuple(const.shape) != plane:
        const = fold_map(scale_shift()[1])  # baked at another plane or type
    return int8_conv_site(x, act_scale, rec, conv.padding[0], conv.dilation[0], const=const,
                          bias=bias)


def conv_in_dtype(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``Conv(dtype=...)``: the convolution in ``x``'s type with the
    kernel cast to it, then the cast bias added."""
    dt = x.dtype
    y = F.conv2d(x, conv.weight.to(dt), None, *_conv_args(conv))
    return y + conv.bias.to(dt).reshape(-1, 1, 1)


def prelu_in_dtype(prelu: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    """The JAX ``PReLU``: ``where(x >= 0, x, alpha * x)`` with the slope cast
    to ``x``'s type."""
    return torch.where(x >= 0, x, prelu.weight.to(x.dtype) * x)


def linear_in_dtype(linear: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input and kernel cast to ``dtype``, the
    product, then the cast bias added."""
    return F.linear(x.to(dtype), linear.weight.to(dtype)) + linear.bias.to(dtype)


def quantized_conv_bias(
    conv: nn.Conv2d, x: torch.Tensor, act_scale: float, baked: Optional[Callable] = None
) -> torch.Tensor:
    """An un-normalised conv site on the int8 path (the JAX DCNN's ``cnn_0``,
    the LCNN's ``lcnn_0``, ``lcnn_3`` and ``lcnn_16``): ``quantized_conv(x,
    weight, act_scale) + bias``, in ``x``'s type, as one site
    (``ops/int8_conv.py::int8_conv_site``)."""
    w32 = conv.weight.float()
    rec = baked(lambda: conv_site_record(w32)) if baked is not None else None
    return int8_conv_site(x, act_scale, rec if rec is not None else conv_int8_weights(w32),
                          conv.padding[0], conv.dilation[0], bias=conv.bias.to(x.dtype))


def run_layers(layers, x: torch.Tensor, folded: bool, sites=None, start: int = 0) -> torch.Tensor:
    """``layers`` (a list of modules) on ``x``: as they are, or ``folded``,
    in ``x``'s compute type with the JAX models' casts: each BatchNorm folds
    into the convolution that follows it (:func:`folded_bn_conv`),
    convolutions and PReLUs cast their parameters, pools, dropout and
    MaxFeatureMap run as they are.

    ``sites`` (``ops.quantize.Int8Sites``, or None): the model's int8 sites;
    the convolution at index ``start + i`` of the model's sequence is the
    site ``sites.prefix + str(start + i)``, calibrated on its input (the
    input of the BatchNorm in front of it, if any) and, where the scales
    include it, run on the int8 path, its BatchNorm folded."""
    if not folded and sites is None:
        for layer in layers:
            x = layer(x)
        return x
    i = 0
    while i < len(layers):
        layer = layers[i]
        if isinstance(layer, (nn.BatchNorm2d, nn.Conv2d)):
            bn = layer if isinstance(layer, nn.BatchNorm2d) else None
            if bn is not None:
                i += 1
            conv, name = layers[i], str(start + i)
            scale = sites.scale(name, x) if sites is not None else None
            baked = partial(sites.baked, name) if scale is not None else None
            if bn is not None and (folded or scale is not None):
                x = folded_bn_conv(bn, conv, x, act_scale=scale, baked=baked)
            elif bn is not None:
                x = conv(bn(x))
            elif scale is not None:
                x = quantized_conv_bias(conv, x, scale, baked)
            else:
                x = conv_in_dtype(conv, x) if folded else conv(x)
        elif isinstance(layer, nn.PReLU) and folded:
            x = prelu_in_dtype(layer, x)
        else:
            x = layer(x)
        i += 1
    return x


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
