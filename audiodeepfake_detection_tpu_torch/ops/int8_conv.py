"""The int8 convolution: a whole quantized site, and the s8 x s8 -> s32 product of codes.

Counterpart of ``audiodeepfake_detection_tpu/ops/quantize.py::int8_conv``
(XLA's s8 convolution, ``preferred_element_type=int32``) and of its
``quantized_conv`` with what a site adds after it.  Two entries, one kernel
source (``csrc/int8_conv.cu``, launched by ``ops/int8_conv_cuda.py``):

* :func:`int8_conv_site`, the op ``adfd::int8_conv_site``: a whole int8
  site from the working-type activation::

      x [B, Cin, H, W] float32 or bfloat16 (NCHW), act_scale s_x, a weight
      record {w_q [Cout, Cin, k, k] int8 (OIHW), s_w [Cout] float32, and
      optionally rows, the codes in the kernel's layout}, optional map
      [Cout, Ho, Wo] and bias [Cout] in x's type
        -> (acc.float() * float32(s_x * s_w)).to(x.dtype) (+ map) (+ bias)

  with ``acc`` the int32 sum of the products of the activation's codes
  (:func:`quantize_activation_nhwc`) and ``w_q`` (stride 1, zero padding
  ``padding`` on each side, dilation ``dilation``), each addition rounded
  to ``x``'s type: what ``models/layers.py``'s ``folded_bn_conv(act_scale=)``
  and ``quantized_conv_bias`` computed as separate passes around the
  codes-in product.  On a CUDA tensor it is one launch of the kernel, which
  quantizes as it loads and adds the map and the bias in its epilogue;

* :func:`int8_conv`, the op ``adfd::int8_conv``: codes in::

      x_q [B, H, W, Cin] int8 (NHWC), w_q [Cout, Cin, k, k] int8 (OIHW),
      scale [Cout] float32
        -> [B, Cout, Ho, Wo] (NCHW): (acc.float() * scale).to(out_dtype)

  ``out_dtype=torch.int32`` returns ``acc`` itself.

No gradient is defined for either.  On a CUDA tensor each launches the
hand-written kernel or raises; there is no fallback.  The plain versions
(:func:`int8_conv_site_plain`, :func:`int8_conv_plain`) run only for a CPU
tensor, and are what the kernel is checked against: the convolution of the
codes in float64, which is exact (every partial sum is an integer below
2^53; fp32 is not: at the DCNN's cnn_14, K = 1152 and 1152 * 127^2 > 2^24),
rounded to int32, then the same float32 epilogue.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import int8_conv_cuda, library


def quantize_activation_nhwc(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric per-tensor int8 of ``x [B, C, H, W]``, ``clip(round(x *
    (1 / s)), -127, 127)`` (``ops/quantize.py::quantize_activation``), as
    contiguous NHWC codes ``[B, H, W, C]``, the layout :func:`int8_conv`
    reads (one elementwise pass and a layout-changing copy of the codes)."""
    inv = 1.0 / max(float(scale), 1e-30)
    q = torch.clamp(torch.round(x.float() * inv), -127.0, 127.0)
    codes = torch.empty(
        x.shape, dtype=torch.int8, device=x.device, memory_format=torch.channels_last
    )
    codes.copy_(q)  # exact: the values are integers in [-127, 127]
    return codes.permute(0, 2, 3, 1).contiguous()


def int8_conv_plain(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale: Optional[torch.Tensor],
    padding: int,
    dilation: int = 1,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain PyTorch version, on any device."""
    acc = F.conv2d(
        x_q.permute(0, 3, 1, 2).double(), w_q.double(), padding=padding, dilation=dilation
    )
    acc = torch.round(acc).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    return dequantize(acc, scale, out_dtype)


def dequantize(acc: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The epilogue of both versions: ``(acc.float() * scale[oc]).to(out_dtype)``
    on ``[B, Cout, Ho, Wo]`` int32 accumulators."""
    return (acc.float() * scale.reshape(1, -1, 1, 1)).to(out_dtype)


def int8_conv(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale: Optional[torch.Tensor],
    padding: int,
    dilation: int = 1,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one (the op
    ``adfd::int8_conv``)."""
    if x_q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8_conv runs on cuda or cpu, not {x_q.device}")
    return _OP(x_q, w_q, scale, padding, dilation, out_dtype)


def int8_conv_site_plain(
    x: torch.Tensor,
    act_scale: float,
    w_q: torch.Tensor,
    s_w: torch.Tensor,
    const: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    padding: int,
    dilation: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version of a site, on any device: the quantizing
    pass, the codes-in product, then the map and the bias added in ``x``'s
    type, in that order."""
    x_q = quantize_activation_nhwc(x, act_scale)
    y = int8_conv_plain(x_q, w_q, float(act_scale) * s_w, padding, dilation, x.dtype)
    if const is not None:
        y = y + const
    if bias is not None:
        y = y + bias.reshape(-1, 1, 1)
    return y


def int8_conv_site(
    x: torch.Tensor,
    act_scale: float,
    record: Dict[str, torch.Tensor],
    padding: int,
    dilation: int = 1,
    const: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A whole int8 site: the kernel on a CUDA tensor, the plain version on
    a CPU one (the op ``adfd::int8_conv_site``).  ``record``: ``{"w_q",
    "s_w"}`` and, when baked, ``"rows"`` (``ops/quantize.py::
    conv_site_record``); ``const``: the fold's ``[Cout, Ho, Wo]`` map;
    ``bias``: ``[Cout]``; both in ``x``'s type."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"int8_conv_site runs on cuda or cpu, not {x.device}")
    return _SITE_OP(x, float(act_scale), record["w_q"], record["s_w"], record.get("rows"),
                    const, bias, padding, dilation)


def _plain_contiguous(x_q, w_q, scale, padding, dilation, out_dtype):
    # contiguous NCHW, as the kernel writes it (the CPU convolution of the
    # NHWC codes may leave channels-last strides)
    return int8_conv_plain(x_q, w_q, scale, padding, dilation, out_dtype).contiguous()


def _cuda(x_q, w_q, scale, padding, dilation, out_dtype):
    return int8_conv_cuda.forward(x_q, w_q, scale, padding, dilation, out_dtype)


def _fake(x_q, w_q, scale, padding, dilation, out_dtype):
    b, h, w, _ = x_q.shape
    ho, wo = int8_conv_cuda.output_plane(h, w, w_q.shape[2], padding, dilation)
    return x_q.new_empty((b, w_q.shape[0], ho, wo), dtype=out_dtype)


def _site_plain(x, act_scale, w_q, s_w, rows, const, bias, padding, dilation):
    return int8_conv_site_plain(x, act_scale, w_q, s_w, const, bias, padding,
                                dilation).contiguous()


def _site_cuda(x, act_scale, w_q, s_w, rows, const, bias, padding, dilation):
    return int8_conv_cuda.site_forward(x, act_scale, w_q, s_w, rows, const, bias, padding,
                                       dilation)


def _site_fake(x, act_scale, w_q, s_w, rows, const, bias, padding, dilation):
    b, _, h, w = x.shape
    ho, wo = int8_conv_cuda.output_plane(h, w, w_q.shape[2], padding, dilation)
    return x.new_empty((b, w_q.shape[0], ho, wo))


_OP = library.register(
    "int8_conv", "(Tensor x_q, Tensor w_q, Tensor? scale, int padding, int dilation, "
    "ScalarType out_dtype) -> Tensor",
    cpu=_plain_contiguous, cuda=_cuda, fake=_fake)
_SITE_OP = library.register(
    "int8_conv_site", "(Tensor x, float act_scale, Tensor w_q, Tensor s_w, Tensor? rows, "
    "Tensor? fold_map, Tensor? bias, int padding, int dilation) -> Tensor",
    cpu=_site_plain, cuda=_site_cuda, fake=_site_fake)
