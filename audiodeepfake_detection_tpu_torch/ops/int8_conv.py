"""s8 x s8 -> s32 convolution with a per-output-channel dequantization.

Counterpart of ``audiodeepfake_detection_tpu/ops/quantize.py::int8_conv``
(XLA's s8 convolution, ``preferred_element_type=int32``) together with the
dequantizing tail of its ``quantized_conv``::

    x_q [B, H, W, Cin] int8 (NHWC), w_q [Cout, Cin, k, k] int8 (OIHW),
    scale [Cout] float32
      -> [B, Cout, Ho, Wo] (NCHW): (acc.float() * scale).to(out_dtype)

where ``acc`` is the int32 sum of code products (stride 1, zero padding
``padding`` on each side, dilation ``dilation``); ``out_dtype=torch.int32``
returns ``acc`` itself.  The input is NHWC, as the quantizing pass writes
it, so the kernel reads a tap's channels as one run; the output is NCHW,
where the port's layers take it.

:func:`int8_conv` calls the op ``adfd::int8_conv`` (``ops/library.py``;
no gradient is defined): on a CUDA tensor it launches the hand-written
kernel of ``csrc/int8_conv.cu`` (``ops/int8_conv_cuda.py``) or raises; there
is no fallback.  :func:`int8_conv_plain` runs only for a CPU tensor, and is what
the kernel is checked against: the convolution of the codes in float64,
which is exact (every partial sum is an integer below 2^53; fp32 is not:
at the DCNN's cnn_14, K = 1152 and 1152 * 127^2 > 2^24), rounded to int32,
then the same float32 epilogue.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import int8_conv_cuda, library


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


_OP = library.register(
    "int8_conv", "(Tensor x_q, Tensor w_q, Tensor? scale, int padding, int dilation, "
    "ScalarType out_dtype) -> Tensor",
    cpu=_plain_contiguous, cuda=_cuda, fake=_fake)
