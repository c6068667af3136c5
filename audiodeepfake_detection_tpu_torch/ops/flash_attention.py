"""Fused multi-head attention on the packed qkv projection (the AST encoder).

Counterpart of ``audiodeepfake_detection_tpu/ops/flash_attention.py``
(``flash_mha_packed``), in the JAX layout as it is::

    qkv [B, N, 3*H*D] (lane order [3][head][dim]) -> out [B, N, H*D]

per batch element and head ``softmax(q k^T * scale) v``, with no transposes
around the call.  Scores, softmax and products accumulate in float32; a
bfloat16 input rounds where the JAX kernel rounds: the probabilities before
``P.V`` (and before ``dV``), the score cotangent ``dS`` before ``dQ`` and
``dK``, and each output.  No attention dropout (the fused path needs
``attn_drop_rate == 0``, as in JAX).

On a CUDA tensor :func:`flash_mha_packed` launches the hand-written kernels of
``csrc/flash_mha.cu`` (forward and backward, behind one
``torch.autograd.Function``; the ``[B, H, N, N]`` scores never reach device
memory; one route for every N) or raises; nothing falls back.  Where no
gradient is needed it calls the op ``adfd::flash_mha_packed`` instead
(``ops/library.py``): the forward kernel on a CUDA tensor, the plain
version on a CPU one.  The plain PyTorch version :func:`plain_mha_packed`
runs only for a CPU tensor, and is what the kernels are checked against.
"""

from __future__ import annotations

import torch

from . import flash_attention_cuda, library


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the cotangent to ``dtype``."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).float(), None


def _round(x32: torch.Tensor, dtype) -> torch.Tensor:
    """``x32`` rounded to ``dtype`` (kept float32) with the gradient of the
    identity: the cotangent stays float32, as in the JAX kernel's backward."""
    return x32 + (x32.to(dtype).float() - x32).detach()


def plain_mha_packed(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """The JAX kernel's arithmetic in plain PyTorch ops, differentiable by
    autograd (whose softmax backward is the kernel's ``p * (dp - rowsum(dp *
    p))``)."""
    b, n, c = qkv.shape
    dtype = qkv.dtype
    q, k, v = qkv.float().view(b, n, 3, heads, c // 3 // heads).unbind(2)
    dot = torch.einsum("bnhd,bmhd->bhnm", q, k)
    if dtype != torch.float32:
        dot = _RoundGrad.apply(dot, dtype)  # dS = p * (dp - rowsum) * scale rounds
    p = torch.softmax(dot * scale, dim=-1)
    if dtype != torch.float32:
        p = _round(p, dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", p, v)
    return out.reshape(b, n, c // 3).to(dtype)


class _FlashMHA(torch.autograd.Function):
    """The CUDA kernels: forward (with row statistics when a gradient is
    needed) and backward (``dqkv``, recomputing P from qkv; the output is
    kept for the fp32 row term ``rowsum(dout * out)``)."""

    @staticmethod
    def forward(ctx, qkv, heads: int, scale: float):
        want_stats = ctx.needs_input_grad[0]
        out, stats = flash_attention_cuda.forward(qkv, heads, scale, want_stats)
        if want_stats:
            ctx.save_for_backward(qkv, stats, out)
            ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, stats, out = ctx.saved_tensors
        dqkv = flash_attention_cuda.backward(
            qkv, g.to(qkv.dtype).contiguous(), stats, ctx.heads, ctx.scale, out=out
        )
        return dqkv, None, None


def _mha_cuda(qkv, heads: int, scale: float) -> torch.Tensor:
    """The forward kernel without row statistics: ``_FlashMHA`` in eval."""
    return flash_attention_cuda.forward(qkv, heads, scale, False)[0]


def _mha_plain(qkv, heads: int, scale: float) -> torch.Tensor:
    # contiguous, as the kernel writes it
    return plain_mha_packed(qkv, heads, scale).contiguous()


def _mha_fake(qkv, heads: int, scale: float) -> torch.Tensor:
    b, n, c = qkv.shape
    return qkv.new_empty((b, n, c // 3))


_MHA_OP = library.register(
    "flash_mha_packed", "(Tensor qkv, int heads, float scale) -> Tensor",
    cpu=_mha_plain, cuda=_mha_cuda, fake=_mha_fake)


def flash_mha_packed(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Fused MHA on packed ``[B, N, 3*H*D]`` qkv; returns ``[B, N, H*D]``;
    the op ``adfd::flash_mha_packed`` where no gradient is needed."""
    if not library.needs_grad(qkv):
        return _MHA_OP(qkv, heads, float(scale))
    if qkv.device.type == "cpu":
        return plain_mha_packed(qkv, heads, scale)
    return _FlashMHA.apply(qkv, heads, scale)
