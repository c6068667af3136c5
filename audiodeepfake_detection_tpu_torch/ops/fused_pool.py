"""Fused PReLU (one shared slope) + floor-mode max-pool 2x2.

Counterpart of ``audiodeepfake_detection_tpu/ops/fused_pool.py``
(``fused_prelu_pool`` and ``fused_prelu_pool_stats``).  The JAX functions are
NHWC; here everything behind the first block lies in NCHW memory, where the
cuDNN layers on both sides of the pool leave and take it, so the port's
functions are NCHW and no copy stands on either side::

    x [B, C, H, W], alpha [1] -> out [B, C, H // 2, W // 2]

``x.permute(0, 2, 3, 1)`` is the JAX argument and ``out.permute(0, 2, 3, 1)``
the JAX result.  The PReLU runs before the pool (the slope may be negative,
so the order cannot be swapped); a tie goes to the first of the window's
positions ``(0,0), (0,1), (1,0), (1,1)``, which is what ``F.max_pool2d``'s
backward does too; the gradient of an odd last row or column (dropped by the
floor-mode pool) is zero.  The ``_stats`` variant also returns the float32
per-channel ``(sum, sumsq)`` of the stored (rounded) output, the moments the
next BatchNorm needs; gradients flow through the moments.

float32 in gives float32 out.  bfloat16 in gives bfloat16 out: the slope is
taken in the type it is handed in (the JAX DCNN hands the kernel its float32
slope), the elementwise work runs in float32, and the moments are those of
the rounded output.  ``dx`` comes back in ``x``'s type, ``dalpha`` in
``alpha``'s.

On a CUDA tensor the public functions launch the hand-written kernels of
``csrc/fused_pool.cu`` (forward and backward, behind one
``torch.autograd.Function``) or raise; there is no fallback and no geometry
switch to the unfused layers.  Where no gradient is needed,
:func:`fused_prelu_pool` calls the op ``adfd::fused_prelu_pool`` instead
(``ops/library.py``): the forward kernel on a CUDA tensor, the plain
version on a CPU one.  The plain PyTorch version below
(``torch.where`` -> ``F.max_pool2d`` -> moments, ordinary autograd) runs only
for a CPU tensor, and is what the kernels are checked against.  Both return
the true ``dalpha`` at ``alpha == 0`` (the JAX kernel returns 0 there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import fused_pool_cuda, library


def straight_through_round(t32: torch.Tensor, dtype) -> torch.Tensor:
    """Float32 tensor holding ``t32`` rounded to ``dtype``, with the
    gradient of the identity: cotangents stay float32 all the way, as in the
    kernels (autograd through a bfloat16 tensor would round ``g + gs +
    2 * out * gq`` to bfloat16 and drop every moment cotangent below half an
    ulp of ``g``)."""
    if dtype == torch.float32:
        return t32
    return t32 + (t32.to(dtype).float() - t32).detach()


def _plain_pooled(x, alpha) -> torch.Tensor:
    """Float32 ``[B, C, H//2, W//2]`` holding the values the block stores."""
    x32 = x.float()
    act = torch.where(x32 >= 0, x32, alpha.float() * x32)
    # floor mode; its backward takes the first maximum of a window
    return straight_through_round(F.max_pool2d(act, 2), x.dtype)


def plain_prelu_pool(x, alpha) -> torch.Tensor:
    """The block in plain PyTorch ops, differentiable by autograd."""
    return _plain_pooled(x, alpha).to(x.dtype)


def plain_prelu_pool_stats(x, alpha):
    """Plain version with the ``(sum, sumsq)`` of the rounded output."""
    o32 = _plain_pooled(x, alpha)
    return o32.to(x.dtype), o32.sum(dim=(0, 2, 3)), (o32 * o32).sum(dim=(0, 2, 3))


class _FusedPreluPool(torch.autograd.Function):
    """The CUDA kernels: forward (with code and moments when needed) and
    backward (``dx``, ``dalpha``)."""

    @staticmethod
    def forward(ctx, x, alpha, want_stats: bool):
        aq = alpha.float().contiguous()
        want_code = any(ctx.needs_input_grad[:2])
        out, code, s, q = fused_pool_cuda.forward(x, aq, want_code, want_stats)
        if want_code:
            ctx.save_for_backward(x, aq, out, code)
            ctx.alpha_dtype = alpha.dtype
            ctx.want_stats = want_stats
        return out, s, q

    @staticmethod
    def backward(ctx, g, gs, gq):
        x, aq, out, code = ctx.saved_tensors
        if ctx.want_stats:
            gs, gq = gs.float().contiguous(), gq.float().contiguous()
        else:
            gs = gq = None
        dx, da = fused_pool_cuda.backward(x, aq, g.contiguous(), out, code, gs, gq)
        return dx, da.to(ctx.alpha_dtype), None


def _run(x, alpha, want_stats: bool):
    if x.device.type == "cpu":
        if want_stats:
            return plain_prelu_pool_stats(x, alpha)
        return plain_prelu_pool(x, alpha), None, None
    return _FusedPreluPool.apply(x, alpha, want_stats)


def _pool_cuda(x, alpha) -> torch.Tensor:
    """The forward kernel without code or moments: ``_FusedPreluPool`` in eval."""
    return fused_pool_cuda.forward(x, alpha.float().contiguous(), False, False)[0]


def _pool_fake(x, alpha) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.new_empty((b, c, h // 2, w // 2))


_POOL_OP = library.register(
    "fused_prelu_pool", "(Tensor x, Tensor alpha) -> Tensor",
    cpu=plain_prelu_pool, cuda=_pool_cuda, fake=_pool_fake)


def fused_prelu_pool(x, alpha) -> torch.Tensor:
    """``[B, C, H, W] x [1] -> [B, C, H//2, W//2]`` fused PReLU + pool; the
    op ``adfd::fused_prelu_pool`` where no gradient is needed."""
    if library.needs_grad(x, alpha):
        return _run(x, alpha, False)[0]
    return _POOL_OP(x, alpha)


def fused_prelu_pool_stats(x, alpha):
    """Like :func:`fused_prelu_pool`, also returning the float32 per-channel
    ``(sum, sumsq)`` of the output."""
    return _run(x, alpha, True)
