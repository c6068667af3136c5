"""Fused first blocks: the DCNN's conv2d(1->C, 3x3, pad 2) + PReLU + max-pool
2x2, and the LCNN's conv2d(1->C, 5x5, pad 2) + MaxFeatureMap + max-pool 2x2.

Counterpart of ``audiodeepfake_detection_tpu/ops/fused_conv1.py``
(``fused_conv1_prelu_pool`` and ``fused_conv1_prelu_pool_stats``), with the
JAX package's signature and layout::

    x [B, H, W], w [9, C], b [C], alpha [1] -> out [B, h2, w2, C]
    h2 = (H + 2) // 2, w2 = (W + 2) // 2

Tap ``w[dh * 3 + dw, c]`` is torch's ``conv.weight[c, 0, dh, dw]``.  The
PReLU runs before the pool (a negative slope makes pool-then-PReLU wrong);
the pool is floor mode and ties pick the first of the window's phases
``(0,0), (0,1), (1,0), (1,1)``.  Both versions return the output as a view
of NCHW memory: ``out.permute(0, 3, 1, 2)`` is contiguous, the layout the
convolutions behind the block read, so nothing is copied between them.
The ``_stats`` variant also returns the float32 per-channel ``(sum,
sumsq)`` of the stored (rounded) output, the moments the next BatchNorm
needs, so the activation is not read again for statistics; gradients flow
through the moments.

No gradient reaches ``x``: it is the transform's output, made under
``torch.no_grad()``.  An ``x`` that requires grad raises.

float32 in gives float32 out with float32 arithmetic.  bfloat16 in gives
bfloat16 out: ``x`` and the parameters are rounded to bfloat16, products
accumulate and the elementwise work runs in float32, and the moments are
those of the rounded output.  Gradients come back in each parameter's type.

On a CUDA tensor the public functions launch the hand-written kernels of
``csrc/fused_conv1.cu`` (forward and backward, behind one
``torch.autograd.Function``) or raise; there is no fallback.  Where no
gradient is needed, :func:`fused_conv1_prelu_pool` and
:func:`fused_conv_mfm_pool` call the ops ``adfd::fused_conv1_prelu_pool``
and ``adfd::fused_conv_mfm_pool`` instead (``ops/library.py``): the forward
kernel on a CUDA tensor, the plain version on a CPU one.  The plain
PyTorch version below (``F.conv2d`` -> PReLU -> ``F.max_pool2d`` -> moments,
ordinary autograd) runs only for a CPU tensor, and is what the kernels are
checked against.  Both return the true ``dalpha`` at ``alpha == 0`` (the
JAX kernel returns 0 there).

The LCNN block (``fused_conv_mfm_pool``, the JAX function of that name)::

    x [B, H, W], w [25, C], b [C] -> out [B, H // 2, W // 2, C // 2]

Tap ``w[dh * 5 + dw, c]`` is torch's ``conv.weight[c, 0, dh, dw]``.  Each
output is the maximum of eight conv values: the four pool phases of channel
``k`` and of channel ``k + C/2``.  The gradient of a tie goes to the first
maximal candidate in the order phase-major, lower half first -- what the
JAX kernel's selection code records, and what ``torch.where(a >= b, a, b)``
followed by ``F.max_pool2d`` do in the plain version (``torch.maximum``
would split a tie in halves).  Both versions return the output as a view of
NCHW memory: ``out.permute(0, 3, 1, 2)`` is contiguous, the layout the
convolutions behind the block read.  Ties are real: a silent frame makes every
conv value of a channel equal to its bias.  Same rules as above for types,
for ``x`` (no gradient, raises if asked) and for the device: a CUDA tensor
launches the kernels of ``csrc/fused_conv1.cu`` or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum, has_axis
from . import fused_conv1_cuda, library

PAD = 2
K = 3


def can_batch_shard(mesh, batch_size: int, axis: str = "data") -> bool:
    """True when a fused kernel runs as :func:`batch_shard_mapped` over
    ``mesh``: the mesh exists and has the batch axis (the JAX gate, its
    ``fused_conv1.py:544``).  ``batch_size`` is the rank's own batch: a
    process per device already holds its shard, so any size runs (JAX's
    check that the global batch divides over the devices is the loader's
    and ``parallel.mesh.shard_batch``'s here)."""
    return has_axis(mesh, axis) and batch_size > 0


def batch_shard_mapped(fn, mesh, axis: str = "data", stat_outputs: int = 0):
    """A fused kernel on this rank's batch shard (JAX ``fused_conv1.py:
    554``, a ``shard_map``): ``fn`` itself, with its last ``stat_outputs``
    outputs (the BatchNorm moments) summed over the ranks of ``axis`` by
    one autograd-aware all-reduce, so the BatchNorm behind it normalises
    with the global batch's moments and every rank's gradient sees their
    cotangents summed (the transpose of JAX's ``psum``)."""
    if stat_outputs == 0:
        return fn

    def wrapped(*args):
        outs = list(fn(*args))
        k = len(outs) - stat_outputs
        outs[k:] = all_reduce_sum(outs[k:], mesh, axis)
        return tuple(outs)

    return wrapped


def pad_geometry(h: int, w: int) -> Tuple[int, int]:
    """Pooled (floor) output size of an ``[H, W]`` plane."""
    return (h + 2 * PAD - K + 1) // 2, (w + 2 * PAD - K + 1) // 2


def _rounded_params(x, w, b, alpha):
    """The parameters as the block sees them: rounded to ``x``'s type, then
    float32 (a no-op chain for float32)."""
    dt = x.dtype
    return w.to(dt).float(), b.to(dt).float(), alpha.to(dt).float()


def _plain_pooled(x, w, b, alpha) -> torch.Tensor:
    """Float32 ``[B, h2, w2, C]`` view of NCHW memory holding the values the
    block stores (rounded to ``x``'s type).  The rounding is straight-through, so
    cotangents stay float32 all the way, as in the kernel: autograd through
    a bfloat16 tensor would round ``g + gs + 2 * out * gq`` to bfloat16 and
    drop every moment cotangent below half an ulp of ``g``."""
    wq, bq, aq = _rounded_params(x, w, b, alpha)
    c = w.shape[1]
    conv = F.conv2d(
        x.float()[:, None], wq.t().reshape(c, 1, K, K), bq, padding=PAD
    )
    act = torch.where(conv >= 0, conv, aq * conv)
    pooled = F.max_pool2d(act, 2)  # floor mode; its backward takes the first max
    pooled = pooled.permute(0, 2, 3, 1)  # NCHW memory, as the kernel's
    if x.dtype != torch.float32:
        pooled = pooled + (pooled.to(x.dtype).float() - pooled).detach()
    return pooled


def plain_conv1_prelu_pool(x, w, b, alpha) -> torch.Tensor:
    """The block in plain PyTorch ops, differentiable by autograd."""
    return _plain_pooled(x, w, b, alpha).to(x.dtype)


def plain_conv1_prelu_pool_stats(x, w, b, alpha):
    """Plain version with the ``(sum, sumsq)`` of the rounded output."""
    o32 = _plain_pooled(x, w, b, alpha)
    return o32.to(x.dtype), o32.sum(dim=(0, 1, 2)), (o32 * o32).sum(dim=(0, 1, 2))


class _FusedConv1(torch.autograd.Function):
    """The CUDA kernels: forward (with code and moments when needed) and
    backward (``dW``, ``db``, ``dalpha``; nothing for ``x``)."""

    @staticmethod
    def forward(ctx, x, w, b, alpha, want_stats: bool):
        wq, bq, aq = _rounded_params(x, w, b, alpha)
        wq, bq, aq = wq.contiguous(), bq.contiguous(), aq.contiguous()
        want_code = any(ctx.needs_input_grad[1:4])
        out, code, s, q = fused_conv1_cuda.forward(
            x, wq, bq, aq, want_code, want_stats
        )
        if want_code:
            # not the output: the backward rebuilds it from x and the code
            ctx.save_for_backward(x, wq, bq, aq, code)
            ctx.param_dtypes = (w.dtype, b.dtype, alpha.dtype)
            ctx.want_stats = want_stats
        return out, s, q

    @staticmethod
    def backward(ctx, g, gs, gq):
        x, wq, bq, aq, code = ctx.saved_tensors
        if ctx.want_stats:
            gs, gq = gs.float().contiguous(), gq.float().contiguous()
        else:
            gs = gq = None
        if not g.permute(0, 3, 1, 2).is_contiguous():
            # the kernel reads NCHW memory, as cuDNN hands it back; a caller
            # that gives another layout pays one copy
            g = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        dw, db, da = fused_conv1_cuda.backward(x, wq, bq, aq, g, code, gs, gq)
        wt, bt, at = ctx.param_dtypes
        return None, dw.to(wt), db.to(bt), da.to(at), None


def _refuse_x_grad(x, what: str) -> None:
    if x.requires_grad:
        raise ValueError(
            f"{what} defines no gradient for x (the transform's output needs "
            "none); detach it, or use the unfused block"
        )


def _run(x, w, b, alpha, want_stats: bool):
    _refuse_x_grad(x, "fused_conv1_prelu_pool")
    if x.device.type == "cpu":
        if want_stats:
            return plain_conv1_prelu_pool_stats(x, w, b, alpha)
        return plain_conv1_prelu_pool(x, w, b, alpha), None, None
    return _FusedConv1.apply(x, w, b, alpha, want_stats)


def _conv1_cuda(x, w, b, alpha) -> torch.Tensor:
    """The forward kernel without code or moments: ``_FusedConv1`` in eval."""
    wq, bq, aq = (t.contiguous() for t in _rounded_params(x, w, b, alpha))
    return fused_conv1_cuda.forward(x, wq, bq, aq, False, False)[0]


def _conv1_fake(x, w, b, alpha) -> torch.Tensor:
    shape = (x.shape[0], *pad_geometry(*x.shape[1:]), w.shape[1])
    return fused_conv1_cuda._nchw_empty(shape, x.dtype, x.device)


_CONV1_OP = library.register(
    "fused_conv1_prelu_pool", "(Tensor x, Tensor w, Tensor b, Tensor alpha) -> Tensor",
    cpu=plain_conv1_prelu_pool, cuda=_conv1_cuda, fake=_conv1_fake)


def fused_conv1_prelu_pool(x, w, b, alpha) -> torch.Tensor:
    """``[B, H, W] x [9, C] x [C] x [1] -> [B, h2, w2, C]`` fused block;
    the op ``adfd::fused_conv1_prelu_pool`` where no gradient is needed."""
    if library.needs_grad(w, b, alpha):
        return _run(x, w, b, alpha, False)[0]
    _refuse_x_grad(x, "fused_conv1_prelu_pool")
    return _CONV1_OP(x, w, b, alpha)


def fused_conv1_prelu_pool_stats(x, w, b, alpha):
    """Like :func:`fused_conv1_prelu_pool`, also returning the float32
    per-channel ``(sum, sumsq)`` of the output."""
    return _run(x, w, b, alpha, True)


# ------------------------------------------ conv 5x5 + MaxFeatureMap + pool

K_MFM = 5


def plain_conv_mfm_pool(x, w, b) -> torch.Tensor:
    """The LCNN block in plain PyTorch ops, differentiable by autograd."""
    dt = x.dtype
    c = w.shape[1]
    conv = F.conv2d(
        x.float()[:, None],
        w.to(dt).float().t().reshape(c, 1, K_MFM, K_MFM),
        b.to(dt).float(),
        padding=PAD,
    )
    lo, hi = conv[:, : c // 2], conv[:, c // 2 :]
    act = torch.where(lo >= hi, lo, hi)  # a tie's gradient goes to the lower half
    pooled = F.max_pool2d(act, 2)  # floor mode; its backward takes the first max
    return pooled.permute(0, 2, 3, 1).to(dt)  # NCHW memory, as the kernel's


class _FusedConvMfm(torch.autograd.Function):
    """The CUDA kernels: forward (with the selection code when a parameter
    needs a gradient) and backward (``dW``, ``db``; nothing for ``x``)."""

    @staticmethod
    def forward(ctx, x, w, b):
        wq = w.to(x.dtype).float().contiguous()
        bq = b.to(x.dtype).float().contiguous()
        want_code = any(ctx.needs_input_grad[1:3])
        out, code = fused_conv1_cuda.mfm_forward(x, wq, bq, want_code)
        if want_code:
            ctx.save_for_backward(x, code)
            ctx.channels = w.shape[1]
            ctx.param_dtypes = (w.dtype, b.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, code = ctx.saved_tensors
        if not g.permute(0, 3, 1, 2).is_contiguous():
            # the kernel reads NCHW memory, as cuDNN hands it back; a caller
            # that gives another layout pays one copy
            g = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        dw, db = fused_conv1_cuda.mfm_backward(x, g, code, ctx.channels)
        wt, bt = ctx.param_dtypes
        return None, dw.to(wt), db.to(bt)


def _mfm_cuda(x, w, b) -> torch.Tensor:
    """The forward kernel without the code: ``_FusedConvMfm`` in eval."""
    wq = w.to(x.dtype).float().contiguous()
    bq = b.to(x.dtype).float().contiguous()
    return fused_conv1_cuda.mfm_forward(x, wq, bq, False)[0]


def _mfm_fake(x, w, b) -> torch.Tensor:
    bsz, h, win = x.shape
    return fused_conv1_cuda._nchw_empty((bsz, h // 2, win // 2, w.shape[1] // 2), x.dtype,
                                        x.device)


_MFM_OP = library.register(
    "fused_conv_mfm_pool", "(Tensor x, Tensor w, Tensor b) -> Tensor",
    cpu=plain_conv_mfm_pool, cuda=_mfm_cuda, fake=_mfm_fake)


def fused_conv_mfm_pool(x, w, b) -> torch.Tensor:
    """``[B, H, W] x [25, C] x [C] -> [B, H//2, W//2, C//2]`` fused block;
    the op ``adfd::fused_conv_mfm_pool`` where no gradient is needed."""
    _refuse_x_grad(x, "fused_conv_mfm_pool")
    if not library.needs_grad(w, b):
        return _MFM_OP(x, w, b)
    if x.device.type == "cpu":
        return plain_conv_mfm_pool(x, w, b)
    return _FusedConvMfm.apply(x, w, b)
