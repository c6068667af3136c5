"""Fused mid block: conv2d(Cin -> Cout, 3x3, pad 1) with BatchNorm-folded
weights + PReLU + floor-mode max-pool 2x2.

Counterpart of ``audiodeepfake_detection_tpu/ops/fused_conv2.py``
(``fused_conv2_prelu_pool`` and ``fused_conv2_prelu_pool_stats``).  The JAX
functions are NHWC; here everything behind the first block lies in NCHW
memory, where the cuDNN layer in front leaves it and the layers behind take
it, so the port's functions are NCHW and no copy stands on either side::

    x [B, Cin, H, W], w [9 * Cin, Cout], corr [Cout, H, W], alpha [1]
        -> out [B, Cout, H // 2, W // 2]

``x.permute(0, 2, 3, 1)``, ``w`` as it is, ``corr.permute(1, 2, 0)`` are the
JAX arguments and ``out.permute(0, 2, 3, 1)`` the JAX result.  Row ``(dh * 3
+ dw) * Cin + ci`` of ``w`` is torch's ``conv.weight[co, ci, dh, dw]`` (times
the BatchNorm scale of channel ``ci``: the *effective* weights); ``corr`` is
the additive map a folded BatchNorm leaves, ``conv(t * 1, weight)[0] +
bias``, exact at the zero-padded borders (``models/dcnn.py`` builds both).
The PReLU runs before the pool; a tie goes to the first of the window's
positions ``(0,0), (0,1), (1,0), (1,1)``.  The ``_stats`` variant also
returns the float32 per-channel ``(sum, sumsq)`` of the stored (rounded)
output for the next BatchNorm; gradients flow through the moments.

Gradients reach all four arguments: ``dx``, ``dw`` (chained by autograd into
the conv weight and the BatchNorm moments), ``dcorr`` (zero in rows and
columns past the pooled region) and ``dalpha``.

float32 in gives float32 out with float32 arithmetic.  bfloat16 ``x`` gives
bfloat16 out: ``w`` and ``alpha`` are rounded to bfloat16, products
accumulate in float32, ``corr`` stays float32, and the moments are those of
the rounded output.  In the backward the cotangent of the conv output is
rounded to bfloat16 once before the two products that give ``dx`` and
``dw`` (``dcorr`` and ``dalpha`` take it in float32), as the JAX kernel
rounds ``d_row``: the kernels and the plain version (through
``_RoundCotangent``) do the same.  Gradients come back in each
argument's type.  (The kernels take the selected conv value of ``dalpha``
back from the stored output, ``out / alpha``: under bfloat16 that is 2**-9
per term coarser than the plain version, as in the JAX kernel.)

On a CUDA tensor the public functions launch the hand-written kernels of
``csrc/fused_conv2.cu`` (the contraction is theirs: no ``F.conv2d``, no
matrix product of a library) behind one ``torch.autograd.Function``, or
raise; there is no fallback and no geometry switch to the unfused layers.
Where no gradient is needed, :func:`fused_conv2_prelu_pool` calls the op
``adfd::fused_conv2_prelu_pool`` instead (``ops/library.py``): the forward
kernel on a CUDA tensor, the plain version on a CPU one.
The plain PyTorch version below (``F.conv2d`` -> PReLU -> ``F.max_pool2d``
-> moments, ordinary autograd) runs only for a CPU tensor, and is what the
kernels are checked against.  Both return the true ``dalpha`` at ``alpha ==
0`` (the JAX kernel returns 0 there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import fused_conv2_cuda, library
from .fused_pool import straight_through_round

K = 3  # kernel size; padding 1


def _rounded(x, w, alpha):
    """``w`` and ``alpha`` as the block sees them: rounded to ``x``'s type,
    then float32 (a no-op chain for float32)."""
    return w.to(x.dtype).float(), alpha.to(x.dtype).float()


class _RoundCotangent(torch.autograd.Function):
    """The identity forward; its backward rounds the cotangent to bfloat16
    (and back to float32), as the JAX kernel rounds the conv output's
    cotangent before its bf16 products."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def _weight(wq, c_in, c_out):
    """``[9 * Cin, Cout]`` as torch's ``[Cout, Cin, 3, 3]`` conv weight."""
    return wq.reshape(K, K, c_in, c_out).permute(3, 2, 0, 1)


def _plain_pooled(x, w, corr, alpha) -> torch.Tensor:
    """Float32 ``[B, Cout, H//2, W//2]`` holding the values the block
    stores."""
    wq, aq = _rounded(x, w, alpha)
    conv = F.conv2d(x.float(), _weight(wq, x.shape[1], w.shape[1]), padding=1)
    if x.dtype == torch.bfloat16:
        conv = _RoundCotangent.apply(conv)
    conv = conv + corr.float()
    act = torch.where(conv >= 0, conv, aq * conv)
    # floor mode; its backward takes the first maximum of a window
    return straight_through_round(F.max_pool2d(act, 2), x.dtype)


def plain_conv2_prelu_pool(x, w, corr, alpha) -> torch.Tensor:
    """The block in plain PyTorch ops, differentiable by autograd."""
    return _plain_pooled(x, w, corr, alpha).to(x.dtype)


def plain_conv2_prelu_pool_stats(x, w, corr, alpha):
    """Plain version with the ``(sum, sumsq)`` of the rounded output."""
    o32 = _plain_pooled(x, w, corr, alpha)
    return o32.to(x.dtype), o32.sum(dim=(0, 2, 3)), (o32 * o32).sum(dim=(0, 2, 3))


def plain_conv2_grads_from_code(x, w, corr, alpha, code, out, g, gs=None, gq=None):
    """The block's gradients ``(dx, dw, dcorr, dalpha)`` in plain PyTorch ops
    at a given selection and stored output ``out``: the conv-output
    cotangent is built from the pooled output's (``g``) and the moments'
    (``gs``, ``gq``; ``None``: no moments) cotangents, scaled by the slope where ``code`` (``phase |
    negative << 2``, the kernels' selection code) says negative, and put at
    the selected phase; rounded to bfloat16 for the two products under
    bfloat16 ``x``, as the plain version rounds it; then
    ``torch.nn.grad.conv2d_input`` / ``conv2d_weight``.  ``dalpha`` sums
    the selected conv value (the plain version's float32 convolution) times
    the cotangent over the negative selections.  Gradients in each
    argument's type, as autograd returns them."""
    wq, aq = _rounded(x, w, alpha)
    b, c_in, h, win = x.shape
    c_out = w.shape[1]
    h2, w2 = h // 2, win // 2
    gt = g.float()
    if gs is not None:
        gt = gt + gs.float()[:, None, None] + 2 * out.float() * gq.float()[:, None, None]
    neg = code >= 4
    sel = (code & 3).long()
    pooled_d = torch.where(neg, aq * gt, gt)
    d = torch.zeros((b, c_out, h, win), dtype=torch.float32, device=x.device)
    weight = _weight(wq, c_in, c_out)
    conv = F.conv2d(x.float(), weight, padding=1) + corr.float()
    conv_sel = torch.zeros_like(gt)
    for ph in range(4):
        at = (slice(None), slice(None), slice(ph >> 1, 2 * h2, 2), slice(ph & 1, 2 * w2, 2))
        d[at] = torch.where(sel == ph, pooled_d, 0.0)
        conv_sel = torch.where(sel == ph, conv[at], conv_sel)
    dr = d.to(torch.bfloat16).float() if x.dtype == torch.bfloat16 else d
    dx = torch.nn.grad.conv2d_input(x.shape, weight, dr, padding=1)
    dw = torch.nn.grad.conv2d_weight(x.float(), weight.shape, dr, padding=1)
    dw = dw.permute(2, 3, 1, 0).reshape(9 * c_in, c_out)
    dalpha = torch.where(neg, conv_sel * gt, 0.0).sum().reshape(1)
    return (dx.to(x.dtype), dw.to(w.dtype), d.sum(dim=0).to(corr.dtype),
            dalpha.to(alpha.dtype))


class _FusedConv2(torch.autograd.Function):
    """The CUDA kernels: forward (with code and moments when needed) and
    backward (``dx``, ``dw``, ``dcorr``, ``dalpha``)."""

    @staticmethod
    def forward(ctx, x, w, corr, alpha, want_stats: bool):
        wq, aq = _rounded(x, w, alpha)
        wq, aq = wq.contiguous(), aq.contiguous()
        c32 = corr.float().contiguous()
        want_code = any(ctx.needs_input_grad[:4])
        out, code, s, q = fused_conv2_cuda.forward(x, wq, c32, aq, want_code, want_stats)
        if want_code:
            ctx.save_for_backward(x, wq, c32, aq, out, code)
            ctx.arg_dtypes = (w.dtype, corr.dtype, alpha.dtype)
            ctx.want_stats = want_stats
        return out, s, q

    @staticmethod
    def backward(ctx, g, gs, gq):
        x, wq, c32, aq, out, code = ctx.saved_tensors
        if ctx.want_stats:
            gs, gq = gs.float().contiguous(), gq.float().contiguous()
        else:
            gs = gq = None
        dx, dw, dcorr, da = fused_conv2_cuda.backward(
            x, wq, c32, aq, g.contiguous(), out, code, gs, gq,
            need_dx=ctx.needs_input_grad[0],
        )
        wt, ct, at = ctx.arg_dtypes
        return dx, dw.to(wt), dcorr.to(ct), da.to(at), None


def _run(x, w, corr, alpha, want_stats: bool):
    if x.device.type == "cpu":
        if want_stats:
            return plain_conv2_prelu_pool_stats(x, w, corr, alpha)
        return plain_conv2_prelu_pool(x, w, corr, alpha), None, None
    return _FusedConv2.apply(x, w, corr, alpha, want_stats)


def _conv2_cuda(x, w, corr, alpha) -> torch.Tensor:
    """The forward kernel without code or moments: ``_FusedConv2`` in eval."""
    wq, aq = _rounded(x, w, alpha)
    out = fused_conv2_cuda.forward(
        x, wq.contiguous(), corr.float().contiguous(), aq.contiguous(), False, False)
    return out[0]


def _conv2_fake(x, w, corr, alpha) -> torch.Tensor:
    b, _, h, win = x.shape
    return x.new_empty((b, w.shape[1], h // 2, win // 2))


_CONV2_OP = library.register(
    "fused_conv2_prelu_pool", "(Tensor x, Tensor w, Tensor corr, Tensor alpha) -> Tensor",
    cpu=plain_conv2_prelu_pool, cuda=_conv2_cuda, fake=_conv2_fake)


def fused_conv2_prelu_pool(x, w, corr, alpha) -> torch.Tensor:
    """``[B, Cin, H, W] x [9*Cin, Cout] x [Cout, H, W] x [1] -> [B, Cout,
    H//2, W//2]`` fused block; the op ``adfd::fused_conv2_prelu_pool`` where
    no gradient is needed."""
    if library.needs_grad(x, w, corr, alpha):
        return _run(x, w, corr, alpha, False)[0]
    return _CONV2_OP(x, w, corr, alpha)


def fused_conv2_prelu_pool_stats(x, w, corr, alpha):
    """Like :func:`fused_conv2_prelu_pool`, also returning the float32
    per-channel ``(sum, sumsq)`` of the output."""
    return _run(x, w, corr, alpha, True)
