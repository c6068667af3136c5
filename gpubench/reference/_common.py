"""What the plain references of every configuration share: products in
float32 or TF32, the loss, Adam, normalization statistics, the train steps
and the scorer.  Plain PyTorch; nothing here imports the program.

Every product (convolution, matrix product) goes through :func:`conv2d`,
:func:`conv1d`, :func:`linear` or :func:`matmul`: in float32 with TF32 off,
or, for the control, with both operands rounded to TF32 (10 mantissa bits,
to nearest) and float32 sums, as the tensor cores' TF32 mode computes;
in the backward the products' incoming gradient is rounded as well, so
they too take TF32 operands.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

#: ``torch.optim.Adam``'s defaults, which the configurations keep
BETAS = (0.9, 0.999)
EPS = 1e-8
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


@contextlib.contextmanager
def float32_products():
    """TF32 off for cuDNN and cuBLAS while the reference runs."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & -0x2000
    return i.view(torch.float32)


class _Operand(torch.autograd.Function):
    """A product's operand in TF32; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Product(torch.autograd.Function):
    """A product's result as it is; the gradient it receives in TF32."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


def _tf32(tf32: bool, fn, *operands, **kw):
    if not tf32:
        return fn(*operands, **kw)
    a, b, *rest = operands
    return _Product.apply(fn(_Operand.apply(a), _Operand.apply(b), *rest, **kw))


def conv2d(x, w, b=None, tf32=False, **kw):
    return _tf32(tf32, F.conv2d, x, w, b, **kw)


def conv1d(x, w, tf32=False, **kw):
    return _tf32(tf32, F.conv1d, x, w, **kw)


def linear(x, w, b=None, tf32=False):
    return _tf32(tf32, F.linear, x, w, b)


def matmul(a, b, tf32=False):
    return _tf32(tf32, torch.matmul, a, b)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of the class ``labels != 0``."""
    y = (labels != 0).long()
    return (torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]).mean()


def trainable(state: Dict[str, torch.Tensor]) -> List[str]:
    return [n for n in state if not n.endswith(BUFFERS)]


def norm_stats(images: Callable[[int], torch.Tensor], blocks: int):
    """Per-channel mean and population std of ``images(i)`` for every
    block ``i``, summed in float64."""
    total = total_sq = count = 0
    for i in range(blocks):
        x = images(i).double()
        dims = [d for d in range(x.ndim) if d != 1]
        total = total + x.sum(dims)
        total_sq = total_sq + (x * x).sum(dims)
        count += x.numel() // x.shape[1]
    mean = total / count
    std = (total_sq / count - mean * mean).clamp_min(0).sqrt()
    return mean.float(), std.float()


def normalize(image: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    shape = (1, -1) + (1,) * (image.ndim - 2)
    return (image - mean.reshape(shape)) / std.reshape(shape)


def train_steps(forward, transform, state: Dict[str, torch.Tensor], batches: Sequence,
                mean, std, lr: float, wd: float, tf32: bool = False) -> dict:
    """Adam steps (L2 weight decay in the gradient, as ``torch.optim.Adam``)
    from ``state`` over ``batches`` of ``(audio, labels)``.

    Returns each step's loss, each trainable leaf's norm of the first
    gradient as the optimizer takes it (``grad + wd * p``) and of its change
    over all the steps."""
    names = trainable(state)
    params = {n: state[n].detach().clone().requires_grad_(True) for n in names}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    buffers = {n: t for n, t in state.items() if n not in params}
    b1, b2 = BETAS
    losses, first = [], {}
    with float32_products():
        for step, (audio, labels) in enumerate(batches, start=1):
            with torch.no_grad():
                image = normalize(transform(audio, tf32), mean, std)
            loss = cross_entropy(forward({**buffers, **params}, image, True, tf32), labels)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                c1, c2 = 1 - b1 ** step, 1 - b2 ** step
                for n, g in zip(names, grads):
                    p = params[n]
                    g = g + wd * p
                    if step == 1:
                        first[n] = float(g.norm())
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = v[n].sqrt() / math.sqrt(c2) + EPS
                    p.addcdiv_(m[n], denom, value=-lr / c1)
    change = {n: float((params[n].detach() - state[n]).norm()) for n in names}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def scores(forward, transform, state, frames: torch.Tensor, mean, std, block: int,
           tf32: bool = False) -> torch.Tensor:
    """``P(fake)`` of each frame ``[n, 1, T]``, in blocks of ``block``."""
    out = []
    with torch.no_grad(), float32_products():
        for part in frames.split(block):
            image = normalize(transform(part, tf32), mean, std)
            out.append(torch.softmax(forward(state, image, False, tf32), -1)[:, 1])
    return torch.cat(out)


def log_power(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x * x + 1e-12)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
