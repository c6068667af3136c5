"""GPipe pipeline parallelism (SPMD) over the AST encoder.

Counterpart of ``audiodeepfake_detection_tpu/parallel/pipeline.py``, with
its schedule as it is: on a ``("data", "stage")`` mesh every rank runs the
same program on its stage's ``depth / S`` blocks (:func:`stage_blocks`),
``M`` microbatches flow through ``S`` stages in ``M + S - 1`` ticks, stage
0 injects microbatch ``t``, the last stage collects microbatch ``t - (S -
1)``, every stage runs its blocks on every tick (the bubble ticks too, as
in JAX's scan), and the state moves stage -> stage + 1 between ticks.  The
collected buffer leaves the last stage by a masked sum.  The bubble is the
usual ``(S - 1) / (M + S - 1)``.

Built from collectives that gloo runs on CUDA tensors as well as NCCL
(``tools/dist_probe.py``): point-to-point aborts the sender under gloo on
the card's machine, so ``torch.distributed.pipelining`` cannot run there.
JAX's ``ppermute`` is a ring shift whose forward is an
``all_gather_into_tensor`` over ``"stage"`` taking slot ``(s - 1) mod S``
and whose backward shifts the other way; its masked ``psum`` is
``reduce_from_ranks`` (the sum forward; each rank's own cotangent
backward, since every rank computes the loss from it).

Stage roles are masks (``torch.where`` on the stage id), never branches:
every rank records the same autograd graph, so the backward's collectives
pair up in the same order on every rank.  Parameters stay in the
replicated checkpoint layout on every rank; each rank computes its own
blocks only.  After the backward the gradients combine: the blocks' and
the embedding's (non-zero on stage 0 only) are summed over ``"stage"``,
the head's (the same on every stage) counted once, and all of them
averaged over ``"data"``; the optimizer then runs the same on every rank,
and the ranks stay bit-equal.  The blocks run deterministically, dropout
off (JAX's block applier runs them with ``train=False``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import all_reduce_grads, mesh_group, mesh_rank, mesh_size, reduce_from_ranks

Batch = Dict[str, torch.Tensor]


def stage_blocks(model: nn.Module, mesh, stage_axis: str = "stage") -> range:
    """This rank's stage's contiguous range of the encoder's blocks (JAX
    ``stack_block_params`` with the stage sharding)."""
    depth, stages = len(model.v.blocks), mesh_size(mesh, stage_axis)
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by {stages} stages")
    per = depth // stages
    s = mesh_rank(mesh, stage_axis)
    return range(s * per, (s + 1) * per)


class _RingShift(torch.autograd.Function):
    """Stage ``s`` takes stage ``s - 1``'s tensor (mod S); the cotangent
    goes back from ``s + 1``."""

    @staticmethod
    def forward(ctx, x, group, stage: int, stages: int):
        ctx.group, ctx.stage, ctx.stages = group, stage, stages
        return _gather(x, group, stages)[(stage - 1) % stages]

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.stages)[(ctx.stage + 1) % ctx.stages], None, None, None


def _gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``[size, *x.shape]``: every rank's ``x``, in rank order."""
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.unflatten(0, (size, x.shape[0]))


@contextlib.contextmanager
def _deterministic(model: nn.Module, blocks: range):
    """The stage's blocks in eval mode for the duration (no dropout)."""
    modes = [model.v.blocks[i].training for i in blocks]
    for i in blocks:
        model.v.blocks[i].train(False)
    try:
        yield
    finally:
        for i, mode in zip(blocks, modes):
            model.v.blocks[i].train(mode)


def pipeline_encode(model: nn.Module, tokens: torch.Tensor, mesh, n_microbatches: int,
                    stage_axis: str = "stage", data_axis: Optional[str] = None) -> torch.Tensor:
    """The AST encoder as an S-stage GPipe pipeline over ``mesh``.

    ``tokens``: this rank's ``[b, N, D]`` embedded tokens, its data row's
    share of the batch (the same on each stage of the row); returns the
    encoded tokens of the whole share on every stage."""
    stages, stage = mesh_size(mesh, stage_axis), mesh_rank(mesh, stage_axis)
    b = tokens.shape[0]
    # divisibility holds per data shard: each data row carries
    # batch / mesh[data_axis] rows, which must split into n_microbatches
    data_n = mesh_size(mesh, data_axis) if data_axis else 1
    if b % n_microbatches:
        raise ValueError(
            f"per-shard batch {b} (= {b * data_n} / data {data_n}) "
            f"not divisible by n_microbatches {n_microbatches}")
    blocks = stage_blocks(model, mesh, stage_axis)
    group = mesh_group(mesh, stage_axis)
    m = n_microbatches
    mbs = tokens.unflatten(0, (m, b // m))
    first = torch.tensor(stage == 0, device=tokens.device)
    last = torch.tensor(stage == stages - 1, device=tokens.device)
    state = torch.zeros_like(mbs[0])
    collected = []
    with _deterministic(model, blocks):
        for t in range(m + stages - 1):
            # stage 0 injects microbatch t (clamped: a later one is never
            # collected)
            state = torch.where(first, mbs[min(t, m - 1)], state)
            state = model.encode(state, blocks)
            if t >= stages - 1:  # the last stage holds microbatch t - (S - 1)
                collected.append(torch.where(last, state, torch.zeros_like(state)))
            if t < m + stages - 2:  # the last tick's shift reaches no one
                state = _RingShift.apply(state, group, stage, stages)
    # valid on the last stage only: the masked sum hands it to every stage
    return reduce_from_ranks(torch.cat(collected), group)


def pp_ast_logits(model: nn.Module, x: torch.Tensor, mesh, n_microbatches: int,
                  stage_axis: str = "stage", data_axis: Optional[str] = None) -> torch.Tensor:
    """The AST's logits with the encoder pipelined: ``embed`` and
    ``classify`` on every rank, the blocks over the stages.  ``x``: this
    rank's data row's ``[b, 1, F, T]`` images."""
    h = pipeline_encode(model, model.embed(x), mesh, n_microbatches, stage_axis, data_axis)
    return model.classify(h)


def _head_params(model: nn.Module):
    return [*model.v.norm.parameters(), *model.mlp_head.parameters()]


def combine_pp_grads(model: nn.Module, mesh, stage_axis: str = "stage",
                     data_axis: Optional[str] = None) -> None:
    """The gradients after a pipelined backward made whole: summed over the
    stages (each holds its own blocks', stage 0 the embedding's; the head's
    counted once, from the last stage), then averaged over ``data_axis``."""
    if mesh_rank(mesh, stage_axis) != mesh_size(mesh, stage_axis) - 1:
        for p in _head_params(model):
            if p.grad is not None:
                p.grad.zero_()
    params = list(model.parameters())
    all_reduce_grads(params, mesh, stage_axis, mean=False)
    if data_axis:
        all_reduce_grads(params, mesh, data_axis)


def _pp_forward_backward(model, image, labels, mesh, n_microbatches, stage_axis, data_axis):
    model.train()
    out = pp_ast_logits(model, image, mesh, n_microbatches, stage_axis, data_axis)
    loss = F.cross_entropy(out, labels)
    loss.backward()
    combine_pp_grads(model, mesh, stage_axis, data_axis)
    return loss.detach(), (out.argmax(-1) == labels).float().mean()


def make_pp_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, mesh,
                       n_microbatches: int, stage_axis: str = "stage",
                       data_axis: Optional[str] = None) -> Callable[[Batch], Batch]:
    """CE-loss train step over the pipelined AST (JAX
    ``make_pp_train_step``): ``{"image" [b, 1, F, T], "label" [b]} ->
    {"loss", "acc"}``, this rank's data row's share of the batch."""

    def step(batch: Batch) -> Batch:
        labels = (batch["label"] != 0).long()
        optimizer.zero_grad(set_to_none=True)
        loss, acc = _pp_forward_backward(model, batch["image"], labels, mesh, n_microbatches,
                                         stage_axis, data_axis)
        optimizer.step()
        return {"loss": loss, "acc": acc}

    return step


def make_pp_trainer_step(model: nn.Module, transform: Callable, optimizer: torch.optim.Optimizer,
                         mesh, n_microbatches: int, stage_axis: str = "stage",
                         data_axis: Optional[str] = "data", aug_contrast: bool = False,
                         aug_noise: bool = False,
                         generator: Optional[torch.Generator] = None) -> Callable[[Batch], Batch]:
    """The Trainer's step with the encoder pipelined (JAX
    ``_pp_trainer_step_body``): ``train.steps.make_train_step``'s audio in,
    augmentation and transform, the pipelined loss and backward, the
    combined gradients, the optimizer.  Augmentation draws from
    ``generator``, which every stage of a data row seeds alike."""
    from ..ops.audio import augment
    from ..train.steps import audio_to_float

    if (aug_contrast or aug_noise) and generator is None:
        raise ValueError("augmentation needs a torch.Generator")

    def step(batch: Batch) -> Batch:
        labels = (batch["label"] != 0).long()
        with torch.no_grad():
            audio = audio_to_float(batch["audio"])
            if aug_contrast or aug_noise:
                audio = augment(generator, audio, aug_contrast, aug_noise)
            image = transform(audio)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = _pp_forward_backward(model, image, labels, mesh, n_microbatches,
                                         stage_axis, data_axis)
        optimizer.step()
        return {"loss": loss, "acc": acc}

    return step
