"""Train / eval steps: transform + model + loss + optimizer.

Counterpart of ``audiodeepfake_detection_tpu/train/steps.py``.  The JAX
package compiles one pure function over an immutable state; here the state
lives where PyTorch keeps it -- the ``nn.Module``'s parameters and buffers
and the optimizer -- and a step updates it in place.  A step enqueues its
kernels and returns device tensors: nothing inside it waits for the device.

Optimizer parity: ``torch.optim.Adam(lr, weight_decay=wd)`` adds the L2 term
to the gradient of every parameter before the moment updates, which is the
JAX package's ``add_decayed_weights -> scale_by_adam -> scale(-lr)`` chain.

Not ported yet: bf16 Adam moments (``adam_moments_dtype``, slice 5) and the
chained / device-resident variants (``make_multi_*``, ``make_resident_*``,
slice 8).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.audio import augment

MAX_LABELS = 32  # dense per-label metric vector size (labels are A..N -> <14)

Batch = Dict[str, torch.Tensor]


def audio_to_float(audio: torch.Tensor) -> torch.Tensor:
    """Accept float audio or raw int16 PCM (scale 1/32768) batches.

    Loaders and the pcm16 serving wire may ship int16 frames (half the
    host-to-device bytes); the conversion runs on the device.
    """
    if not torch.is_floating_point(audio):
        return audio.to(torch.float32) * (1.0 / 32768.0)
    return audio


def make_optimizer(
    params,
    learning_rate: float,
    weight_decay: float,
    moment_dtype: Optional[str] = None,
) -> torch.optim.Adam:
    """The reference's ``torch.optim.Adam(lr, weight_decay)`` (L2 in the
    gradient, on every parameter), fp32 moments."""
    if moment_dtype is not None and str(moment_dtype) != "float32":
        raise NotImplementedError(
            f"adam_moments_dtype={moment_dtype!r} (low-precision Adam "
            "moments) is not ported yet (ROADMAP.md queue 1, slice 5: AST)"
        )
    return torch.optim.Adam(
        params, lr=learning_rate, weight_decay=weight_decay,
        betas=(0.9, 0.999), eps=1e-8,
    )


def make_train_step(
    model: nn.Module,
    transform: Callable[[torch.Tensor], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    aug_contrast: bool = False,
    aug_noise: bool = False,
    grad_accum: int = 1,
    generator: Optional[torch.Generator] = None,
) -> Callable[[Batch], Batch]:
    """Build the train step: ``batch -> {"loss", "acc"}`` (device scalars).

    ``batch``: ``audio [B, 1, T]`` (float or int16 PCM) and ``label [B]``
    on the model's device.  Augmentation draws from ``generator`` (on that
    device); dropout draws from the device's default generator.

    ``grad_accum > 1`` runs the batch as that many microbatches: the
    optimizer sees the mean of their gradients, BatchNorm normalises with
    per-microbatch moments and updates its running statistics once per
    microbatch (torch gradient-accumulation semantics, as in the JAX step).
    """
    if (aug_contrast or aug_noise) and generator is None:
        raise ValueError("augmentation needs a torch.Generator")
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(batch: Batch) -> Batch:
        model.train()
        labels = (batch["label"] != 0).long()
        with torch.no_grad():
            audio = audio_to_float(batch["audio"])
            if aug_contrast or aug_noise:
                audio = augment(generator, audio, aug_contrast, aug_noise)
            image = transform(audio)
        optimizer.zero_grad(set_to_none=True)
        if grad_accum <= 1:
            out = model(image)
            loss = F.cross_entropy(out, labels)
            loss.backward()
            loss = loss.detach()
            acc = (out.argmax(-1) == labels).float().mean()
        else:
            b = image.shape[0]
            if b % grad_accum:
                raise ValueError(
                    f"batch {b} not divisible by grad_accum {grad_accum}"
                )
            mb = b // grad_accum
            loss = torch.zeros((), device=image.device)
            correct = torch.zeros((), device=image.device)
            for img_mb, lab_mb in zip(image.split(mb), labels.split(mb)):
                out = model(img_mb)
                mb_loss = F.cross_entropy(out, lab_mb)
                mb_loss.backward()  # gradients add up across microbatches
                loss += mb_loss.detach()
                correct += (out.argmax(-1) == lab_mb).float().sum()
            inv = 1.0 / grad_accum
            torch._foreach_mul_([p.grad for p in params if p.grad is not None], inv)
            loss = loss * inv
            acc = correct / b
        optimizer.step()
        return {"loss": loss, "acc": acc}

    return train_step


def make_eval_step(
    model: nn.Module,
    transform: Callable[[torch.Tensor], torch.Tensor],
) -> Callable[[Batch], Batch]:
    """Build the eval step.

    Per-label statistics are dense ``[MAX_LABELS]`` count vectors (instead
    of the reference's Python dicts, train_classifier.py:453-459), so a
    loop over batches adds tensors and fetches once.  ``weight`` masks the
    padded tail entries of the final partial batch.
    """

    def eval_step(batch: Batch) -> Batch:
        model.eval()
        with torch.inference_mode():
            audio = audio_to_float(batch["audio"])
            labels = batch["label"].long()
            weight = batch.get("weight")
            if weight is None:
                weight = torch.ones(labels.shape, device=labels.device)
            weight = weight.float()
            out = model(transform(audio))
            out_max = out.argmax(-1)
            y = (labels != 0).long()
            ok = (out_max == y).float() * weight
            onehot = F.one_hot(labels, MAX_LABELS).float() * weight[:, None]
            return {
                "ok_per_label": (onehot * ok[:, None]).sum(0),
                "count_per_label": onehot.sum(0),
                "ok_sum": ok.sum(),
                "total": weight.sum(),
                "y": y,
                "out_max": out_max,
                "scores": torch.softmax(out, dim=-1)[:, 1],
                "ok_mask": ok > 0,
            }

    return eval_step
