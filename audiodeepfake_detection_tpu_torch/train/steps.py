"""Train / eval steps: transform + model + loss + optimizer.

Counterpart of ``audiodeepfake_detection_tpu/train/steps.py``.  The JAX
package compiles one pure function over an immutable state; here the state
lives where PyTorch keeps it -- the ``nn.Module``'s parameters and buffers
and the optimizer -- and a step updates it in place.  A step enqueues its
kernels and returns device tensors: nothing inside it waits for the device.

Optimizer parity: ``torch.optim.Adam(lr, weight_decay=wd)`` adds the L2 term
to the gradient of every parameter before the moment updates, which is the
JAX package's ``add_decayed_weights -> scale_by_adam -> scale(-lr)`` chain.
With ``adam_moments_dtype="bfloat16"`` the optimizer is
:class:`AdamLowPrecisionMoments`, the JAX package's ``scale_by_adam_lowp``.

The device-resident variants (``make_resident_*``) are Python loops over
the same step bodies where the JAX package runs a ``lax.scan``: G steps
over frames that live on the device (``train/device_data.py``) take only
a ``[G, B]`` index block from the host, and evolve exactly as G single
steps.  The JAX package's chained steps over a streamed ``[G, B, ...]``
batch (``make_multi_*``) are not ported: here they would be the same G
steps after one larger copy, and ``device_prefetch`` already overlaps each
batch's copy with the step before.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
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


class AdamLowPrecisionMoments(torch.optim.Optimizer):
    """Adam with both moments *stored* in ``moment_dtype`` (bfloat16).

    The JAX package's ``add_decayed_weights -> scale_by_adam_lowp ->
    scale(-lr)`` (its steps.py): the L2 term is added to the gradient, and
    every step computes in float32 from the stored, already rounded
    moments::

        m = round(b1 * m + (1 - b1) * g);  v = round(b2 * v + (1 - b2) * g * g)
        p -= lr * (m / c1) / (sqrt(v / c2) + eps)

    so the trajectory is a function of the stored state alone and a
    ``--resume`` through ``state_dict()`` is bit-invisible.  The state keys
    are ``torch.optim.Adam``'s (``step``, ``exp_avg``, ``exp_avg_sq``).
    """

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps))
        self.moment_dtype = moment_dtype

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=self.moment_dtype)
                state["step"] += 1  # a host tensor, as torch.optim.Adam keeps it
                # the bias corrections in float32, as jnp.power(f32(b), count)
                count = np.float32(state["step"].item())
                c1 = float(np.float32(1) - np.float32(b1) ** count)
                c2 = float(np.float32(1) - np.float32(b2) ** count)
                g = p.grad.float() + group["weight_decay"] * p.float()
                m = (b1 * state["exp_avg"].float() + (1.0 - b1) * g).to(self.moment_dtype)
                v = (b2 * state["exp_avg_sq"].float() + (1.0 - b2) * g * g).to(
                    self.moment_dtype)
                state["exp_avg"], state["exp_avg_sq"] = m, v
                update = (m.float() / c1) / ((v.float() / c2).sqrt() + group["eps"])
                p.add_((update * -group["lr"]).to(p.dtype))
        return loss

    def load_state_dict(self, state_dict) -> None:
        # torch casts loaded state to each parameter's type: store the
        # moments in their own type again
        super().load_state_dict(state_dict)
        for state in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key] = state[key].to(self.moment_dtype)


def make_optimizer(
    params,
    learning_rate: float,
    weight_decay: float,
    moment_dtype: Optional[str] = None,
) -> torch.optim.Optimizer:
    """The reference's ``torch.optim.Adam(lr, weight_decay)`` (L2 in the
    gradient, on every parameter) with float32 moments, or with
    ``moment_dtype="bfloat16"`` the same update from bf16-stored moments
    (:class:`AdamLowPrecisionMoments`)."""
    kind = str(moment_dtype or "float32")
    if kind == "bfloat16":
        return AdamLowPrecisionMoments(params, learning_rate, weight_decay)
    if kind != "float32":
        raise ValueError(f"adam_moments_dtype must be float32 or bfloat16: {moment_dtype!r}")
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
        labels = (batch["label"] != 0).long()
        with torch.no_grad():
            audio = audio_to_float(batch["audio"])
            if aug_contrast or aug_noise:
                audio = augment(generator, audio, aug_contrast, aug_noise)
            image = transform(audio)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = forward_backward(model, params, image, labels, grad_accum)
        optimizer.step()
        return {"loss": loss, "acc": acc}

    return train_step


def forward_backward(model: nn.Module, params, image: torch.Tensor, labels: torch.Tensor,
                     grad_accum: int = 1):
    """The train step's model part: forward in train mode, cross-entropy,
    gradients into ``params``' ``.grad`` (the mean over ``grad_accum``
    microbatches); returns the detached loss and the accuracy."""
    model.train()
    if grad_accum <= 1:
        out = model(image)
        loss = F.cross_entropy(out, labels)
        loss.backward()
        return loss.detach(), (out.argmax(-1) == labels).float().mean()
    b = image.shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
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
    return loss * inv, correct / b


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
            return eval_results(model(transform(audio)), batch)

    return eval_step


def eval_results(out: torch.Tensor, batch: Batch) -> Batch:
    """The eval step's results from the logits ``out [B, 2]`` of ``batch``."""
    labels = batch["label"].long()
    weight = batch.get("weight")
    if weight is None:
        weight = torch.ones(labels.shape, device=labels.device)
    weight = weight.float()
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


def stack_results(results: List[Batch]) -> Batch:
    """Stack per-step result dicts into one dict of ``[G, ...]`` tensors."""
    return {k: torch.stack([r[k] for r in results]) for k in results[0]}


def stack_batches(batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack same-shape host batches into one ``[G, ...]`` batch."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def make_resident_multi_train_step(
    model: nn.Module,
    transform: Callable[[torch.Tensor], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    aug_contrast: bool = False,
    aug_noise: bool = False,
    grad_accum: int = 1,
    generator: Optional[torch.Generator] = None,
) -> Callable[..., Batch]:
    """G optimizer steps over device-resident frames:
    ``(audio_all [N, 1, T], labels_all [N], idx [G, B]) -> stats [G]``.

    Each step gathers its batch on the device (``index_select`` with its
    row of ``idx``) and runs :func:`make_train_step`'s step, so only the
    index block crosses from the host."""
    step = make_train_step(model, transform, optimizer, aug_contrast, aug_noise,
                           grad_accum, generator)

    def multi_step(audio_all: torch.Tensor, labels_all: torch.Tensor,
                   idx: torch.Tensor) -> Batch:
        return stack_results([
            step({"audio": audio_all.index_select(0, row),
                  "label": labels_all.index_select(0, row)})
            for row in idx
        ])

    return multi_step


def make_resident_multi_eval_step(
    model: nn.Module,
    transform: Callable[[torch.Tensor], torch.Tensor],
) -> Callable[..., Batch]:
    """A whole eval pass over device-resident frames:
    ``(audio_all, labels_all, idx [n_batches, B]) -> results [n_batches, ...]``.

    ``-1`` entries of ``idx`` pad the last batch: their gather index is
    clamped to 0 and they become zero-weight rows, as in the JAX step; the
    host masks their row outputs by the same ``idx >= 0``."""
    step = make_eval_step(model, transform)

    def multi_eval(audio_all: torch.Tensor, labels_all: torch.Tensor,
                   idx: torch.Tensor) -> Batch:
        results = []
        for row in idx:
            safe = row.clamp(min=0)
            results.append(step({
                "audio": audio_all.index_select(0, safe),
                "label": labels_all.index_select(0, safe),
                "weight": (row >= 0).float(),
            }))
        return stack_results(results)

    return multi_eval
