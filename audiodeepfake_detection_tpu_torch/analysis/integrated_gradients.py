"""Integrated-gradients attribution, batched over the interpolation path.

Counterpart of ``audiodeepfake_detection_tpu/analysis/integrated_gradients.py``
(reference: the TF-tutorial port in src/audiofakedetect/
integrated_gradients.py:13-138 and train_classifier.py:576-844): alphas in
``linspace(0, 1, m_steps+1)``, gradients of ``softmax(logits)[target]``
with respect to the interpolated images, trapezoid integral, scaled by
``image - baseline``; running means over up to 2500 samples per target
saved as ``.npy``.

The JAX function vmaps ``jax.grad`` over ``m_steps + 1`` batch-1
applications.  Here the whole path is one batch: one eval-mode forward of
``[m_steps + 1, C, F, T]`` and one ``torch.autograd.grad`` of
``softmax(logits)[:, target].sum()``.  The two are equal because a model in
eval mode treats the rows of a batch independently (BatchNorm's running
statistics, no dropout), which :func:`integrated_grad` checks.  A fused
block that runs in eval (``"always"``) takes its kernel forward and its
``dx`` backward on this path; the DCNN's fused first block has no input
gradient, which ``train.experiment`` guards.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..data.frame_cache import rank_and_world
from ..data.loader import batch_to_device
from ..train.steps import audio_to_float


class Mean:
    """Running mean accumulator (reference integrated_gradients.py:13-47).

    API-parity port, not used by :func:`run_integrated_gradients` (which
    keeps sums on the device).  Contract inherited from the reference:
    ``finalize`` averages over axis 0 *and* divides by the update count,
    so it returns the per-sample mean only when every ``update`` receives a
    ``[1, ...]`` singleton batch, as the reference trainer feeds it.
    """

    def __init__(self) -> None:
        self.count = 0
        self.mean: Optional[np.ndarray] = None

    def update(self, batch_vals: np.ndarray) -> None:
        batch_vals = np.asarray(batch_vals)
        if self.mean is None:
            self.mean = np.zeros_like(batch_vals, dtype=np.float32)
        self.count += 1
        self.mean += batch_vals

    def finalize(self) -> np.ndarray:
        if self.mean is None:
            raise ValueError("Mean.finalize before any update")
        return np.mean(self.mean, axis=0).squeeze() / self.count


def interpolate_images(
    baseline: torch.Tensor, image: torch.Tensor, alphas: torch.Tensor
) -> torch.Tensor:
    """Linear interpolation along the attribution path."""
    a = alphas.reshape(-1, *([1] * image.ndim))
    return baseline[None] + a * (image[None] - baseline[None])


def integral_approximation(gradients: torch.Tensor) -> torch.Tensor:
    """Riemann trapezoid over the alpha axis."""
    grads = (gradients[:-1] + gradients[1:]) / 2.0
    return torch.mean(grads, dim=0)


def integrated_grad(
    model: nn.Module,
    image: torch.Tensor,
    target_class_idx: int,
    m_steps: int = 200,
) -> torch.Tensor:
    """Integrated gradients for one image ``[C, F, T]`` on its device."""
    if model.training:
        raise ValueError(
            "integrated_grad batches the interpolation path, which equals "
            "per-image gradients only in eval mode (model.eval())"
        )
    baseline = torch.zeros_like(image)
    alphas = torch.linspace(0.0, 1.0, m_steps + 1, dtype=image.dtype, device=image.device)
    path = interpolate_images(baseline, image.detach(), alphas).requires_grad_(True)
    with torch.enable_grad():
        probs = torch.softmax(model(path), dim=-1)[:, int(target_class_idx)]
        (grads,) = torch.autograd.grad(probs.sum(), path)
    return (image - baseline) * integral_approximation(grads)


def run_integrated_gradients(
    trainer,
    model_file: str = "ig",
    times_per_target: Optional[int] = None,
) -> None:
    """Accumulate mean attributions over the cross test set and save ``.npy``.

    The reference's target bookkeeping (train_classifier.py:678-844): with
    ``args.target`` unset both classes are accumulated up to ``times``
    samples each.  The sums stay on the device and are fetched once.
    """
    args = trainer.args
    plot_path = args.log_dir + "/plots/"
    os.makedirs(plot_path, exist_ok=True)
    if trainer.cross_loader_test is None:
        raise RuntimeError(
            "integrated gradients need the cross test set: pass "
            "--cross-data-path (cross_loader_test is None)."
        )

    both = args.target is None
    try:
        target_value = int(args.target) if args.target is not None else 1
    except ValueError:
        target_value = 1
    times = times_per_target or args.ig_times_per_target or 2500
    index = index_0 = index_1 = 0
    m_steps = 200

    model = trainer.model
    was_training = model.training
    model.eval()
    ig_sum = sal_sum = last_image = None

    def eligible(c_label: int) -> bool:
        if not both:
            return c_label == target_value and index < times
        if c_label == 0:
            return index_0 < times
        return index_1 < times

    try:
        for batch in trainer.cross_loader_test.epoch(0, shuffle=False):
            labels = (np.asarray(batch["label"]) != 0).astype(np.int64)
            weight = np.asarray(batch.get("weight", np.ones(len(labels))))
            wanted = [
                i
                for i in range(len(labels))
                if weight[i] != 0 and eligible(int(labels[i]))
            ]
            if not wanted:  # no transform for a batch with nothing to attribute
                if both and index_0 >= times and index_1 >= times:
                    break
                if not both and index >= times:
                    break
                continue
            audio = batch_to_device({"audio": batch["audio"]}, trainer.device)["audio"]
            with torch.no_grad():
                images = trainer.transform(audio_to_float(audio))
            for i in wanted:
                c_label = int(labels[i])
                if not eligible(c_label):  # quota may fill mid-batch
                    continue
                attributions = integrated_grad(model, images[i], c_label, m_steps=m_steps)
                mask = torch.sum(attributions, dim=0)[None]
                ig_sum = mask if ig_sum is None else ig_sum + mask
                sal_sum = images[i] if sal_sum is None else sal_sum + images[i]
                last_image = images[i]
                if c_label == 0:
                    index_0 += 1
                else:
                    index_1 += 1
                index += 1
            if both and index_0 >= times and index_1 >= times:
                break
            if not both and index >= times:
                break
    finally:
        model.train(was_training)

    print("index 0 ", index_0)
    print("index 1 ", index_1)
    print("index ", index)
    if ig_sum is None:
        print("no samples matched the attribution targets")
        return
    mean_ig = np.mean(ig_sum.cpu().numpy(), axis=0).squeeze() / index
    mean_sal = np.mean(sal_sum.cpu().numpy(), axis=0).squeeze() / index

    # several processes each accumulate over their loader shard, as the
    # reference does per rank; only the first writes (concurrent saves to
    # one path would tear)
    if rank_and_world()[0] != 0:
        return
    target_str = "01" if both else str(target_value)
    path = (
        plot_path
        + model_file.replace("/", "_")
        + "_"
        + "-".join(args.cross_sources)
        + f"x{times}_target-{target_str}"
    )
    np.save(path + "_integrated_gradients.npy", mean_ig)
    np.save(path + "_mean_images.npy", np.squeeze(mean_sal))
    np.save(path + "_last_image.npy", np.squeeze(last_image.cpu().numpy()))
