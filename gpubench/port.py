"""The program under test, reached through its own entry points.

The only module of the harness, with ``program/<config>.py``, that imports
the port (``audiodeepfake_detection_tpu_torch``): its transforms and
normalization pass (``train/transforms.py``), its optimizer and train step
(``train/steps.py``), its micro-batching service (``train/serve.py``) and
the kernels' launch counters.
"""

from __future__ import annotations

import importlib

import torch

from audiodeepfake_detection_tpu_torch.train.serve import ScoringService
from audiodeepfake_detection_tpu_torch.train.steps import make_optimizer, make_train_step
from audiodeepfake_detection_tpu_torch.train.transforms import (
    compute_normalization,
    make_transform,
    normalized_transform,
)
from audiodeepfake_detection_tpu_torch.utils.config import default_config

from gpubench import cells

OPS = "audiodeepfake_detection_tpu_torch.ops."


def model(cfg: dict, device, train: bool) -> torch.nn.Module:
    """The port's model for the configuration, built on ``device`` (its
    own initial weights are drawn there, and overwritten by the caller's)."""
    with torch.device(device):
        return cells.program_module(cfg["name"]).build(cfg).train(train)


def shapes(net: torch.nn.Module) -> dict:
    """The model's state dict as ``name -> (shape, dtype)``."""
    return {n: (tuple(t.shape), t.dtype) for n, t in net.state_dict().items()}


def transform(cfg: dict):
    """The port's transform (``make_transform``) of the configuration."""
    args = default_config()
    args.update(cfg["transform"])
    args.update(sample_rate=cfg["sample_rate"])
    return make_transform(args)


def normalization(cfg: dict, audio: torch.Tensor, block: int):
    """The program's Welford mean and std of ``audio``'s images."""
    return compute_normalization(transform(cfg), audio.split(block), cfg["image"][0],
                                 audio.device)


def normalized(cfg: dict, mean, std):
    return normalized_transform(transform(cfg), mean, std)


def train_step(cfg: dict, net: torch.nn.Module, mean, std):
    """``(step, optimizer)``: the port's Adam and ``make_train_step``."""
    opt = cfg["optimizer"]
    optimizer = make_optimizer(net.parameters(), opt["learning_rate"], opt["weight_decay"])
    return make_train_step(net, normalized(cfg, mean, std), optimizer), optimizer


def service(cfg: dict, mix: dict, net: torch.nn.Module, mean, std, device) -> ScoringService:
    """The port's ``ScoringService`` (its warm-up dispatch included)."""
    return ScoringService(
        net, normalized(cfg, mean, std), device=device, sample_rate=cfg["sample_rate"],
        seconds=cfg["frame_samples"] / cfg["sample_rate"], batch_size=mix["batch_size"],
        max_wait_ms=mix["max_wait_ms"])


def counter(name: str) -> int:
    """A launch counter of the port's kernels, ``"<ops module>.<NAME>"``."""
    module, attr = name.rsplit(".", 1)
    return int(getattr(importlib.import_module(OPS + module), attr))
