"""Shallow linear-regression baseline (reference models.py:134-158).

Counterpart of ``audiodeepfake_detection_tpu/models/regression.py``.
"""

from __future__ import annotations

import torch
from torch import nn


class Regression(nn.Module):
    """``Linear(num_of_scales * 101, 2)`` + LogSoftmax over a flattened image.

    The input width is taken from the first batch (the JAX module infers it
    the same way), so one frame must pass through the model -- the factory's
    ``check_dimensions`` does that -- before its parameters are handed to an
    optimizer.
    """

    def __init__(self, nclasses: int = 2) -> None:
        super().__init__()
        self.linear = nn.LazyLinear(nclasses)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.linear(x.flatten(1)), dim=-1)

    def get_name(self) -> str:
        return "Regression"
