"""LCNN: max-feature-map CNN + BLSTM classifier (ASVspoof 2021 LA baseline).

Counterpart of ``audiodeepfake_detection_tpu/models/lcnn.py`` (reference:
src/audiofakedetect/models.py:68-131), built in the reference's own layout
so that ``state_dict()`` is the reference ``.pt``: ``lcnn`` is a
``nn.Sequential`` whose convolutions sit at indices 0, 3, 6, 10, 13, 16, 19,
22, 25 and whose ``BatchNorm2d(affine=False)`` at 5, 9, 12, 18, 21, 24;
``lstm.{0,1}.l_blstm`` are the two bidirectional LSTMs; ``fc`` is the head.

The input is the transform image ``[B, C, F, T]``; the model permutes time
onto the image's height first.  Four 2x2 pools leave ``[B, 32, T/16,
F/16]``; each time step's ``(32, F/16)`` values are flattened in that
order, go through the two BLSTMs (no skip connection, as in the JAX model)
and the head, and the logits are averaged over time.  ``lstm_channels`` is
the number of frequency rows the model is built for: the BLSTMs are
``(lstm_channels // 16) * 32`` wide.

``fused_layer1`` runs the first block (conv 5x5 + MaxFeatureMap + pool)
through ``ops/fused_conv1.py::fused_conv_mfm_pool``: ``True`` in training
only, ``"always"`` in eval too.  It reads the parameters of ``lcnn[0]`` (no
new ones, so every state dict loads either way) and needs one input
channel: asking for it with another count raises.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from ..ops.fused_conv1 import fused_conv_mfm_pool
from .layers import BLSTMLayer, MaxFeatureMap2D


def _bn_conv_mfm(cin: int, cout: int, k: int, padding: int):
    return [
        nn.BatchNorm2d(cin, affine=False),
        nn.Conv2d(cin, cout, k, padding=padding),
        MaxFeatureMap2D(),
    ]


class LCNN(nn.Module):
    """LCNN with 2D convolutions for audio deepfake detection."""

    def __init__(
        self,
        classes: int = 2,
        in_channels: int = 1,
        lstm_channels: int = 256,
        fused_layer1: Union[bool, str] = False,
        dropout: float = 0.7,
    ) -> None:
        super().__init__()
        if fused_layer1 not in (False, True, "always"):
            raise ValueError(
                f"fused_layer1 must be False, True or 'always': {fused_layer1!r}"
            )
        if fused_layer1 and in_channels != 1:
            raise ValueError(
                f"fused_layer1={fused_layer1!r} needs in_channels == 1 (the "
                f"fused block convolves one plane), got {in_channels}"
            )
        self.fused_layer1 = fused_layer1
        self.lstm_channels = lstm_channels
        self.feat = (lstm_channels // 16) * 32
        # indices as in the reference Sequential: 1, 4, 7, ... are the
        # MaxFeatureMap layers, 2, 8, 15, 27 the pools, 28 the dropout
        self.lcnn = nn.Sequential(
            nn.Conv2d(in_channels, 64, 5, padding=2),
            MaxFeatureMap2D(),
            nn.MaxPool2d(2, 2),
            nn.Conv2d(32, 64, 1),
            MaxFeatureMap2D(),
            *_bn_conv_mfm(32, 96, 3, 1),
            nn.MaxPool2d(2, 2),
            *_bn_conv_mfm(48, 96, 1, 0),
            *_bn_conv_mfm(48, 128, 3, 1),
            nn.MaxPool2d(2, 2),
            nn.Conv2d(64, 128, 1),
            MaxFeatureMap2D(),
            *_bn_conv_mfm(64, 64, 3, 1),
            *_bn_conv_mfm(32, 64, 1, 0),
            *_bn_conv_mfm(32, 64, 3, 1),
            nn.MaxPool2d(2, 2),
            nn.Dropout(dropout),
        )
        self.lstm = nn.Sequential(
            BLSTMLayer(self.feat, self.feat), BLSTMLayer(self.feat, self.feat)
        )
        self.fc = nn.Linear(self.feat, classes)

    def _fused_first_block(self, x: torch.Tensor) -> torch.Tensor:
        """``lcnn[0:3]`` through the fused block, then the rest of ``lcnn``.
        ``x``: ``[B, 1, T, F]``."""
        conv = self.lcnn[0]
        out = fused_conv_mfm_pool(
            x[:, 0].contiguous(),
            conv.weight.reshape(conv.out_channels, 25).t(),
            conv.bias,
        )
        x = out.permute(0, 3, 1, 2)  # the block stores NCHW: contiguous
        for layer in list(self.lcnn)[3:]:
            x = layer(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # [B, C, F, T] -> [B, C, T, F]: time on H (reference permute)
        x = x.permute(0, 1, 3, 2)
        if self.fused_layer1 and (self.training or self.fused_layer1 == "always"):
            x = self._fused_first_block(x)
        else:
            x = self.lcnn(x)
        # [B, 32, T', F'] -> [B, T', 32 * F']: per time step, channels major
        # and frequency minor (reference models.py:126-128)
        x = x.permute(0, 2, 1, 3).flatten(2)
        if x.shape[2] != self.feat:
            raise ValueError(
                f"the LCNN was built for lstm_channels={self.lstm_channels} "
                f"({self.feat} features per time step) but this input leaves "
                f"{x.shape[2]} (32 channels x {x.shape[2] // 32} frequency rows)"
            )
        x = self.fc(self.lstm(x))
        return x.mean(dim=1).float()

    def get_name(self) -> str:
        return "LCNN"
