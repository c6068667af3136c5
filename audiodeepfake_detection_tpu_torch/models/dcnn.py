"""DCNN model family: the reference's headline dilated-CNN classifier.

Counterpart of ``audiodeepfake_detection_tpu/models/dcnn.py`` (reference:
src/audiofakedetect/models.py:240-459), built in the reference's own
``nn.Sequential`` layout so a reference ``.pt`` state dict loads as is:

* ``DCNN``          — 6-conv front + 3 dilated convs + linear head
* ``DCNNxDropout``  — same without the dropout layers
* ``DCNNxDilation`` — same without the dilated block

The input is the transform image ``[B, C, packets(F), time(T)]``; the model
permutes time onto H first.  The first conv pads by 2 with a 3x3 kernel, so
T grows by 2 before three 2x2 max-pools: the dilated block's channel count
is ``T//8 + time_dim_add`` (12 for 1 s at 22050 Hz).  Its under-padded
convs shrink (64, 32) -> (40, 8), the 320 features the head reads per time
step; the head's logits are averaged over time.

In eval the JAX reference's ``folded_bn_conv`` and ``first_conv`` compute
exactly BatchNorm followed by a conv, which is what this module runs; their
training-side rewrites wait for the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


def _bn_conv(cin: int, cout: int, k: int, padding: int, affine: bool, dilation: int = 1):
    return [
        nn.BatchNorm2d(cin, affine=affine, eps=1e-5),
        nn.Conv2d(cin, cout, k, padding=padding, dilation=dilation),
        nn.PReLU(),
    ]


class DCNN(nn.Module):
    """Deep CNN with dilated convolutions (reference models.py:240-317)."""

    def __init__(
        self,
        in_channels: int = 1,
        ochannels1: int = 64,
        ochannels2: int = 64,
        ochannels3: int = 96,
        ochannels4: int = 128,
        ochannels5: int = 32,
        kernel1: int = 3,
        time_dim: int = 12,
        flattend_size: int = 320,
        dropout_cnn: float = 0.6,
        dropout_lstm: float = 0.2,
        nclasses: int = 2,
        with_dropout: bool = True,
        with_dilation: bool = True,
    ) -> None:
        super().__init__()
        self.flattend_size = flattend_size
        self.with_dropout = with_dropout
        self.with_dilation = with_dilation
        # indices match the reference Sequential (torch_import.py:364-370):
        # 0 conv, 1 prelu, 2 pool, 3-5 bn/conv/prelu, 6-8, 9 pool, 10-12,
        # 13-15, 16-18, 19 pool, 20 dropout
        cnn = [
            nn.Conv2d(in_channels, ochannels1, kernel1, padding=2),
            nn.PReLU(),
            nn.MaxPool2d(2, 2),
            *_bn_conv(ochannels1, ochannels2, 1, 0, affine=False),
            *_bn_conv(ochannels2, ochannels3, 3, 1, affine=False),
            nn.MaxPool2d(2, 2),
            *_bn_conv(ochannels3, ochannels4, 3, 1, affine=False),
            *_bn_conv(ochannels4, ochannels5, 3, 1, affine=False),
            *_bn_conv(ochannels5, 64, 3, 1, affine=False),
            nn.MaxPool2d(2, 2),
        ]
        if with_dropout:
            cnn.append(nn.Dropout(dropout_cnn))
        self.cnn = nn.Sequential(*cnn)
        if with_dilation:
            dil = [
                *_bn_conv(time_dim, time_dim, 3, 1, affine=True, dilation=1),
                *_bn_conv(time_dim, time_dim, 5, 2, affine=True, dilation=2),
                *_bn_conv(time_dim, time_dim, 7, 2, affine=True, dilation=4),
            ]
            if with_dropout:
                dil.append(nn.Dropout(dropout_lstm))
            self.dil_conv = nn.Sequential(*dil)
        self.fc = nn.Sequential(nn.Flatten(2), nn.Linear(flattend_size, nclasses))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # [B, C, F, T] -> [B, C, T, F]: time on H (reference permute)
        x = self.cnn(x.permute(0, 1, 3, 2))
        # [B, 64, T/8, F/8] -> [B, T/8, 64, F/8]: time becomes the channels
        # of the dilated block (reference models.py:307)
        x = x.permute(0, 2, 1, 3)
        if self.with_dilation:
            x = self.dil_conv(x)
        # the reference's Linear(flattend_size, 2) fails on a geometry
        # mismatch; say which numbers disagree
        width = x.shape[2] * x.shape[3]
        if width != self.flattend_size:
            raise ValueError(
                f"flattend_size={self.flattend_size} does not match the "
                f"flattened feature width {width} for this input geometry"
            )
        # Flatten(2) + Linear per time step, then the mean over time
        return self.fc(x).mean(dim=1)

    def get_name(self) -> str:
        if not self.with_dilation:
            return "DCNNxDilation"
        if not self.with_dropout:
            return "DCNNxDropout"
        return "DCNN"


def DCNNxDropout(**kwargs) -> DCNN:
    """DCNN ablation without dropout (reference models.py:320-395)."""
    kwargs.setdefault("with_dropout", False)
    return DCNN(**kwargs)


def DCNNxDilation(**kwargs) -> DCNN:
    """DCNN ablation without the dilated block (reference models.py:398-459)."""
    kwargs.setdefault("with_dilation", False)
    return DCNN(**kwargs)
