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

``dtype=torch.bfloat16`` is the JAX model's ``dtype``: parameters and
BatchNorm buffers stay float32, and the compute is cast where the JAX model
casts it (``layers.run_layers``): the input after the permute, every
BatchNorm -> conv pair folded (statistics in float32, the folded weights
rounded once), the two plain 1x1 convs and the fused block's weights in
bfloat16, MaxFeatureMap and the pools in bfloat16.  The BLSTMs run in
float32, as the JAX package's do: its input projection multiplies the
bfloat16 sequence by the float32 ``w_ih``, which promotes.  The head is a
bfloat16 ``Dense``; the logits are averaged in bfloat16 and returned in
float32.

``mesh`` (``parallel/mesh.py``; JAX ``LCNN.mesh``) puts the model on a
process group's ``"data"`` mesh: its six BatchNorms become
``layers.SyncBatchNorm2d`` (the global batch's moments), and the fused
block runs as ``ops/fused_conv1.py::batch_shard_mapped`` on the rank's own
batch (it has no moments to sum).

``quant`` is the JAX model's post-training int8 (``ops/quantize.py``;
inference only): ``"calibrate"`` records the input absmax of each of the
nine convs, ``lcnn_0``, ``lcnn_3``, ``lcnn_6``, ``lcnn_10``, ``lcnn_13``,
``lcnn_16``, ``lcnn_19``, ``lcnn_22``, ``lcnn_25`` (named by their index
in ``lcnn``), and a ``{site: act_scale}`` dict runs those sites on the
int8 path, a BatchNorm in front folded into the quantized weights.  The
BLSTMs and the head stay in the working type; a fused first block that
runs in eval takes precedence over ``lcnn_0``, as in the JAX model.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..ops.fused_conv1 import batch_shard_mapped, can_batch_shard, fused_conv_mfm_pool
from ..ops.quantize import check_quant_eval, int8_sites
from .layers import (
    BLSTMLayer,
    MaxFeatureMap2D,
    compute_dtype,
    linear_in_dtype,
    run_layers,
    use_mesh,
)


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
        dtype: Optional[torch.dtype] = None,
        quant=None,
        mesh=None,
    ) -> None:
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.quant = quant
        self.mesh = mesh
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
        if mesh is not None:
            use_mesh(self, mesh)

    def _fused_first_block(self, x: torch.Tensor) -> torch.Tensor:
        """``lcnn[0:3]`` through the fused block, then the rest of ``lcnn``.
        ``x``: ``[B, 1, T, F]``."""
        conv = self.lcnn[0]
        dt = x.dtype  # the parameters cast to it, as in the JAX model
        block = fused_conv_mfm_pool
        if can_batch_shard(self.mesh, x.shape[0]):
            block = batch_shard_mapped(block, self.mesh)
        out = block(
            x[:, 0].contiguous(),
            conv.weight.reshape(conv.out_channels, 25).t().to(dt),
            conv.bias.to(dt),
        )
        x = out.permute(0, 3, 1, 2)  # the block stores NCHW: contiguous
        return run_layers(list(self.lcnn)[3:], x, self.dtype is not None,
                          int8_sites(self, "lcnn_"), 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_quant_eval(self)
        # [B, C, F, T] -> [B, C, T, F]: time on H (reference permute)
        x = x.permute(0, 1, 3, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.fused_layer1 and (self.training or self.fused_layer1 == "always"):
            x = self._fused_first_block(x)
        else:
            x = run_layers(list(self.lcnn), x, self.dtype is not None,
                           int8_sites(self, "lcnn_"))
        # [B, 32, T', F'] -> [B, T', 32 * F']: per time step, channels major
        # and frequency minor (reference models.py:126-128)
        x = x.permute(0, 2, 1, 3).flatten(2)
        if x.shape[2] != self.feat:
            raise ValueError(
                f"the LCNN was built for lstm_channels={self.lstm_channels} "
                f"({self.feat} features per time step) but this input leaves "
                f"{x.shape[2]} (32 channels x {x.shape[2] // 32} frequency rows)"
            )
        if self.dtype is None:
            return self.fc(self.lstm(x)).mean(dim=1).float()
        x = linear_in_dtype(self.fc, self.lstm(x.float()), self.dtype)
        return x.mean(dim=1).float()

    def get_name(self) -> str:
        return "LCNN"
