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

The JAX reference's ``folded_bn_conv`` and ``first_conv`` are schedules of
BatchNorm -> conv and of a conv's weight gradient for XLA; in float32 their
math is ``nn.BatchNorm2d`` -> ``nn.Conv2d`` under autograd, which the
unfused layers run, and only the fused second block folds a BatchNorm for
real (below).

``dtype=torch.bfloat16`` is the JAX model's ``dtype``, its speed mode: the
parameters and BatchNorm buffers stay float32 (the state dict does not
change) and the compute is cast where the JAX model casts it.  The input is
cast after the permute; every BatchNorm -> conv pair folds as the JAX
``folded_bn_conv`` does (``layers.run_layers``, statistics in float32,
the folded weights rounded once); convolutions, PReLUs and the head cast
their parameters; the fused blocks take bfloat16 activations (the first
block its parameters cast, the fused pool a float32 slope, the second block
bfloat16 effective weights and slope and a float32 ``corr``); the logits
are averaged in bfloat16 and returned in float32.

Three tri-state flags (``False``; ``True``: in training only; ``"always"``:
in eval too) send parts of ``cnn`` through hand-written kernels.  They read
the parameters and buffers of the ``nn.Sequential`` entries and add none, so
every state dict loads under every flag:

* ``fused_layer1``: ``cnn[0:3]`` (conv + PReLU + pool) through
  ``ops/fused_conv1.py``, when ``in_channels == 1`` and ``kernel1 == 3``; in
  training ``cnn[3]`` normalises with the moments the kernel accumulated.
* ``fused_layer2``: ``cnn[6:10]`` (BatchNorm + conv 3x3 + PReLU + pool)
  through ``ops/fused_conv2.py``.  ``layers.batch_norm_scale_shift`` gives
  the ``(s, t)`` of BatchNorm ``cnn[6]``; the kernel takes the effective
  weights ``weight * s`` and the additive map ``conv(t * 1, weight)[0] +
  bias`` (a batch-1 convolution, exact at the padded borders), and autograd
  chains its ``dw`` / ``dcorr`` back into the conv's parameters and the
  BatchNorm's moments.  In training ``cnn[10]`` takes the kernel's moments.
* ``fused_pool``: PReLU + pool ``cnn[8:10]`` (unless ``fused_layer2`` took
  them) and ``cnn[18:20]`` through ``ops/fused_pool.py``, the first with
  moments for ``cnn[10]`` in training.

``mesh`` (``parallel/mesh.py``; JAX ``DCNN.mesh``) puts the model on a
process group's ``"data"`` mesh: every BatchNorm becomes a
``layers.SyncBatchNorm2d`` (the global batch's moments, as JAX's
reductions over the sharded batch give them), and the fused blocks run as
``ops/fused_conv1.py::batch_shard_mapped`` on the rank's own batch, their
moments summed over the ranks before the BatchNorm that takes them.

``quant`` is the JAX model's post-training int8 (``ops/quantize.py``;
inference only, training with it raises): ``"calibrate"`` records the
input absmax of each conv site, a ``{site: act_scale}`` dict runs those
sites on the int8 path, their BatchNorm folded into the quantized weights
(``layers.folded_bn_conv(..., act_scale=)``).  The sites are named by the
conv's index in ``cnn`` / ``dil_conv``, as the JAX modules are: ``cnn_0``,
``cnn_4``, ``cnn_7``, ``cnn_11``, ``cnn_14``, ``cnn_17``, ``dil_1``,
``dil_4``, ``dil_7``.  A fused block that runs in eval (``"always"``) takes
precedence and its conv stays unquantized, as in the JAX model.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..ops.fused_conv1 import (
    batch_shard_mapped,
    can_batch_shard,
    fused_conv1_prelu_pool,
    fused_conv1_prelu_pool_stats,
)
from ..ops.fused_conv2 import fused_conv2_prelu_pool, fused_conv2_prelu_pool_stats
from ..ops.fused_pool import fused_prelu_pool, fused_prelu_pool_stats
from ..ops.quantize import check_quant_eval, int8_sites
from .layers import (
    batch_norm_from_moments,
    batch_norm_scale_shift,
    compute_dtype,
    folded_bn_conv,
    linear_in_dtype,
    batch_moments,
    run_layers,
    use_mesh,
)


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
        fused_layer1: Union[bool, str] = False,
        fused_pool: Union[bool, str] = False,
        fused_layer2: Union[bool, str] = False,
        dtype: Optional[torch.dtype] = None,
        quant=None,
        mesh=None,
    ) -> None:
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.quant = quant
        self.mesh = mesh
        for name, flag in (("fused_layer1", fused_layer1), ("fused_pool", fused_pool),
                           ("fused_layer2", fused_layer2)):
            if flag not in (False, True, "always"):
                raise ValueError(f"{name} must be False, True or 'always': {flag!r}")
        self.fused_layer1 = fused_layer1
        self.fused_pool = fused_pool
        self.fused_layer2 = fused_layer2
        self.in_channels = in_channels
        self.kernel1 = kernel1
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
        if mesh is not None:
            use_mesh(self, mesh)

    def _sharded(self, fn, x: torch.Tensor, stat_outputs: int = 0):
        """``fn`` as ``batch_shard_mapped`` when the model is on a mesh (its
        moments summed over the ranks), else ``fn``."""
        if can_batch_shard(self.mesh, x.shape[0]):
            return batch_shard_mapped(fn, self.mesh, stat_outputs=stat_outputs)
        return fn

    def _moments_bn(self, at: int, x: torch.Tensor, s: torch.Tensor, q: torch.Tensor):
        """Train-mode BatchNorm ``cnn[at]`` on ``x`` from the moments ``(s,
        q)`` a fused block accumulated; in a compute dtype folded into conv
        ``cnn[at + 1]``, as the JAX model folds it.  Returns the activation
        and the index of the next layer of ``cnn``."""
        if self.dtype is None:
            return batch_norm_from_moments(self.cnn[at], x, s, q), at + 1
        return folded_bn_conv(self.cnn[at], self.cnn[at + 1], x, (s, q)), at + 2

    def _fused_first_block(self, x: torch.Tensor):
        """``cnn[0:3]`` (and ``cnn[3]`` in training) through the fused block.
        ``x``: ``[B, 1, T, F]``.  Returns the activation and the index of
        the next layer of ``cnn``."""
        conv, prelu = self.cnn[0], self.cnn[1]
        dt = x.dtype  # the parameters cast to it, as in the JAX model
        plane = x[:, 0].contiguous()
        args = (
            plane,
            conv.weight.reshape(conv.out_channels, 9).t().to(dt),
            conv.bias.to(dt),
            prelu.weight.to(dt),
        )
        # the block's [B, h2, w2, C] is a view of NCHW memory, so its permute
        # is the contiguous NCHW tensor cuDNN reads, and the cotangent cuDNN
        # hands back is NCHW memory too: no copy in either direction (left
        # channels-last, cuDNN's fp32 convolutions would run slower by more
        # than the fused block saves; PERF.md, Findings)
        if self.training:
            out, s, q = self._sharded(fused_conv1_prelu_pool_stats, x, 2)(*args)
            return self._moments_bn(3, out.permute(0, 3, 1, 2), s, q)
        return self._sharded(fused_conv1_prelu_pool, x)(*args).permute(0, 3, 1, 2), 3

    def _fused_second_block(self, x: torch.Tensor):
        """``cnn[6:10]`` (and ``cnn[10]`` in training) through the fused
        block: BatchNorm ``cnn[6]`` folded into conv ``cnn[7]``, PReLU
        ``cnn[8]``, pool.  ``x``: ``[B, C2, H, W]``."""
        conv, bn = self.cnn[7], self.cnn[6]
        # a compute dtype takes the JAX model's one-pass statistics (over
        # the global batch on a mesh), float32 its var_mean off a mesh
        moments = None if self.dtype is None or not bn.training else batch_moments(bn, x)
        s, t = batch_norm_scale_shift(bn, x, moments)
        c_in, (h, w) = x.shape[1], x.shape[2:]
        weight = conv.weight  # [Cout, Cin, 3, 3]
        w_eff = (weight * s.reshape(1, -1, 1, 1)).permute(2, 3, 1, 0)
        w_eff = w_eff.reshape(9 * c_in, conv.out_channels)
        alpha = self.cnn[8].weight
        # what the folded shift leaves: the conv of the constant map t, which
        # differs from a bias near the zero-padded borders only (batch 1)
        if self.dtype is None:
            t_map = t.to(weight.dtype).reshape(1, c_in, 1, 1).expand(1, c_in, h, w)
            corr = nn.functional.conv2d(t_map, weight, conv.bias, padding=1)[0]
        else:
            # the JAX model's casts: weights, map and slope in the compute
            # type, the map's convolution plus bias there, then float32
            dt = self.dtype
            w_eff, alpha = w_eff.to(dt), alpha.to(dt)
            t_map = t.to(dt).reshape(1, c_in, 1, 1).expand(1, c_in, h, w)
            corr = nn.functional.conv2d(t_map, weight.to(dt), padding=1)[0]
            corr = (corr + conv.bias.to(dt).reshape(-1, 1, 1)).float()
        args = (x.contiguous(), w_eff, corr, alpha)
        if self.training:
            return self._moments_bn(10, *self._sharded(fused_conv2_prelu_pool_stats, x, 2)(*args))
        return self._sharded(fused_conv2_prelu_pool, x)(*args), 10

    def _fused_pool(self, x: torch.Tensor, at: int, feeds_bn: bool):
        """PReLU ``cnn[at]`` + pool ``cnn[at + 1]`` through the fused block
        (the slope in float32, as the JAX model hands it over); in training
        the BatchNorm behind a pool that ``feeds_bn`` takes the kernel's
        moments."""
        alpha = self.cnn[at].weight
        if feeds_bn and self.training:
            stats = self._sharded(fused_prelu_pool_stats, x, 2)(x.contiguous(), alpha)
            return self._moments_bn(at + 2, *stats)
        return self._sharded(fused_prelu_pool, x)(x.contiguous(), alpha), at + 2

    def _cnn(self, x: torch.Tensor) -> torch.Tensor:
        """``self.cnn(x)``, with the blocks the flags name run fused (a
        fused block's conv is no int8 site, as in the JAX model)."""

        def on(flag) -> bool:
            return bool(flag) and (self.training or flag == "always")

        layers = list(self.cnn)
        sites = int8_sites(self, "cnn_")

        def run(x, start: int, stop: int):
            return run_layers(layers[start:stop], x, self.dtype is not None, sites, start)

        if not (on(self.fused_layer1) or on(self.fused_pool) or on(self.fused_layer2)):
            return run(x, 0, len(layers))
        nxt = 0
        if on(self.fused_layer1) and self.in_channels == 1 and self.kernel1 == 3:
            x, nxt = self._fused_first_block(x)
        x = run(x, nxt, 6)
        if on(self.fused_layer2):
            x, nxt = self._fused_second_block(x)
        elif on(self.fused_pool):
            x, nxt = self._fused_pool(run(x, 6, 8), 8, feeds_bn=True)
        else:
            nxt = 6
        x = run(x, nxt, 18)
        if on(self.fused_pool):
            x, nxt = self._fused_pool(x, 18, feeds_bn=False)
        else:
            nxt = 18
        return run(x, nxt, len(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_quant_eval(self)
        # [B, C, F, T] -> [B, C, T, F]: time on H (reference permute)
        x = x.permute(0, 1, 3, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self._cnn(x)
        # [B, 64, T/8, F/8] -> [B, T/8, 64, F/8]: time becomes the channels
        # of the dilated block (reference models.py:307)
        x = x.permute(0, 2, 1, 3)
        if self.with_dilation:
            x = run_layers(list(self.dil_conv), x, self.dtype is not None,
                           int8_sites(self, "dil_"))
        # the reference's Linear(flattend_size, 2) fails on a geometry
        # mismatch; say which numbers disagree
        width = x.shape[2] * x.shape[3]
        if width != self.flattend_size:
            raise ValueError(
                f"flattend_size={self.flattend_size} does not match the "
                f"flattened feature width {width} for this input geometry"
            )
        # Flatten(2) + Linear per time step, then the mean over time
        if self.dtype is None:
            return self.fc(x).mean(dim=1)
        return linear_in_dtype(self.fc[1], x.flatten(2), self.dtype).mean(dim=1).float()

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
