"""Plain reference of ``dcnn-wpt-sym5-l8``: the level-8 sym5 wavelet-packet
image and the DCNN of gan-police/audiodeepfake-detection
(``src/audiofakedetect/models.py``, ``DCNN``), in plain PyTorch.

The transform follows ptwt's ``WaveletPacket(mode="reflect")``: per level a
reflect pad of ``(2L - 3) // 2`` on the left (one more on the right for an
odd length) and a stride-2 correlation with the flipped decomposition
filters; the nodes in frequency (Gray-code) order; ``log(x**2 + 1e-12)``.
The taps are pywt's sym5, frozen here.  The model reads a state dict in the
published ``nn.Sequential`` layout (``cnn.{i}``, ``dil_conv.{i}``,
``fc.1``); its dropout layers have rate 0 (the configuration's
``assumed``), so they are left out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference._common import conv1d, conv2d, linear, log_power

#: pywt ``Wavelet("sym5")``
DEC_LO = (0.027333068344998778, 0.029519490925706174, -0.03913424930231408,
          0.19939753397685558, 0.7234076904040417, 0.6339789634567925,
          0.016602105764510183, -0.1753280899080567, -0.021101834024689056,
          0.019538882735249875)
DEC_HI = (-0.019538882735249875, -0.021101834024689056, 0.1753280899080567,
          0.016602105764510183, -0.6339789634567925, 0.7234076904040417,
          -0.19939753397685558, -0.03913424930231408, -0.029519490925706174,
          0.027333068344998778)
LEVEL = 8


def transform(audio: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``[B, 1, T]`` audio -> ``[B, 1, 256, n]`` log packet image."""
    taps = torch.tensor(np.stack([DEC_LO[::-1], DEC_HI[::-1]])[:, None, :],
                        dtype=torch.float32, device=audio.device)
    length = taps.shape[-1]
    x = audio.reshape(audio.shape[0], 1, audio.shape[-1])
    b = x.shape[0]
    for _ in range(LEVEL):
        n = x.shape[-1]
        pad = (2 * length - 3) // 2
        y = F.pad(x.reshape(-1, 1, n), (pad, pad + n % 2), mode="reflect")
        y = conv1d(y, taps, tf32, stride=2)  # [B * nodes, 2, n']
        x = y.reshape(b, -1, y.shape[-1])  # children of node j at 2j, 2j + 1
    gray = torch.arange(2 ** LEVEL, device=audio.device)
    x = x[:, gray ^ (gray >> 1)]
    return log_power(x)[:, None]


def _prelu(x, w):
    return torch.where(x >= 0, x, w * x)


def _bn(x, p, name, train, affine):
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    y = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
    if affine:
        y = y * p[f"{name}.weight"][:, None, None] + p[f"{name}.bias"][:, None, None]
    return y


def _conv(x, p, name, tf32, **kw):
    return conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], tf32, **kw)


def forward(p, image: torch.Tensor, train: bool, tf32: bool = False) -> torch.Tensor:
    """Logits ``[B, 2]`` of the normalized image ``[B, 1, 256, T]``."""
    x = image.permute(0, 1, 3, 2)  # time on H
    x = F.max_pool2d(_prelu(_conv(x, p, "cnn.0", tf32, padding=2), p["cnn.1.weight"]), 2)
    # BatchNorm (no affine) -> conv -> PReLU, with a pool after 8 and 18
    for bn, conv, act, pad in ((3, 4, 5, 0), (6, 7, 8, 1), (10, 11, 12, 1),
                               (13, 14, 15, 1), (16, 17, 18, 1)):
        x = _bn(x, p, f"cnn.{bn}", train, affine=False)
        x = _prelu(_conv(x, p, f"cnn.{conv}", tf32, padding=pad), p[f"cnn.{act}.weight"])
        if act in (8, 18):
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 1, 3)  # time steps become the channels
    for bn, conv, act, pad, dil in ((0, 1, 2, 1, 1), (3, 4, 5, 2, 2), (6, 7, 8, 2, 4)):
        x = _bn(x, p, f"dil_conv.{bn}", train, affine=True)
        x = _conv(x, p, f"dil_conv.{conv}", tf32, padding=pad, dilation=dil)
        x = _prelu(x, p[f"dil_conv.{act}.weight"])
    return linear(x.flatten(2), p["fc.1.weight"], p["fc.1.bias"], tf32).mean(dim=1)
