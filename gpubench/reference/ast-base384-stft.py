"""Plain reference of ``ast-base384-stft``: the log power spectrogram and the
Audio Spectrogram Transformer (Gong, Chung and Glass, Interspeech 2021,
arXiv:2104.01778) on a DeiT encoder, in plain PyTorch.

The spectrogram is ``torchaudio.transforms.Spectrogram``'s: a periodic Hann
window of ``n_fft`` = 511, hop 220, ``center=True`` with reflect padding,
``|X|**2``, then ``log(x + 1e-12)``.  The model reads a state dict in the
published AST layout (``v.patch_embed.proj``, ``v.cls_token``,
``v.dist_token``, ``v.pos_embed``, ``v.blocks.{i}``, ``v.norm``,
``mlp_head.{0, 1}``): 16 x 16 patches at stride 10, pre-norm blocks with
LayerNorms of eps 1e-6, heads of 64, an exact GELU, and the head's
LayerNorm (eps 1e-5) and Linear on the mean of the class and
distillation tokens.  Dropout and drop-path rates are 0 (the
configuration's ``assumed``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference._common import conv2d, gelu, linear, matmul

N_FFT = 511
HOP = 220
STRIDE = 10
HEAD_DIM = 64


def transform(audio: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``[B, 1, T]`` audio -> ``[B, 1, 256, frames]`` log power image (the
    FFT has no TF32 mode: ``tf32`` leaves it alone)."""
    k = torch.arange(N_FFT, dtype=torch.float64, device=audio.device)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * k / N_FFT)).float()
    spec = torch.stft(audio.reshape(-1, audio.shape[-1]), N_FFT, HOP, N_FFT, window,
                      center=True, pad_mode="reflect", onesided=True, return_complex=True)
    power = spec.real * spec.real + spec.imag * spec.imag
    return torch.log(power + 1e-12)[:, None]


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def _dense(x, p, name, tf32):
    return linear(x, p[f"{name}.weight"], p[f"{name}.bias"], tf32)


def forward(p, image: torch.Tensor, train: bool, tf32: bool = False) -> torch.Tensor:
    """Logits ``[B, 2]`` of the normalized image ``[B, 1, F, T]``
    (``train`` changes nothing: no layer here differs in training)."""
    x = conv2d(image, p["v.patch_embed.proj.weight"], p["v.patch_embed.proj.bias"], tf32,
               stride=STRIDE)
    b, d = x.shape[:2]
    h = x.flatten(2).transpose(1, 2)  # patches, time fastest
    h = torch.cat([p["v.cls_token"].expand(b, -1, -1), p["v.dist_token"].expand(b, -1, -1), h], 1)
    h = h + p["v.pos_embed"]
    n, heads = h.shape[1], d // HEAD_DIM
    depth = len({k.split(".")[2] for k in p if k.startswith("v.blocks.")})
    for i in range(depth):
        blk = f"v.blocks.{i}"
        qkv = _dense(_ln(h, p, f"{blk}.norm1", 1e-6), p, f"{blk}.attn.qkv", tf32)
        q, k, v = qkv.reshape(b, n, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
        att = torch.softmax(matmul(q, k.transpose(-1, -2), tf32) / math.sqrt(HEAD_DIM), -1)
        o = matmul(att, v, tf32).transpose(1, 2).reshape(b, n, d)
        h = h + _dense(o, p, f"{blk}.attn.proj", tf32)
        y = gelu(_dense(_ln(h, p, f"{blk}.norm2", 1e-6), p, f"{blk}.mlp.fc1", tf32))
        h = h + _dense(y, p, f"{blk}.mlp.fc2", tf32)
    h = _ln(h, p, "v.norm", 1e-6)
    h = _ln((h[:, 0] + h[:, 1]) / 2.0, p, "mlp_head.0", 1e-5)
    return _dense(h, p, "mlp_head.1", tf32)
