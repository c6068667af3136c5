"""Audio Spectrogram Transformer (AST).

Counterpart of ``audiodeepfake_detection_tpu/models/ast.py`` (reference:
src/audiofakedetect/models.py:462-707): a DeiT-distilled ViT backbone whose
16x16 patch embedding takes one input channel with stride (fstride, tstride)
= (10, 10), a class and a distillation token, and a LayerNorm + Linear head
on the mean of the two.

The modules are named as the reference's trained AST, so ``state_dict()``
is its ``.pt`` layout (the JAX package's ``export_state_dict(..., "ast")``):
the backbone under ``v.`` (``v.patch_embed.proj``, ``v.cls_token``,
``v.dist_token``, ``v.pos_embed``, ``v.blocks.{i}.{norm1, attn.qkv,
attn.proj, norm2, mlp.fc1, mlp.fc2}``, ``v.norm``) and the head as
``mlp_head.{0, 1}``.  The backbone's LayerNorms use eps 1e-6, the head's
1e-5 (a plain torch LayerNorm in the reference).

``fused_attention`` routes each block's ``softmax(q k^T) v`` through
``ops/flash_attention.py::flash_mha_packed`` (the CUDA kernels on the card),
only when ``attn_drop_rate == 0``, as in JAX; otherwise the einsum path
runs.  ``remat_blocks`` recomputes each block in the backward
(``torch.utils.checkpoint``; the recomputation launches the forward kernel
again); ``remat_policy`` names the ``jax.checkpoint_policies`` policy of
a selective recomputation (:data:`REMAT_POLICIES`) and implies it.
``dtype=torch.bfloat16`` mirrors the flax ``dtype`` casts: every
Linear and the patch Conv compute in bf16 from float32 master weights,
``norm1`` / ``norm2`` emit bf16, the token stream is bf16 after ``embed``,
and ``norm``, the head's LayerNorm and Linear stay float32.

Initialisation follows the flax module: lecun-normal kernels (truncated at
two standard deviations), zero biases, unit LayerNorm scales, zero class
and distillation tokens, a truncated-normal (0.02) positional embedding.

``quant`` is the JAX model's post-training int8 (``ops/quantize.py``):
``"calibrate"`` records the input absmax of each block's ``qkv``,
``proj``, ``fc1`` and ``fc2`` (sites ``block_{i}/qkv`` and so on), a
``{site: act_scale}`` dict runs those matmuls on the int8 path
(``torch._int_mm``, per-output weight scales; the dequantized ``qkv``
feeds the fused attention as it is).  The patch embedding and the head
stay in the working type; calling a scales dict in training raises.

``embed`` / ``encode`` / ``classify`` are the three phases the GPipe
pipeline runs apart (``parallel/pipeline.py``; ``encode`` takes a stage's
range of blocks), and ``parallel/tensor.py`` shards each block's Linears
over a ``"model"`` mesh dim in place (Megatron tensor parallelism: a
block's ``num_heads`` is then its rank's share, and ``tp_group`` the
group its all-reduces run over).
"""

from __future__ import annotations

import functools
import math
from collections.abc import Mapping
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.flash_attention import flash_mha_packed
from ..ops.quantize import dense_int8_weights, int8_sites, quantized_dense
from ..parallel.mesh import copy_to_ranks, reduce_from_ranks

_SIZES = {
    "tiny224": dict(embed_dim=192, depth=12, num_heads=3),
    "small224": dict(embed_dim=384, depth=12, num_heads=6),
    "base224": dict(embed_dim=768, depth=12, num_heads=12),
    "base384": dict(embed_dim=768, depth=12, num_heads=12),
}
PATCH = 16

_aten = torch.ops.aten
_DOTS = (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.matmul)
_DOTS_NO_BATCH = (_aten.mm, _aten.addmm)
#: ``remat_policy`` name (the ``jax.checkpoint_policies`` ones that take no
#: argument) -> the ops whose outputs the backward keeps; every other op of
#: a block is recomputed.  ``"everything_saveable"`` keeps all, which is the
#: block without a checkpoint; ``"nothing_saveable"`` keeps none, which is
#: ``remat_blocks``.  Kernel 4 is no dot (as a ``pallas_call`` is none to
#: JAX): under the dot policies its forward launches again in the backward.
REMAT_POLICIES = {
    "everything_saveable": "all",
    "nothing_saveable": (),
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
}


def ast_patch_grid(
    fstride: int, tstride: int, input_fdim: int, input_tdim: int, patch: int = PATCH
) -> tuple[int, int]:
    """Number of patches along (freq, time) (reference get_shape, models.py:665-677)."""
    return (input_fdim - patch) // fstride + 1, (input_tdim - patch) // tstride + 1


def _lecun_normal_(weight: torch.Tensor, fan_in: int) -> None:
    # flax variance_scaling(1, "fan_in", "truncated_normal"): the standard
    # deviation of a unit normal truncated at +-2 is 0.8796...
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def _linear(features_in: int, features_out: int) -> nn.Linear:
    layer = nn.Linear(features_in, features_out)
    _lecun_normal_(layer.weight, features_in)
    nn.init.zeros_(layer.bias)
    return layer


def _dense(layer: nn.Linear, x: torch.Tensor, dtype, bias: bool = True) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to the
    compute type (float32 master weights receive the gradients); without
    the bias where ``bias`` is False."""
    b = layer.bias if bias else None
    if dtype is None:
        return F.linear(x, layer.weight, b)
    return F.linear(x.to(dtype), layer.weight.to(dtype), None if b is None else b.to(dtype))


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=...)``: statistics in float32, the result in
    ``dtype`` (float32 when ``None``)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y if dtype is None else y.to(dtype)


class _DropPath(nn.Module):
    """Stochastic depth: drop the whole residual branch per sample (timm
    drop_path)."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device) < keep
        return x * mask.to(x.dtype) / keep


class _Attention(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.qkv = _linear(dim, 3 * dim)
        self.proj = _linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = _linear(dim, hidden)
        self.fc2 = _linear(hidden, dim)


class _Block(nn.Module):
    """timm-0.4.5 DeiT block: pre-norm attention and MLP with residuals."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        dtype=None,
        fused_attention: bool = False,
    ) -> None:
        super().__init__()
        self.num_heads = num_heads
        # the "model" group of a tensor-parallel block (parallel/tensor.py)
        self.tp_group = None
        self.dtype = dtype
        self.fused_attention = fused_attention
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = _DropPath(drop_path_rate)

    def _dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        return F.dropout(x, rate, self.training) if rate else x

    def forward(self, x: torch.Tensor, sites=None) -> torch.Tensor:
        """``sites``: the block's int8 sites (``Int8Sites`` scoped to
        ``block_{i}/``), or None."""
        dt = self.dtype
        group = self.tp_group

        def dense(layer: nn.Linear, h: torch.Tensor, name: str) -> torch.Tensor:
            scale = sites.scale(name, h) if sites is not None else None
            if scale is None:
                return _dense(layer, h, dt)
            rec = sites.baked(name, lambda: dense_int8_weights(layer.weight))
            y = quantized_dense(h, layer.weight, scale, out_dtype=h.dtype, baked=rec)
            return y + layer.bias.to(h.dtype)

        def row_dense(layer: nn.Linear, h: torch.Tensor, name: str) -> torch.Tensor:
            """A row-parallel Linear under tensor parallelism: the rank's
            partial product summed over the ranks, then the bias once."""
            if group is None:
                return dense(layer, h, name)
            y = reduce_from_ranks(_dense(layer, h, dt, bias=False), group)
            return y + layer.bias.to(y.dtype)

        h = _layer_norm(self.norm1, x, dt)
        if group is not None:
            h = copy_to_ranks(h, group)
        b, n, _ = h.shape
        heads = self.num_heads  # this rank's share under tensor parallelism
        qkv = dense(self.attn.qkv, h, "qkv")
        head_dim = qkv.shape[-1] // (3 * heads)
        if self.fused_attention and self.attn_drop_rate == 0.0:
            # the kernel takes the Dense output's [B, N, 3HD] layout as it is
            h = flash_mha_packed(qkv, heads, 1.0 / math.sqrt(head_dim))
        else:
            q, k, v = qkv.reshape(b, n, 3, heads, head_dim).unbind(2)
            attn = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(head_dim)
            attn = self._dropout(torch.softmax(attn, dim=-1), self.attn_drop_rate)
            h = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, heads * head_dim)
        h = self._dropout(row_dense(self.attn.proj, h, "proj"), self.drop_rate)
        x = x + self.drop_path(h)
        h = _layer_norm(self.norm2, x, dt)
        if group is not None:
            h = copy_to_ranks(h, group)
        h = self._dropout(F.gelu(dense(self.mlp.fc1, h, "fc1")), self.drop_rate)
        h = self._dropout(row_dense(self.mlp.fc2, h, "fc2"), self.drop_rate)
        return x + self.drop_path(h)


def _selective(saved: tuple):
    """The forward and recompute contexts of a checkpoint that keeps the
    outputs of the ``saved`` ops and recomputes the rest."""

    def policy(ctx, op, *args, **kwargs):
        if op.overloadpacket in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, fstride: int, tstride: int) -> None:
        super().__init__()
        self.proj = nn.Conv2d(1, dim, PATCH, stride=(fstride, tstride))
        _lecun_normal_(self.proj.weight, PATCH * PATCH)
        nn.init.zeros_(self.proj.bias)


class _DeiT(nn.Module):
    """The backbone's parameters, named as timm's DeiT (the reference's
    ``self.v``)."""

    def __init__(self, cfg: dict, num_patches: int, fstride: int, tstride: int,
                 blocks: list) -> None:
        super().__init__()
        d = cfg["embed_dim"]
        self.patch_embed = _PatchEmbed(d, fstride, tstride)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches + 2, d))
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04)
        self.blocks = nn.ModuleList(blocks)
        self.norm = nn.LayerNorm(d, eps=1e-6)


class ASTModel(nn.Module):
    """AST: patch-embed spectrogram + DeiT encoder + dual-token head."""

    def __init__(
        self,
        label_dim: int = 2,
        fstride: int = 10,
        tstride: int = 10,
        input_fdim: int = 256,
        input_tdim: int = 101,
        model_size: str = "base384",
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        dtype: Optional[torch.dtype] = None,
        fused_attention: bool = False,
        remat_blocks: bool = False,
        remat_policy=None,
        quant=None,
    ) -> None:
        super().__init__()
        if remat_policy is not None and (
                not isinstance(remat_policy, str) or remat_policy not in REMAT_POLICIES):
            raise ValueError(
                f"remat_policy={remat_policy!r}: the supported jax.checkpoint_policies "
                f"names are {sorted(REMAT_POLICIES)} (the policy factories need "
                "names the AST does not tag, or host offload)")
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, float32 or bfloat16: {dtype!r}")
        self.label_dim = label_dim
        self.fstride, self.tstride = fstride, tstride
        self.input_fdim, self.input_tdim = input_fdim, input_tdim
        self.model_size = model_size
        self.dtype = None if dtype == torch.float32 else dtype
        self.quant = quant
        self.fused_attention = fused_attention
        # as in JAX, a policy implies remat
        self.remat_blocks = remat_blocks or remat_policy is not None
        self.remat_policy = remat_policy
        self.drop_rate = drop_rate
        self.attn_drop_rate, self.drop_path_rate = attn_drop_rate, drop_path_rate
        cfg = _SIZES[model_size]
        d, depth = cfg["embed_dim"], cfg["depth"]
        f_dim, t_dim = ast_patch_grid(fstride, tstride, input_fdim, input_tdim)
        self.num_patches = f_dim * t_dim
        # stochastic depth grows linearly over depth, the timm rule
        blocks = [
            _Block(
                d, cfg["num_heads"], drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                drop_path_rate=drop_path_rate * i / max(depth - 1, 1),
                dtype=self.dtype, fused_attention=fused_attention,
            )
            for i in range(depth)
        ]
        self.v = _DeiT(cfg, self.num_patches, fstride, tstride, blocks)
        head = _linear(d, label_dim)
        self.mlp_head = nn.Sequential(nn.LayerNorm(d, eps=1e-5), head)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, 1, F, T]`` spectrogram -> ``[B, num_patches + 2, D]`` tokens."""
        proj = self.v.patch_embed.proj
        if self.dtype is None:
            h = proj(x)
        else:
            dt = self.dtype
            h = F.conv2d(x.to(dt), proj.weight.to(dt), proj.bias.to(dt), proj.stride)
        b = h.shape[0]
        h = h.flatten(2).transpose(1, 2).float()  # [B, F' * T', D], time fastest
        v = self.v
        h = torch.cat([v.cls_token.expand(b, -1, -1), v.dist_token.expand(b, -1, -1), h], 1)
        h = h + v.pos_embed
        if self.dtype is not None:
            # the residual stream in the compute type; LN statistics and
            # parameters stay float32
            h = h.to(self.dtype)
        return F.dropout(h, self.drop_rate, self.training) if self.drop_rate else h

    def encode(self, h: torch.Tensor, blocks: Optional[range] = None) -> torch.Tensor:
        """The DeiT encoder: the transformer blocks in sequence (those of
        ``blocks``, a range of indices, when given: a pipeline stage's)."""
        sites = int8_sites(self)
        remat = self.remat_blocks and self.training and torch.is_grad_enabled()
        saved = REMAT_POLICIES.get(self.remat_policy, ())
        for i in range(len(self.v.blocks)) if blocks is None else blocks:
            block = self.v.blocks[i]
            scoped = sites.scope(f"block_{i}/") if sites is not None else None
            if not remat or saved == "all":
                h = block(h, scoped)
            elif saved:
                h = checkpoint(block, h, scoped, use_reentrant=False,
                               context_fn=functools.partial(_selective, saved))
            else:
                h = checkpoint(block, h, scoped, use_reentrant=False)
        return h

    def classify(self, h: torch.Tensor) -> torch.Tensor:
        """Encoded tokens -> logits (dual-token mean through the head)."""
        h = _layer_norm(self.v.norm, h, None)
        h = (h[:, 0] + h[:, 1]) / 2.0
        return self.mlp_head(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and isinstance(self.quant, Mapping):
            raise ValueError(
                "quant is inference-only (int8 rounding has no gradient); call the "
                "model in eval mode"
            )
        return self.classify(self.encode(self.embed(x)))

    def get_name(self) -> str:
        return "AST"
