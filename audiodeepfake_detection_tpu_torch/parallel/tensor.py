"""Megatron tensor parallelism for the AST, written out by hand.

Counterpart of ``audiodeepfake_detection_tpu/parallel/tensor.py``.  There
the layouts are data placement and XLA inserts the all-reduces; here each
rank holds its shards as ordinary parameters and the blocks run the two
collectives of Megatron themselves (``parallel/mesh.py``):
``copy_to_ranks`` (``f``: identity forward, all-reduce backward) in front
of the column-parallel ``qkv`` and ``fc1``, ``reduce_from_ranks`` (``g``:
all-reduce forward, identity backward) behind the row-parallel ``proj``
and ``fc2``.  Every other parameter is replicated, and its gradient is
already the whole one on every rank: the loss is the same over
``"model"``.  Over a ``("data", "model")`` mesh the gradients are then
averaged over ``"data"`` (``mesh.all_reduce_grads``).

The column-parallel shards of ``qkv`` are aligned to heads, where JAX's
``P(None, "model")`` splits the packed ``3 * D`` columns into contiguous
chunks and XLA reshards before the attention: rank ``r`` takes the rows of
its ``H / tp`` heads from each of q, k and v, packed ``[3, H / tp, 64]``,
which kernel 4 takes as it is; ``proj``'s input columns of the same heads
match them.  The same math, with the shards placed otherwise.  DTensor's
``ColwiseParallel`` would hand the kernel the contiguous chunks, and
DTensor under gloo on CUDA tensors is the machinery whose FSDP2 step dies
on a card shared by gloo ranks (``tools/dist_probe.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from .mesh import mesh_group, mesh_rank, mesh_size

_COL_PARALLEL = ("attn.qkv", "mlp.fc1")  # output features split
_ROW_PARALLEL = ("attn.proj", "mlp.fc2")  # input features split; output all-reduced


def ast_param_specs(model: nn.Module, axis: str = "model") -> Dict[str, tuple]:
    """State-dict key -> the per-dim spec of its parameter: ``axis`` at the
    sharded dim, ``None`` elsewhere, ``()`` for a replicated one (JAX
    ``ast_param_specs``, on torch's ``[out, in]`` weights)."""
    specs = {}
    for key, value in model.state_dict().items():
        layer, _, kind = key.rpartition(".")
        spec = ()
        if layer.endswith(_COL_PARALLEL):
            spec = (axis,) + (None,) * (value.ndim - 1)
        elif layer.endswith(_ROW_PARALLEL) and kind == "weight":
            spec = (None, axis)
        specs[key] = spec
    return specs


def _sharding(key: str, spec: tuple, axis: str) -> Optional[tuple]:
    """``(dim, groups)`` of a sharded key: the dim, and how many packed
    groups it holds (3 for ``qkv``: q, k and v, each split by heads)."""
    if axis not in spec:
        return None
    return spec.index(axis), 3 if ".attn.qkv." in key else 1


def _shard(full: torch.Tensor, dim: int, groups: int, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``full`` along ``dim``: its chunk of each of
    the ``groups`` packed groups, in order."""
    parts = full.unflatten(dim, (groups, size, full.shape[dim] // (groups * size)))
    return parts.select(dim + 1, rank).flatten(dim, dim + 1).contiguous()


def _unshard(gathered: torch.Tensor, dim: int, groups: int) -> torch.Tensor:
    """Inverse of :func:`_shard` over ``gathered [size, *shard]``."""
    parts = gathered.unflatten(dim + 1, (groups, gathered.shape[dim + 1] // groups))
    return parts.movedim(0, dim + 1).flatten(dim, dim + 2)


def shard_ast_params(model: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Turn the AST's blocks tensor-parallel over ``mesh[axis]``, in place:
    each block's ``qkv`` / ``fc1`` keep this rank's output rows, ``proj`` /
    ``fc2`` its input columns, its head count becomes ``H / tp`` and its
    all-reduces run over the axis's group.  Every rank starts from the same
    full weights.  Call it before the optimizer takes the parameters."""
    if getattr(model, "quant", None) is not None:
        raise ValueError("shard_ast_params: an int8 model runs on one device")
    size, rank = mesh_size(mesh, axis), mesh_rank(mesh, axis)
    group = mesh_group(mesh, axis)
    specs = ast_param_specs(model, axis)
    for i, block in enumerate(model.v.blocks):
        if block.num_heads % size:
            raise ValueError(
                f"shard_ast_params: {block.num_heads} heads of block {i} do not split over "
                f"the {size} ranks of mesh axis '{axis}'")
        for name in _COL_PARALLEL + _ROW_PARALLEL:
            layer = block.get_submodule(name)
            for kind in ("weight", "bias"):
                key = f"v.blocks.{i}.{name}.{kind}"
                sharding = _sharding(key, specs[key], axis)
                if sharding is not None:
                    shard = _shard(getattr(layer, kind).detach(), *sharding, rank, size)
                    setattr(layer, kind, nn.Parameter(shard))
            layer.out_features, layer.in_features = layer.weight.shape
        block.num_heads //= size
        block.tp_group = group
    return model


def full_ast_state(model: nn.Module, mesh, axis: str = "model",
                   tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The reference ``.pt`` layout of a tensor-parallel AST: each sharded
    entry gathered over ``mesh[axis]`` (every rank calls it and gets it).
    ``tensors``: a ``{state-dict key: this rank's tensor}`` dict to gather
    in place of the state (the gradients, say)."""
    if tensors is None:
        tensors = {k: v.detach() for k, v in model.state_dict().items()}
    size, group = mesh_size(mesh, axis), mesh_group(mesh, axis)
    specs = ast_param_specs(model, axis)
    out = {}
    for key, local in tensors.items():
        sharding = _sharding(key, specs[key], axis)
        if sharding is None:
            out[key] = local
            continue
        local = local.contiguous()
        gathered = local.new_empty((size * local.shape[0], *local.shape[1:]))
        dist.all_gather_into_tensor(gathered, local, group=group)
        out[key] = _unshard(gathered.unflatten(0, (size, local.shape[0])), *sharding)
    return out
