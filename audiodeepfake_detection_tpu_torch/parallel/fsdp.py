"""FSDP: parameters, gradients and Adam moments sharded over the ranks.

Counterpart of ``audiodeepfake_detection_tpu/parallel/fsdp.py``
(``--fsdp`` / ``--fsdp-min-bytes``).  In JAX, ZeRO-3 is data placement:
each leaf of at least ``min_bytes`` is sharded along its largest axis that
divides by the ``data`` axis (``fsdp_specs``), XLA inserts the
all-gathers and reduce-scatters, and the smaller leaves stay replicated.
Here it is FSDP2's ``fully_shard`` on the ``"data"`` mesh: the math is
DDP's (the same gradients, the same BatchNorm moments), and the optimizer
state is built over the sharded parameters, so Adam's moments never exist
whole on a rank.

The ``min_bytes`` policy, as far as FSDP2 allows:

* each parameter is sharded along its largest dim that divides by the
  ranks (``shard_placement_fn``), dim 0 (padded) where none does;
* each element of an ``nn.ModuleList`` (the AST's encoder blocks, the
  grid model's blocks: modules a forward calls one by one) whose
  parameters reach ``min_bytes`` becomes a unit of its own, gathered just
  before it runs and freed after; the rest of the model is the root's one
  unit.  The DCNN and the LCNN, whose fused blocks read parameters of
  several modules at once, are one unit.

FSDP2 shards every parameter of a unit, so a leaf below ``min_bytes`` is
sharded all the same where JAX replicates it (ROADMAP.md, section 3).

A snapshot is still the reference ``.pt`` layout: :func:`full_model_state`
gathers it (every rank takes part) and rank 0 writes it; the ``.state.pt``
optimizer state is gathered the same way and keyed by parameter index, as a
single-device run's is, so either kind of run resumes the other's.
"""

from __future__ import annotations

import torch
from torch import nn

from .mesh import AXIS, mesh_size

DEFAULT_MIN_BYTES = 2**14


def _param_bytes(module: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def shard_dim(shape, ranks: int) -> int:
    """The dim a parameter of ``shape`` is sharded along: its largest dim
    that divides by ``ranks`` (JAX ``fsdp_specs``), else 0."""
    for dim in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[dim] % ranks == 0:
            return dim
    return 0


def fsdp_units(model: nn.Module, min_bytes: int = DEFAULT_MIN_BYTES):
    """The submodules that get a ``fully_shard`` of their own (before the
    root's): the elements of the model's ``nn.ModuleList``s whose
    parameters reach ``min_bytes``."""
    units = []
    for module in model.modules():
        if isinstance(module, nn.ModuleList):
            units.extend(m for m in module if _param_bytes(m) >= min_bytes)
    return units


def shard_fsdp(model: nn.Module, mesh, min_bytes: int = DEFAULT_MIN_BYTES,
               axis: str = AXIS) -> nn.Module:
    """``model`` fully sharded over ``mesh``'s ``axis``, in place (its class
    becomes FSDP2's); build the optimizer over its parameters after this."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    ranks = mesh_size(mesh, axis)

    def placement(param: nn.Parameter):
        return Shard(shard_dim(param.shape, ranks))

    sub = mesh[axis] if mesh.ndim > 1 else mesh
    for unit in fsdp_units(model, min_bytes):
        fully_shard(unit, mesh=sub, shard_placement_fn=placement)
    fully_shard(model, mesh=sub, shard_placement_fn=placement)
    return model


def _options(**kw):
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True, **kw)


def full_model_state(model: nn.Module) -> dict:
    """The whole state dict on the CPU, reference keys (every rank calls
    it; rank 0 gets it, the others an empty dict)."""
    from torch.distributed.checkpoint.state_dict import get_model_state_dict

    return get_model_state_dict(model, options=_options(cpu_offload=True))


def load_full_model_state(model: nn.Module, state: dict) -> None:
    """Install a whole state dict (every rank passes it) into the shards."""
    from torch.distributed.checkpoint.state_dict import set_model_state_dict

    set_model_state_dict(model, state, options=_options())


def _fqns(model: nn.Module):
    return [name for name, _ in model.named_parameters()]


def full_optimizer_state(model: nn.Module, optimizer) -> dict:
    """The whole optimizer state on the CPU, keyed by parameter index as
    ``optimizer.state_dict()`` of a single-device run is (every rank calls
    it; rank 0 gets it)."""
    from torch.distributed.checkpoint.state_dict import get_optimizer_state_dict

    osd = get_optimizer_state_dict(model, optimizer, options=_options(cpu_offload=True))
    if not osd:
        return osd
    index = {name: i for i, name in enumerate(_fqns(model))}
    return {
        "state": {index[k]: v for k, v in osd["state"].items()},
        "param_groups": [dict(g, params=[index[k] for k in g["params"]])
                         for g in osd["param_groups"]],
    }


def load_full_optimizer_state(model: nn.Module, optimizer, osd: dict) -> None:
    """Install an index-keyed whole optimizer state (every rank passes it)
    into the sharded optimizer."""
    from torch.distributed.checkpoint.state_dict import set_optimizer_state_dict

    names = _fqns(model)
    by_name = {
        "state": {names[int(k)]: v for k, v in osd["state"].items()},
        "param_groups": [dict(g, params=[names[int(k)] for k in g["params"]])
                         for g in osd["param_groups"]],
    }
    set_optimizer_state_dict(model, optimizer, by_name, options=_options())


def local_fraction(tensor: torch.Tensor) -> float:
    """The share of ``tensor``'s elements this rank holds (1.0 for a plain
    tensor, about ``1/ranks`` for a sharded DTensor)."""
    local = tensor.to_local() if hasattr(tensor, "to_local") else tensor
    return local.numel() / max(tensor.numel(), 1)
