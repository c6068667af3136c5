"""The process group as a device mesh: ranks, batch shards, collectives.

Counterpart of ``audiodeepfake_detection_tpu/parallel/mesh.py``.  The JAX
package is single-controller: one process drives every device, the batch
is *placed* over a ``("data",)`` mesh, and XLA derives each collective
(gradient ``psum``, global BatchNorm moments, eval sums) from that
placement.  The port is one process per device under
``torch.distributed``, as the reference's torchrun + DDP was (reference
src/audiofakedetect/train_classifier.py:44-47), so what JAX derives is
spelled out here:

* :func:`get_mesh` -- a ``DeviceMesh`` with one ``"data"`` dim over the
  world (``None`` with no group, or with one rank unless asked for), or
  the two-dimensional meshes of the AST's model-parallel modes
  (:func:`data_stage_mesh`; ``parallel/tensor.py``, ``pipeline.py``);
* :func:`shard_batch` -- a rank's slice of a global batch.  The training
  path needs none: ``FrameLoader`` already hands each rank its own strided
  slice (``data/loader.py``), the ``DistributedSampler`` role.  JAX's
  ``replicate`` is DDP's broadcast of the parameters and buffers from rank
  0 when it wraps a model, and its ``device_prefetch`` the loader's own
  (each rank copies only its own batch);
* :func:`all_reduce_sum` -- the autograd-aware sum over ranks that the
  BatchNorm moments take: its backward is the sum of the cotangents over
  ranks (the transpose of JAX's ``psum``, and what ``nn.SyncBatchNorm``
  does under DDP), so every rank's gradient sees the global batch;
* :func:`all_gather_rows` / :func:`agree` -- the eval outputs gathered
  for the metrics, and a value every rank must hold the same (the number
  of steps and batches: ranks that disagree would deadlock).

Every collective here is one that gloo also runs on CUDA tensors (a card
shared by several gloo ranks), as well as NCCL: ``all_reduce``,
``broadcast`` and ``all_gather_into_tensor`` (``tools/dist_probe.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXIS = "data"

_MESHES: dict = {}


def is_distributed() -> bool:
    """True when a default process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def get_mesh(device=None, min_ranks: int = 2, axis_names: Sequence[str] = (AXIS,),
             shape: Optional[Sequence[int]] = None):
    """The world as a ``DeviceMesh``, or ``None``.

    One ``"data"`` dim by default; ``axis_names`` / ``shape`` name and size
    the dims of another layout (JAX ``get_mesh``: a ``("data", "model")``
    mesh for tensor parallelism, ``("data", "stage")`` for the pipeline),
    ranks laid out row-major, the last dim fastest (``shape`` defaults to
    the world along the first dim, 1 along the others).  ``None`` with no
    process group, or with fewer than ``min_ranks`` ranks: one rank is the
    single-device path unless the caller asks for the distributed one
    (``min_ranks=1``: ``--ddp`` / ``--fsdp`` on one rank run DDP / FSDP and
    the synchronized BatchNorm all the same).  ``device``: where the rank's
    tensors live (``"cuda"`` or ``"cpu"``; default ``"cuda"`` under NCCL,
    else ``"cpu"``).
    """
    if not is_distributed() or dist.get_world_size() < min_ranks:
        return None
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    world = dist.get_world_size()
    names = tuple(axis_names)
    shape = (world,) + (1,) * (len(names) - 1) if shape is None else tuple(shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover the world of {world} ranks")
    device_type = torch.device(device).type
    key = (id(dist.group.WORLD), device_type, names, shape)
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        if any(k[0] != key[0] for k in _MESHES):
            _MESHES.clear()  # the meshes of a destroyed group are dead
        _MESHES[key] = init_device_mesh(device_type, shape, mesh_dim_names=names)
    return _MESHES[key]


def data_stage_mesh(pp_stages: int, device=None):
    """The ``("data", "stage")`` mesh of the GPipe pipeline (JAX
    ``data_stage_mesh``): ``pp_stages`` ranks along ``"stage"``, the fast
    dim, and the rest along ``"data"``.  Raises when ``pp_stages`` does not
    divide the world (1 without a process group)."""
    n = dist.get_world_size() if is_distributed() else 1
    if n % pp_stages:
        raise ValueError(f"pp_stages={pp_stages} does not divide {n} devices")
    return get_mesh(device, min_ranks=1, axis_names=("data", "stage"),
                    shape=(n // pp_stages, pp_stages))


def mesh_size(mesh, axis: str = AXIS) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.size(mesh.mesh_dim_names.index(axis)))


def mesh_rank(mesh, axis: str = AXIS) -> int:
    """This process's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def mesh_group(mesh, axis: str = AXIS):
    return mesh.get_group(axis)


def has_axis(mesh, axis: str = AXIS) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def is_lead() -> bool:
    """True on the process that writes files (rank 0, or the only one)."""
    return not is_distributed() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op without a group)."""
    if is_distributed():
        dist.barrier()


def lead_first(fn):
    """``fn()`` on rank 0 first, then on the others: for work whose first
    run writes a cache file the others then read (normalization stats)."""
    if not is_lead():
        barrier()
    out = fn()
    if is_lead() and is_distributed():
        barrier()
    return out


def shard_batch(mesh, batch, batch_axis: int = 0, axis: str = AXIS):
    """This rank's contiguous slice of a global batch (a tensor, an array,
    or a dict / list / tuple of them) along ``batch_axis``.

    Leaves with no ``batch_axis`` (scalars) are returned as they are.  A
    batch dim that does not divide by the ranks raises: the JAX package
    replicates such a batch on one host and refuses it across hosts
    (``shard_batch``, JAX ``parallel/mesh.py:112-119``), and a rank of the
    port is a host of its own."""
    n, r = mesh_size(mesh, axis), mesh_rank(mesh, axis)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        if np.ndim(x) <= batch_axis:
            return x
        size = x.shape[batch_axis]
        if size % n:
            raise ValueError(
                f"shard_batch: batch dim {size} not divisible by the {n} ranks "
                f"of mesh axis '{axis}'; replication is not possible across "
                "processes: pad the loader batch")
        m = size // n
        index = [slice(None)] * np.ndim(x)
        index[batch_axis] = slice(r * m, (r + 1) * m)
        return x[tuple(index)]

    return place(batch)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the cotangent is summed the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh, axis: str = AXIS):
    """The sums over the axis's ranks of ``tensors`` (same dtype and
    device), as one all-reduce of their concatenation; differentiable: the
    backward all-reduces the cotangents.  A tuple in the order given."""
    tensors = tuple(tensors)
    if mesh is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    summed = _AllReduceSum.apply(flat, mesh_group(mesh, axis))
    out, at = [], 0
    for t in tensors:
        out.append(summed[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return tuple(out)


class _CopyToRanks(torch.autograd.Function):
    """Megatron's ``f``: identity forward, the cotangents summed over the
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFromRanks(torch.autograd.Function):
    """Megatron's ``g``: the sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, where each rank of ``group`` goes on with its own
    part of the work: the backward sums the ranks' cotangents (the input of
    a column-parallel Linear)."""
    return _CopyToRanks.apply(x, group)


def reduce_from_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``'s ranks of their partial ``x``, where every
    rank then computes the same loss: the backward hands each rank its own
    cotangent, once (the output of a row-parallel Linear; the pipeline's
    output leaving its last stage).  Unlike :func:`all_reduce_sum`, whose
    backward sums the cotangents, right where each rank's loss differs."""
    return _ReduceFromRanks.apply(x, group)


def all_reduce_grads(params, mesh, axis: str = AXIS, mean: bool = True) -> None:
    """Each parameter's gradient summed over ``mesh[axis]`` (averaged with
    ``mean``), as one all-reduce of their concatenation; a parameter
    without a gradient counts zero, and takes the sum as its own."""
    if mesh is None or mesh_size(mesh, axis) == 1:
        return
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh_group(mesh, axis))
    if mean:
        flat /= mesh_size(mesh, axis)
    at = 0
    for p in params:
        p.grad = flat[at:at + p.numel()].view_as(p)
        at += p.numel()


def all_gather_rows(t: torch.Tensor, mesh, axis: str = AXIS) -> torch.Tensor:
    """``[W * n, ...]``: every rank's ``t [n, ...]`` (the same shape on
    every rank) stacked in rank order.  Not differentiable."""
    if mesh is None:
        return t
    t = t.contiguous()
    out = torch.empty((mesh_size(mesh, axis) * t.shape[0], *t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=mesh_group(mesh, axis))
    return out


def agree(value: int, mesh, what: str, axis: str = AXIS) -> int:
    """``value``, after checking that every rank holds the same: ranks that
    disagree on a number of steps or batches would deadlock in the next
    collective, so they raise here instead."""
    if mesh is None:
        return value
    t = torch.tensor([value, -value], dtype=torch.int64, device=mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh_group(mesh, axis))
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise RuntimeError(f"ranks disagree on {what}: from {lo} to {hi}")
    return value


def mesh_device(mesh) -> Optional[torch.device]:
    """The device a rank's tensors take on ``mesh`` (None without one)."""
    if mesh is None:
        return None
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
