"""Sequence-parallel WPT: the time axis sharded over the ranks, with a halo.

Counterpart of ``audiodeepfake_detection_tpu/parallel/sequence.py``.  The
WPT is parallel across time within a level and sequential across levels,
so for long clips (the level-14 fingerprints of whole recordings,
reference scripts/freq_visual/fingerprints.py:105) each rank takes one
contiguous block of the time axis and the ranks exchange only the filter
halo per level.

With ptwt's padding (``padl = (2L-3)//2`` left, ``padr = padl + n % 2``
right), each level's output splits into

* an *interior* of ``m/2`` coefficients per rank, whose stride-2 windows
  touch only the rank's own samples plus ``padl`` samples of its left
  neighbour (the halo; rank 0 takes the reflect pad of the global left
  edge instead); and
* a *boundary tail* of ``tail' = (tail + L - 1)//2`` coefficients made by
  the right reflect pad, which depends only on the global right edge, so
  the last rank, which holds it, computes it.

Every rank carries ``[B, N, m + tail]`` per level, the trailing ``tail``
columns meaningful on the last rank only (the next level's halo is sliced
from the interior end, never from them).  Each level is one stride-2 VALID
``F.conv1d``, as JAX's ``conv_general_dilated`` is: a plain product outside
any kernel, the dense cascade's own (``ops/wpt.py::dwt_level``).  At the
end the last rank's tail is summed over the ranks under a mask (the JAX
``psum``), the interiors are gathered in rank order, and the Gray-code
order is applied.

The halo and the interiors travel by ``all_gather_into_tensor`` and the
tail by ``all_reduce``: collectives that NCCL and gloo both run on CUDA
tensors (``tools/dist_probe.py``; gloo's point-to-point is what it does
not).  The input is the whole clip on every rank and the output the whole
transform on every rank, as the JAX function takes and returns global
arrays.

Requirement: the clip length divides by ``ranks * 2**level`` and the
per-rank blocks stay longer than the filter's overhang at the deepest
level (:func:`sp_wpt_min_len` says how long a clip must be).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.wavelets import get_wavelet
from ..ops.wpt import _gray_index_tensor, dec_kernel
from .mesh import AXIS, all_gather_rows, all_reduce_sum, mesh_rank, mesh_size


def sp_wpt_min_len(wavelet_name: str, level: int, shards: int) -> int:
    """Smallest aligned clip length :func:`sp_wpt_analysis` accepts: a
    multiple of ``shards * 2**level`` whose per-rank interiors at the
    deepest level outlast the filter's overhang (JAX ``sp_wpt_min_len``).
    Callers crop a clip to a multiple of ``shards * 2**level`` and compare
    it with this, so the rule lives in one place."""
    filt_len = len(get_wavelet(wavelet_name).dec_lo)
    padl = (2 * filt_len - 3) // 2
    block = shards * 2**level
    # need 2 * (t // block) >= padl + 1 with t a multiple of block
    blocks = max(1, -(-(padl + 1) // 2))
    return blocks * block


def _sp_dwt_level(x: torch.Tensor, kernel: torch.Tensor, mesh, axis: str, m: int, g: int,
                  shards: int) -> torch.Tensor:
    """One analysis level on this rank's block ``[B, N, m + tail]``.

    ``m`` is the per-rank interior length, ``g`` the global dense length at
    this level; ``tail = g - shards * m`` trailing columns are meaningful
    on the last rank only.  Returns ``[B, 2N, m/2 + tail']``."""
    filt_len = kernel.shape[-1]
    padl = (2 * filt_len - 3) // 2
    tail = g - shards * m
    padr = padl + (g % 2)
    rank = mesh_rank(mesh, axis)
    parts = []
    if padl > 0:
        # every rank's last `padl` interior samples, gathered; a rank takes
        # its left neighbour's, rank 0 the reflect pad of the global edge
        edges = all_gather_rows(x[None, ..., m - padl:m], mesh, axis)
        halo = edges[rank - 1] if rank > 0 else x[..., 1:padl + 1].flip(-1)
        parts.append(halo)
    parts.append(x)
    if padr > 0:
        # the global signal's right reflect pad: meaningful on the last rank
        # only, whose block ends at the global end
        n_loc = m + tail
        parts.append(x[..., n_loc - 1 - padr:n_loc - 1].flip(-1))
    x_ext = torch.cat(parts, dim=-1) if len(parts) > 1 else x
    b, nodes, n_ext = x_ext.shape
    # one VALID conv over [padl + m + tail + padr]: m/2 interior outputs,
    # then tail' boundary outputs (the last window ends on the last pad)
    y = F.conv1d(x_ext.reshape(b * nodes, 1, n_ext), kernel, stride=2)
    n_out = m // 2 + (tail + filt_len - 1) // 2
    if y.shape[-1] != n_out:
        raise AssertionError((y.shape, m, tail, filt_len))
    return y.reshape(b, 2 * nodes, n_out)


def sp_wpt_analysis(x: torch.Tensor, wavelet_name: str, level: int, mesh,
                    axis: str = AXIS) -> torch.Tensor:
    """Time-sharded WPT over ``mesh``: ``[B, T] -> [B, 2**level, n_level]``.

    ``x`` is the whole clip on every rank; each rank transforms its block
    of ``T / ranks`` samples and every rank returns the whole transform.
    ``T`` must divide by ``ranks * 2**level``.  Node order is the Gray-code
    frequency order and ``n_level`` the pywt length rule ``n' = (n + L -
    1)//2`` applied ``level`` times: a drop-in equal (to float32 roundoff)
    of ``ops.wpt.wpt_analysis``, boundary coefficients included.
    """
    shards = mesh_size(mesh, axis)
    rank = mesh_rank(mesh, axis)
    t = x.shape[-1]
    if t % (shards * 2**level):
        raise ValueError(
            f"clip length {t} must divide by shards*2**level = {shards * 2**level}")
    kernel = dec_kernel(wavelet_name, str(x.device)).to(x.dtype)
    filt_len = int(kernel.shape[-1])
    padl = (2 * filt_len - 3) // 2
    if 2 * (t // (shards * 2**level)) < padl + 1:
        raise ValueError(
            f"per-shard block too short for {wavelet_name} at level {level}: "
            f"need T >= shards * 2**(level-1) * {padl + 1}")
    m, g = t // shards, t
    y = x[:, None, rank * m:(rank + 1) * m]
    for _ in range(level):
        y = _sp_dwt_level(y, kernel, mesh, axis, m, g, shards)
        m, g = m // 2, (g + filt_len - 1) // 2
    parts = [all_gather_rows(y[None, ..., :m].contiguous(), mesh, axis)
             .permute(1, 2, 0, 3).reshape(*y.shape[:2], shards * m)]
    if y.shape[-1] > m:
        # only the last rank's tail is the global boundary: a masked sum
        tail = y[..., m:] if rank == shards - 1 else torch.zeros_like(y[..., m:])
        parts.append(all_reduce_sum((tail,), mesh, axis)[0])
    y = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    return y.index_select(1, _gray_index_tensor(level, str(x.device)))
