"""The port's distribution layer: the process group as a ``"data"`` mesh
(``mesh``), FSDP2 sharding (``fsdp``) and the sequence-parallel WPT
(``sequence``); counterpart of ``audiodeepfake_detection_tpu/parallel/``.
Tensor and pipeline parallelism (JAX ``tensor.py``, ``pipeline.py``) are
not ported yet (ROADMAP.md, slice 7b)."""

from .fsdp import (  # noqa: F401
    full_model_state,
    full_optimizer_state,
    fsdp_units,
    load_full_model_state,
    load_full_optimizer_state,
    shard_dim,
    shard_fsdp,
)
from .mesh import (  # noqa: F401
    all_gather_rows,
    all_reduce_sum,
    get_mesh,
    mesh_rank,
    mesh_size,
    shard_batch,
)
from .sequence import sp_wpt_analysis, sp_wpt_min_len  # noqa: F401
