"""The port's distribution layer: the process group as a device mesh
(``mesh``), FSDP2 sharding (``fsdp``), the sequence-parallel WPT
(``sequence``), and the AST's model-parallel modes: Megatron tensor
parallelism (``tensor``) and the GPipe pipeline (``pipeline``);
counterpart of ``audiodeepfake_detection_tpu/parallel/``."""

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
    all_reduce_grads,
    all_reduce_sum,
    copy_to_ranks,
    data_stage_mesh,
    get_mesh,
    mesh_rank,
    mesh_size,
    reduce_from_ranks,
    shard_batch,
)
from .pipeline import (  # noqa: F401
    combine_pp_grads,
    make_pp_train_step,
    make_pp_trainer_step,
    pipeline_encode,
    pp_ast_logits,
    stage_blocks,
)
from .sequence import sp_wpt_analysis, sp_wpt_min_len  # noqa: F401
from .tensor import ast_param_specs, full_ast_state, shard_ast_params  # noqa: F401
