from .mesh import (
    DPBatch,
    DPOptState,
    Mesh,
    dp_mapping_step,
    dp_refine_step,
    gather,
    make_dp_opt_state,
    make_mesh,
    replicate,
    shard,
    shard_batch,
)

__all__ = [
    "DPBatch",
    "DPOptState",
    "Mesh",
    "dp_mapping_step",
    "dp_refine_step",
    "gather",
    "make_dp_opt_state",
    "make_mesh",
    "replicate",
    "shard",
    "shard_batch",
]
