"""Parallelism: sequence (context) parallelism over a ring of token shards;
meshes of ranks with JAX's DiT sharding rules (data parallelism, FSDP,
tensor and expert parallelism, `mesh.py`) and the collectives they use
(`collectives.py`); GPipe pipeline parallelism over the block stack
(`pipeline.py`) and PipeFusion's patch-pipelined sampling (`pipefusion.py`)."""

from .collectives import (all_gather, all_reduce, broadcast, copy_to_group, full,
                          reduce_from_group, reduce_scatter)
from .mesh import (Mesh, Sharding, batch_rows, create_expert_mesh, create_mesh, dit_param_spec,
                   param_shardings, shard_params)
from .pipefusion import init_kv_cache, pipefusion_forward, pipefusion_sample_loop
from .pipeline import (LocalStages, ProcessGroupStages, create_pipeline_groups,
                       dit_pipeline_forward, pipeline_apply)
from .sequence import (LocalRing, ProcessGroupRing, create_seq_groups,
                       dit_sequence_parallel_forward, sequence_parallel_stack)

__all__ = ["LocalRing", "ProcessGroupRing", "create_seq_groups",
           "dit_sequence_parallel_forward", "sequence_parallel_stack", "Mesh", "Sharding",
           "create_mesh", "create_expert_mesh", "dit_param_spec", "param_shardings",
           "shard_params", "batch_rows", "all_reduce", "all_gather", "reduce_scatter",
           "broadcast", "copy_to_group", "reduce_from_group", "full",
           "LocalStages", "ProcessGroupStages", "create_pipeline_groups", "pipeline_apply",
           "dit_pipeline_forward", "init_kv_cache", "pipefusion_forward",
           "pipefusion_sample_loop"]
