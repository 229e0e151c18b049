"""The parallel layers on a mesh of ranks, one rank a process (port of
``multiverso_tpu/parallel``): collectives, sequence, tensor, expert and
pipeline parallelism, and the BSP ``worker_step``."""

from multiverso_tpu_torch.parallel.collectives import (
    all_gather, all_reduce, broadcast, reduce_scatter)
from multiverso_tpu_torch.parallel.mesh import Mesh, P
from multiverso_tpu_torch.parallel.worker_map import make_worker_mesh, worker_step
from multiverso_tpu_torch.parallel.ring import (
    ring_attention, sequence_shard, ulysses_attention,
    zigzag_ring_attention, zigzag_shard_ids)
from multiverso_tpu_torch.parallel.moe import (
    MoEConfig, init_experts, moe_layer, shard_experts)
from multiverso_tpu_torch.parallel.pipeline import (
    pipeline_apply, pipeline_apply_interleaved, shard_stages,
    shard_stages_interleaved)
from multiverso_tpu_torch.parallel.tp import (
    column_parallel, mlp_block, row_parallel, transformer_fsdp_rules,
    transformer_tp_rules)

__all__ = [
    "all_gather", "all_reduce", "broadcast", "reduce_scatter",
    "make_worker_mesh", "worker_step",
    "ring_attention", "sequence_shard", "ulysses_attention",
    "zigzag_ring_attention", "zigzag_shard_ids",
    "MoEConfig", "init_experts", "moe_layer", "shard_experts",
    "pipeline_apply", "pipeline_apply_interleaved", "shard_stages",
    "shard_stages_interleaved",
    "column_parallel", "mlp_block", "row_parallel", "transformer_fsdp_rules",
    "transformer_tp_rules",
    "Mesh", "P",
]
