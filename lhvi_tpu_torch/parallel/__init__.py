"""Chain, particle and factor-axis sharding of the port over
``torch.distributed``."""

from lhvi_tpu_torch.parallel.mesh import (
    ChainShard,
    all_reduce,
    assemble_rows,
    chain_sharding,
    init_distributed,
    local_count,
    n_chain_shards,
    replicas_equal,
    shard_fg_factors,
    split_generator,
)

__all__ = [
    "ChainShard",
    "all_reduce",
    "assemble_rows",
    "chain_sharding",
    "init_distributed",
    "local_count",
    "n_chain_shards",
    "replicas_equal",
    "shard_fg_factors",
    "split_generator",
]
