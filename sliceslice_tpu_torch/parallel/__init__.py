"""Distribution layer: the mesh of cells, the sharded corpus scanner and
the multi-process bring-up on ``torch.distributed`` (counterpart of
``sliceslice_tpu/parallel``)."""

from .distributed import gather_positions
from .mesh import DATA_AXIS, NEEDLE_AXIS, corpus_sharding, make_mesh, table_sharding
from .scaling import format_report, measure_scaling
from .shard_scan import (
    ShardedBatchedSearcher,
    sharded_count_cols,
    sharded_find_cols,
    sharded_positions,
)

__all__ = [
    "DATA_AXIS",
    "NEEDLE_AXIS",
    "make_mesh",
    "corpus_sharding",
    "table_sharding",
    "sharded_find_cols",
    "sharded_count_cols",
    "sharded_positions",
    "gather_positions",
    "ShardedBatchedSearcher",
    "measure_scaling",
    "format_report",
]
