"""Device-mesh parallelism: shot sharding, check-partition sharding,
rounds-axis sharding, and the fused sample+decode pipeline.

The reference's only distribution strategy is a CPU process pool over
shots (``/root/reference/python/qldpc/misc/p_sweep.py:18-29``); this
package is the device-mesh replacement (SURVEY.md §2.4).
"""
from .check_shard import ShardedBPDecoder, ShardedTanner
from .mesh import DATA_AXIS, MODEL_AXIS, init_distributed, make_mesh
from .pipeline import StorageDecodePipeline
from .rounds_shard import RoundsShardedSpacetimeBP

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "init_distributed",
    "make_mesh",
    "StorageDecodePipeline",
    "ShardedBPDecoder",
    "ShardedTanner",
    "RoundsShardedSpacetimeBP",
]
