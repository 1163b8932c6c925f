"""Many streams, and one map, over a device or over several processes.

- ``MultiStreamVO``: S streams as one batched step on one device, or split
  over the ranks of a ``torch.distributed`` group.
- ``ShardedMapVO``: one stream whose map-point pool is split over the ranks
  of a group; ``sharded_match_descriptors`` and ``map_partition_specs``
  are its matcher and its layout, ``shard_state`` cuts a whole state
  (a loaded checkpoint) to a rank's block.
- ``open_group``: the process group they run on.

Counterpart of ``rgbd_visualodometry_tpu.parallel``; the cross-rank
primitives the pipeline calls are in ``ops.collectives``.
"""

from rgbd_visualodometry_tpu_torch.parallel.mesh import (
    MultiStreamVO,
    ShardedMapVO,
    map_partition_specs,
    open_group,
    shard_state,
    sharded_match_descriptors,
)

__all__ = ["MultiStreamVO", "ShardedMapVO", "map_partition_specs", "open_group", "shard_state",
           "sharded_match_descriptors"]
