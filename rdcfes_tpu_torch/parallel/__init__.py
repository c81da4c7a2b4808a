"""Multi-device runs: the halo-exchange transient system and the solid's
halo Newton (shards in one process, parallel/halo.py and
parallel/solid_halo.py), the replicated-iterate transient system
(parallel/sharding.py), and the transient system's smoke run
(parallel/dryrun.py)."""

from .halo import HaloPlan, HaloShardedSystem, ShardGroup, shard_devices
from .sharding import ShardedTransientSystem, partition_elements
from .solid_halo import HaloSolidSystem

__all__ = ["HaloPlan", "HaloShardedSystem", "HaloSolidSystem", "ShardGroup",
           "ShardedTransientSystem", "partition_elements", "shard_devices"]
