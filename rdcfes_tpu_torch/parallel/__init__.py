"""Multi-device runs: the halo-exchange transient system (shards in one
process, parallel/halo.py) and its smoke run (parallel/dryrun.py)."""

from .halo import (ITEM_14B, HaloPlan, HaloShardedSystem, ShardGroup,
                   shard_devices)

__all__ = ["ITEM_14B", "HaloPlan", "HaloShardedSystem", "ShardGroup",
           "shard_devices"]
