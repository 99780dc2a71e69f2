"""Multi-device counting: one process drives a list of devices, one shard
each (the port's counterpart of ``kaarme_tpu/parallel/``'s 1-D mesh).

- ``make_mesh``: the device list (``cuda:0..n-1`` or n CPU shards)
- ``ShardedSortCounter``: the classic sort pipeline per shard
- ``ShardedSkmCounter``: the slotted super-k-mer pipeline per shard
- ``ShardedKmerCounter``: the probe table split by hash prefix
- ``exchange``: the one record exchange they share
"""

from .sharded import ShardedCounterConfig, ShardedKmerCounter, make_mesh
from .sharded_skm import ShardedSkmConfig, ShardedSkmCounter
from .sharded_sort import ShardedSortConfig, ShardedSortCounter

__all__ = ["make_mesh", "ShardedSortConfig", "ShardedSortCounter", "ShardedSkmConfig",
           "ShardedSkmCounter", "ShardedCounterConfig", "ShardedKmerCounter"]
