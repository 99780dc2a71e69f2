"""Multi-device and multi-host counting: one process drives a list of
devices, one shard each (the port's counterpart of ``kaarme_tpu/parallel/``'s
1-D mesh), and ``multihost`` runs one such process per host.

- ``make_mesh``: the device list (``cuda:0..n-1`` or n CPU shards)
- ``ShardedSortCounter``: the classic sort pipeline per shard
- ``ShardedSkmCounter``: the slotted super-k-mer pipeline per shard
- ``ShardedKmerCounter``: the probe table split by hash prefix
- ``exchange``: the one record exchange they share
- ``MultiHostSortCounter`` and the rest of ``multihost``: processes in
  lockstep over ``torch.distributed``

The multi-host names are re-exported lazily (PEP 562), as the JAX
package does: ``python -m kaarme_tpu_torch.parallel.multihost`` imports
this package first, and must find its module not yet imported.
"""

from .sharded import ShardedCounterConfig, ShardedKmerCounter, make_mesh
from .sharded_skm import ShardedSkmConfig, ShardedSkmCounter
from .sharded_sort import ShardedSortConfig, ShardedSortCounter

_MULTIHOST = ("MultiHostSortCounter", "HostSpanReader", "init_distributed", "global_mesh",
              "multihost_load")

__all__ = ["make_mesh", "ShardedSortConfig", "ShardedSortCounter", "ShardedSkmConfig",
           "ShardedSkmCounter", "ShardedCounterConfig", "ShardedKmerCounter", *_MULTIHOST]


def __getattr__(name):
    if name in _MULTIHOST:
        from . import multihost

        return getattr(multihost, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
