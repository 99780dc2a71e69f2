"""exchange_s: the sharded counters' finalize exchange per job
(``stats["exchange_seconds"]``, the ``exchange`` span: each shard's
finalize, the routing of every live record to the shard that owns its
key, the copies between cards and each shard's compaction)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "exchange_seconds")
