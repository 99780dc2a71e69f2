"""range_dump_s: the sharded counters' key-range dump per job
(``stats["range_dump_seconds"]``, the ``range_dump`` span: the split
keys, each range's slices copied to its card and merged there, ending
in one synchronise a card)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "range_dump_seconds")
