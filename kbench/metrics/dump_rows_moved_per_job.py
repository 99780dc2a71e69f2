"""dump_rows_moved_per_job: store rows that the sharded counters' dump
copied off the shard that held them, to their key range's card, per job
(``stats["dump_rows_moved"]``)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "dump_rows_moved")
