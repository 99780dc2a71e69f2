"""pack_wait_s: the time per job that dispatch waited for the host's pack
of the next superstep (``stats["pack_wait_seconds"]``, the program's
``pack_wait`` span around the pack worker's result)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "pack_wait_seconds")
