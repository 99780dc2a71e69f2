"""write_s: the count file's write per job (``stats["write_seconds"]``:
the skm finalize, W1, the copy to pinned memory and the file write,
ending in a stream synchronise)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "write_seconds")
