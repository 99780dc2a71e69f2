"""reader_wait_s: the time per job that the count waited for the reader's
next chunk (``stats["reader_wait_seconds"]``, the program's
``reader_wait`` span around the prefetch queue's get; both passes with
``-b``)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "reader_wait_seconds")
