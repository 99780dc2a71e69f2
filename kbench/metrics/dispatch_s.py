"""dispatch_s: the host's time per job to enqueue the supersteps' kernels
and glue (``stats["dispatch_seconds"]``, the program's ``dispatch``
spans, replays and the ``-b`` pass-1 supersteps included); the bound on
the count when it nears the device's busy time."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "dispatch_seconds")
