"""count_s: the counter's own count time per job (``stats["build_seconds"]``,
which ends in ``finish()``'s verifying drain; with ``-b`` pass 2 alone)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "build_seconds")
