"""bloom_pass1_s: the -b pass 1 per job (``stats["bloom_pass1_seconds"]``,
which ends after ``start_pass2`` reads B1's counters back to the host)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "bloom_pass1_seconds")
