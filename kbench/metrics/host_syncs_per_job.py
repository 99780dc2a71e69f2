"""host_syncs_per_job: the calls per job that block the host on the card
(``stats["host_syncs"]``, the program's counter: verification reads,
the finalize's size reads, the writer's line counts and synchronise)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "host_syncs")
