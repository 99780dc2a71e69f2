"""finalize_s: the skm finalize per job (``stats["finalize_seconds"]``, the
program's ``finalize`` span: the run store expanded into k-mer keys,
sorted and summed, ending in the read of its size); ``write_s`` less
this is the count file's text path."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "finalize_seconds")
