"""The shared reading of per-job counter statistics."""


def per_job(rec, *keys):
    """The window's total of the ``stats`` entries ``keys`` over its
    whole jobs, divided by their number; None where no job has any."""
    jobs = [j["stats"] for j in rec["jobs"]]
    if not jobs or not any(key in s for s in jobs for key in keys):
        return None
    return sum(s.get(key, 0) for s in jobs for key in keys) / len(jobs)
