"""replays_per_job: work redone per job because the store or the row slots
overflowed (``stats["replayed_supersteps"]`` plus
``stats["slot_grow_events"]``)."""

from kbench.metrics._jobs import per_job


def read(rec):
    return per_job(rec, "replayed_supersteps", "slot_grow_events")
