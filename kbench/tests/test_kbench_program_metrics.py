"""The readers of the program's own spans and counters (reader_wait_s,
pack_wait_s, dispatch_s, finalize_s, host_syncs_per_job) on made-up
records, and nothing where the program wrote no such key."""

import pytest

from kbench import run

STATS = [dict(build_seconds=0.5, reader_wait_seconds=0.20, pack_wait_seconds=0.03,
              dispatch_seconds=0.05, finalize_seconds=0.60, host_syncs=9),
         dict(build_seconds=0.7, reader_wait_seconds=0.30, pack_wait_seconds=0.01,
              dispatch_seconds=0.07, finalize_seconds=0.70, host_syncs=11)]


def rec(stats):
    return dict(k=51, jobs=[dict(seconds=1.0, stats=s) for s in stats], trace=None,
                input=dict(path="", codes=10, valid_windows=10),
                judged=dict(store_rows=1, key_words=4, text_bytes=1))


@pytest.mark.parametrize("name,want", [
    ("reader_wait_s", 0.25), ("pack_wait_s", 0.02), ("dispatch_s", 0.06),
    ("finalize_s", 0.65), ("host_syncs_per_job", 10.0),
])
def test_program_readers_on_a_record(name, want):
    assert run.reader(name)(rec(STATS)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["reader_wait_s", "pack_wait_s", "dispatch_s", "finalize_s",
                                  "host_syncs_per_job"])
def test_program_readers_return_nothing_without_their_key(name):
    # a program without the tracer: only the keys it kept before
    old = [dict(build_seconds=0.5, write_seconds=0.2, replayed_supersteps=1)]
    assert run.reader(name)(rec(old)) is None
    assert run.reader(name)(rec([])) is None


def test_a_job_without_the_key_counts_as_zero():
    assert run.reader("host_syncs_per_job")(rec([STATS[0], {}])) == pytest.approx(4.5)
