"""The generator: determined by its seed, with the stated error rate and
strand mix, and FASTA the reference reads back."""

import numpy as np
import torch

from kbench import gen
from kbench.reference import kmer_count as ref

P = dict(genome_bases=50_000, coverage=30, read_len=150, reverse_share=0.5,
         substitution_rate=0.01)


def test_same_seed_same_reads_other_seed_other_reads():
    a, b = gen.sample(P, 2**31 + 7), gen.sample(P, 2**31 + 7)
    c = gen.sample(P, 2**31 + 8)
    assert all(np.array_equal(a[key], b[key]) for key in a)
    assert not np.array_equal(a["reads"], c["reads"])
    assert gen.fasta_bytes(a["reads"]) == gen.fasta_bytes(b["reads"])
    assert gen.sample(P, -3)["reads"].shape == a["reads"].shape


def test_error_rate_and_strand_mix_are_as_stated():
    s = gen.sample(P, 11)
    n, L = s["reads"].shape
    assert n == P["genome_bases"] * P["coverage"] // L
    truth = s["genome"][s["starts"][:, None] + np.arange(L)]
    truth[s["reverse"]] = 3 - truth[s["reverse"]][:, ::-1]
    wrong = s["reads"] != truth
    assert wrong.sum() == s["errors"].shape[0]          # a substitution always changes the base
    mean, sd = n * L * 0.01, (n * L * 0.01 * 0.99) ** 0.5
    assert abs(wrong.sum() - mean) < 5 * sd
    assert abs(s["reverse"].mean() - 0.5) < 5 * (0.25 / n) ** 0.5
    clean = gen.sample(dict(P, substitution_rate=0.0), 11)
    assert clean["errors"].shape == (0,)


def test_error_positions_are_bernoulli():
    pos = gen.error_positions(gen.rng_for(5), 1_000_000, 0.02)
    assert np.all(np.diff(pos) > 0) and pos[-1] < 1_000_000
    assert abs(pos.shape[0] - 20_000) < 5 * (20_000 * 0.98) ** 0.5


def test_fasta_round_trips_through_the_reference_parser():
    s = gen.sample(dict(P, genome_bases=3000), 4)
    buf = torch.frombuffer(bytearray(gen.fasta_bytes(s["reads"])), dtype=torch.uint8)
    codes = ref.codes_from_fasta(buf)
    L = s["reads"].shape[1]
    rows = codes.numpy().reshape(s["reads"].shape[0], -1)
    # each record: its header as breaks, then its bases
    assert np.array_equal(rows[:, -L:], s["reads"])
    assert np.all(rows[:, :-L] == 4)
