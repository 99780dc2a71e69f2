"""The one input generator: a random genome drawn from a seed, sampled
into fixed-length reads from both strands, with per-base substitution
errors, written as FASTA.

Its parameters are the union of a configuration's ``input`` (genome
size, coverage, read length, strand mix) and a traffic mix's file
(the error model); a new mix is a new data file, never new code.

The sampler follows ``chip_smoke.write_reads_fasta`` and
``bench.make_reads`` (uniform read starts on a uniform random genome),
adds the reverse strand and draws errors as an exact Bernoulli process
(geometric gaps between error positions), all vectorised in numpy.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
PARAMS = ("genome_bases", "coverage", "read_len", "reverse_share", "substitution_rate")


def rng_for(seed: int) -> np.random.Generator:
    """numpy's generator for any whole-number seed (negative ones too)."""
    return np.random.default_rng(seed & (2 ** 64 - 1))


def error_positions(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    """Positions in [0, n) each hit independently with probability ``rate``."""
    if rate <= 0 or n == 0:
        return np.zeros(0, np.int64)
    mean = n * rate
    pos = np.cumsum(rng.geometric(rate, int(mean + 10 * mean ** 0.5 + 100))) - 1
    while pos[-1] < n:
        more = np.cumsum(rng.geometric(rate, int(10 * mean ** 0.5 + 100))) + pos[-1]
        pos = np.concatenate([pos, more])
    return pos[pos < n]


def sample(params: dict, seed: int) -> dict:
    """Reads as 2-bit codes (n, read_len) uint8, with what made them:
    the genome, each read's start and strand, and the error positions in
    the flattened reads."""
    missing = [p for p in PARAMS if p not in params]
    if missing:
        raise ValueError(f"input parameters missing: {missing}")
    G, L = int(params["genome_bases"]), int(params["read_len"])
    if not 0 < L <= G:
        raise ValueError("read_len must be in [1, genome_bases]")
    rng = rng_for(seed)
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    n = G * int(params["coverage"]) // L
    starts = rng.integers(0, G - L + 1, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, L)[starts]
    reverse = rng.random(n) < float(params["reverse_share"])
    reads[reverse] = 3 - reads[reverse][:, ::-1]
    flat = reads.reshape(-1)
    errors = error_positions(rng, flat.shape[0], float(params["substitution_rate"]))
    flat[errors] = (flat[errors] + rng.integers(1, 4, errors.shape[0], dtype=np.uint8)) & 3
    return dict(genome=genome, starts=starts, reverse=reverse, errors=errors, reads=reads)


def fasta_bytes(reads: np.ndarray) -> bytes:
    """One record a read: ``>r`` and its zero-padded index, then its bases
    on one line."""
    n, L = reads.shape
    w = len(str(max(n - 1, 0)))
    rec = np.empty((n, w + 4 + L), np.uint8)
    rec[:, 0], rec[:, 1] = ord(">"), ord("r")
    idx = np.arange(n)
    for j in range(w):
        rec[:, 2 + j] = ord("0") + idx // 10 ** (w - 1 - j) % 10
    rec[:, w + 2] = ord("\n")
    rec[:, w + 3:w + 3 + L] = ACGT[reads]
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def write_input(path: str, params: dict, seed: int, k: int) -> dict:
    """Write the FASTA for ``seed``; returns its path and sizes: the codes
    the reader yields (bases plus one separator a record) and the valid
    windows."""
    reads = sample(params, seed)["reads"]
    with open(path, "wb") as f:
        f.write(fasta_bytes(reads))
    n, L = reads.shape
    return dict(path=path, codes=n * (L + 1), valid_windows=n * max(L - k + 1, 0))
