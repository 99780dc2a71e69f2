"""Run rows for E1's tests (``test_torch_expand.py`` on the CPU,
``test_torch_cuda.py`` on the card, where JAX is not installed)."""

import numpy as np

from kaarme_tpu_torch.ops.cuda_skm import EBITS, LMAX, content_words

KS = [16, 17, 31, 32, 33, 48, 51, 63, 101, 201]
# counts of live runs at the clamp's edges, dead runs (0, and negative,
# which no run store holds), and run lengths 1 .. 16 in every pairing
COUNTS = [1, 2, 1 << 20, (1 << 20) + 1, 0, 3, -1, 7, 2**31 - 1, -(2**31)]


def run_rows(R: int, k: int, seed: int, negative: bool = True) -> list:
    """R run rows (Wc content words, meta, count) as int32 numpy columns:
    random bases and meta bits around ell - 1 in bits 26-29; ell cycles
    1 .. 16 within each 16 rows, which share a count of the COUNTS cycle
    (without its negative ones unless ``negative``); every 9th row is a
    padding row (all-ones words, count 0)."""
    rng = np.random.default_rng(seed)
    Wc = content_words(k)
    cols = [rng.integers(0, 1 << 32, R, dtype=np.uint64).astype(np.uint32) for _ in range(Wc)]
    ell = np.arange(R) % LMAX + 1
    meta = rng.integers(0, 1 << 32, R, dtype=np.uint64).astype(np.uint32)
    meta = (meta & ~np.uint32(15 << EBITS)) | ((ell - 1).astype(np.uint32) << EBITS)
    counts = [c for c in COUNTS if negative or c >= 0]
    cnt = np.array(counts, dtype=np.int32)[np.arange(R) // LMAX % len(counts)]
    cols = [c.view(np.int32) for c in cols] + [meta.view(np.int32), cnt]
    for c in cols[:-1]:
        c[8::9] = -1
    cols[-1][8::9] = 0
    return cols
