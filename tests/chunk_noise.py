"""Transfer chunks with what K1, K3 and K5 must ignore, for their chunk
tests (``test_torch_skm_rows.py``, ``test_torch_slotted.py`` and
``test_torch_winkeys.py`` on the CPU, ``test_torch_cuda.py`` on the
card, where JAX is not installed)."""

import numpy as np


def _fill_past(words: np.ndarray, L: int, per: int, rng) -> np.ndarray:
    """``words`` (``per`` positions a word) and one more word, with random
    bits at every position at or past L."""
    w = np.concatenate([words, np.zeros(1, np.uint32)]).astype(np.uint64)
    live = np.clip(L - per * np.arange(w.shape[0]), 0, per) * (32 // per)
    keep = (np.uint64(1) << live.astype(np.uint64)) - np.uint64(1)
    noise = rng.integers(0, 1 << 32, w.shape[0], dtype=np.uint64)
    return ((w & keep) | (noise & ~keep & np.uint64(0xFFFFFFFF))).astype(np.uint32)


def noisy_tail(packed: np.ndarray, bits: np.ndarray, L: int, seed: int) -> tuple:
    """A chunk of L positions (uint32 2-bit words, uint32 separator bitmap)
    with one more word of each and random bases and bitmap bits at every
    position at or past L, set bits among them.  Positions at or past L
    are invalid whatever the chunk holds, so no result may change."""
    rng = np.random.default_rng(seed)
    return _fill_past(packed, L, 16, rng), _fill_past(bits, L, 32, rng)
