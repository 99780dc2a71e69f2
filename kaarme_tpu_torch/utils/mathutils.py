"""Sizing helpers of the port: its own copies of ``next_pow2``,
``capacity_log2`` and ``bloom_sizing`` from
``kaarme_tpu/utils/mathutils.py``.  Tables have power-of-two capacities
with mask addressing (the hash gives uniform low bits), probed by the
triangular sequence h + i(i+1)/2, a full cycle mod 2^m."""

from __future__ import annotations

import math


def next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def capacity_log2(min_slots: int) -> int:
    """Table capacity (log2) for a requested minimum slot count."""
    return max(8, (max(1, int(min_slots)) - 1).bit_length())


def bloom_sizing(expected_unique: int, fpr: float):
    """Bloom filter bits (rounded up to a power of two) and #hash functions.

    Mirrors the reference's derivation (reference: main.cpp:400-418):
    bits_min = -U * ln(fpr) / ln(2)^2, rounded UP to a power of two;
    hash functions = ceil((bits_min / U) * ln 2).
    """
    u = max(1, int(expected_unique))
    bits_min = (-float(u) * math.log(fpr)) / (math.log(2) ** 2)
    bits = 2
    while bits < int(bits_min):
        bits *= 2
    hfn = math.ceil((bits_min / u) * math.log(2))
    return bits, max(1, int(hfn))
