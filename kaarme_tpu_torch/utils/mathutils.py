"""Sizing helpers of the port: its own copy of ``bloom_sizing`` from
``kaarme_tpu/utils/mathutils.py``."""

from __future__ import annotations

import math


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
