"""The H100's memory peak and the least-time arithmetic of a roofline
share (a copy of ``chip_smoke.HBM_BYTES_PER_S`` and of ``bound`` where
bytes set it).

Peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
HBM at 3.35 TB/s.  The work a counting job must do is moving bytes; no
operation count is taken.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float) -> float:
    """The least seconds in which the card moves ``nbytes`` once."""
    return nbytes / HBM_BYTES_PER_S


def job_bytes(codes: int, store_rows: int, key_words: int, text_bytes: int) -> int:
    """The least bytes a counting job moves on the card: its 2-bit codes
    read once, its distinct store rows (32-bit key words and a 32-bit
    count) written once and its count file's text written once."""
    return codes // 4 + store_rows * 4 * (key_words + 1) + text_bytes
