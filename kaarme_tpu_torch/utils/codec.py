"""Host-side 2-bit DNA codec and FASTA/FASTQ stripping of the port — its
own copy of the parts of ``kaarme_tpu/utils/codec.py`` that it calls
(the string oracle ``golden_count`` stays in the JAX package, where the
tests take it from).

Semantics replicate the reference counter (Kaarme):

- base mapping A/a=0, C/c=1, G/g=2, T/t=3, anything else = 4 = RESET
  (reference: source/functions_strings.cpp:56-70 ``char2int``);
- plain ("one string per line") input: every byte goes through the map,
  so a newline is a reset (reference: include/parallel_parser.hpp:1331-1336);
- FASTA input: a ``>`` anywhere starts a header that is skipped up to the
  next newline and resets the window; newlines inside sequence are skipped
  (windows span wrapped lines); other invalid bytes reset
  (reference: include/parallel_parser.hpp:1398-1432);
- canonical k-mer = lexicographic min of the window and its reverse
  complement under A<C<G<T; ties pick forward
  (reference: source/kmer_factory.cpp:219-233).

The encoded stream is a ``uint8`` array of codes in {0,1,2,3,4}; code 4 is
a window separator ("reset").  Everything downstream consumes this stream.
"""

from __future__ import annotations

import numpy as np

SEP = np.uint8(4)

# 256-entry byte -> code lookup table.
BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    BASE_LUT[_b] = _i
for _i, _b in enumerate(b"acgt"):
    BASE_LUT[_b] = _i

_COMP = str.maketrans("ACGT", "TGCA")


def _as_u8(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return buf.view(np.uint8).ravel()
    return np.frombuffer(buf, dtype=np.uint8)


def encode_plain(buf) -> np.ndarray:
    """Encode a plain-text buffer: one read per line; newline == reset."""
    return BASE_LUT[_as_u8(buf)]


def encode_fasta(buf, prev_in_header: bool = False):
    """Encode a FASTA buffer chunk.

    Header bytes (from any ``>`` up to and including the next newline) are
    replaced by a single separator code 4; sequence newlines are dropped;
    other bytes go through the base map.

    Returns ``(codes, ended_in_header)`` where ``ended_in_header`` is the
    carry flag for the next chunk (the chunk ended mid-header line).
    """
    a = _as_u8(buf)
    n = a.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.uint8), prev_in_header

    nl = a == 0x0A
    gt = a == 0x3E
    idx = np.arange(n, dtype=np.int64)

    # Last '>' / last newline position at-or-before each byte.  A virtual
    # '>' at -1 models a header broken across the previous chunk.
    last_gt = np.maximum.accumulate(np.where(gt, idx, np.int64(-3)))
    if prev_in_header:
        last_gt = np.maximum(last_gt, np.int64(-1))
    last_nl = np.maximum.accumulate(np.where(nl, idx, np.int64(-2)))
    in_header = last_gt > last_nl  # at a newline itself this is False

    # A newline terminates a header iff the header was open just before it.
    last_nl_prev = np.empty_like(last_nl)
    last_nl_prev[0] = np.int64(-2)
    last_nl_prev[1:] = last_nl[:-1]
    nl_ends_header = nl & (last_gt > last_nl_prev)

    keep = ~nl & ~in_header
    vals = BASE_LUT[a]
    vals = np.where(nl_ends_header, SEP, vals)
    out = vals[keep | nl_ends_header]
    return out, bool(in_header[-1])


FASTQ_STATE0 = (0, 0, 0)  # (state, seq_len, qual_len) at stream start


def encode_fastq(buf, state=FASTQ_STATE0):
    """Encode a FASTQ buffer chunk (pure-Python fallback; the C++ state
    machine in csrc/host/_fastio.cpp is the fast path — semantics
    identical).

    Returns (codes, state) where state carries (parser state, seq bytes,
    qual bytes) across chunk boundaries.  The reference never implemented
    FASTQ (include/parallel_parser.hpp "Not implemented yet"); this
    framework supports it as a capability superset.
    """
    a = _as_u8(buf)
    st, sl, ql = state
    out = np.empty(a.shape[0] + 1, np.uint8)
    o = 0
    for b in a.tolist():
        if st == 0:          # header line
            if b == 0x0A:
                st, sl, ql = 1, 0, 0
                out[o] = 4
                o += 1
        elif st == 1:        # sequence
            if b == 0x0A:
                st = 2
            else:
                out[o] = BASE_LUT[b]
                o += 1
                sl += 1
        elif st == 2:        # sequence, just after newline
            if b == 0x2B:    # '+'
                st = 3
            elif b != 0x0A:
                st = 1
                out[o] = BASE_LUT[b]
                o += 1
                sl += 1
        elif st == 3:        # '+' line
            if b == 0x0A:
                st = 4
        elif st == 4:        # quality
            if b == 0x0A:
                if ql >= sl:
                    st = 5
            else:
                ql += 1
        else:                # between records
            if b != 0x0A:
                st = 0
    return out[:o].copy(), (st, sl, ql)


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def canonical(s: str) -> str:
    """Canonical orientation: min(s, revcomp(s)), ties -> forward."""
    rc = revcomp(s)
    return s if s <= rc else rc


# ---------------------------------------------------------------------------
# Packed-key helpers (host mirrors of the device packing)
# ---------------------------------------------------------------------------

def words_per_kmer(k: int) -> int:
    """Number of uint32 words per packed k-mer: 16 bases per word."""
    return (k + 15) // 16


def pack_kmer(s: str) -> np.ndarray:
    """Pack a k-length ACGT string into big-endian uint32 words.

    Base i sits in word i//16 at bit 30 - 2*(i%16); the trailing partial
    word is left-aligned (low bits zero), so lexicographic string order ==
    numeric order of the word tuple.
    """
    k = len(s)
    w = words_per_kmer(k)
    out = np.zeros(w, dtype=np.uint32)
    for i, ch in enumerate(s):
        c = BASE_LUT[ord(ch)]
        if c > 3:
            raise ValueError(f"invalid base {ch!r}")
        out[i // 16] |= np.uint32(c) << np.uint32(30 - 2 * (i % 16))
    return out


def unpack_kmers(words: np.ndarray, k: int) -> list:
    """Vectorized unpack of an (N, W) array of packed keys to N strings."""
    words = np.asarray(words, dtype=np.uint32)
    if words.ndim == 1:
        words = words[None, :]
    n = words.shape[0]
    codes = np.empty((n, k), dtype=np.uint8)
    for i in range(k):
        codes[:, i] = (words[:, i // 16] >> np.uint32(30 - 2 * (i % 16))) & np.uint32(3)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    chars = lut[codes]
    return [chars[j].tobytes().decode() for j in range(n)]
