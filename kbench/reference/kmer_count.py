"""Plain reference for the k-mer counting configurations: exact canonical
k-mer counts of a FASTA file and the count file they make, in plain
PyTorch (CPU or card), written from the count file's definition alone.

- A record's sequence is its lines after the ``>`` header, joined;
  ``ACGT`` (either case) are bases 0-3, every other byte, and every
  header, breaks the sequence.
- A valid window is k consecutive bases of one record.  Its key is the
  smaller, as an ``A < C < G < T`` string, of the window and its reverse
  complement (the window on a tie), held as ceil(k / 31) int64 words
  of 31 bases (the last word the rest), first base in the high bits,
  so that rows compare as the strings do.
- The count file has one ``KMER COUNT`` line per key whose count,
  clipped (mode 0: ``count & 0xFFFF``; modes 1 and 2: ``min(count,
  16383)``), is at least ``-a``; the sort backend writes them in key
  order.

A file is counted in key-hash parts (``count_part``), one part to a card
of the cell: ``part_of`` assigns every key row a part by a 64-bit mix of
its own words (nothing of the program's routing), and part p is counted
on its card from the whole file, read in blocks of whole lines, so that
no card holds more than one part's rows or one block's temporaries.

Imports torch and numpy alone: nothing of the program, nor JAX.
"""

from __future__ import annotations

import numpy as np
import torch

WORD = 31                  # bases per int64 key word
BLOCK = 1 << 24            # window starts counted, or file bytes decoded, at a time
ROWS = 1 << 22             # rows rendered at a time
MAX_DIGITS = 5             # a clipped count is at most 65535


def key_words(k: int) -> int:
    return -(-k // WORD)


def codes_from_fasta(buf: torch.Tensor) -> torch.Tensor:
    """FASTA bytes (uint8 tensor) -> codes (uint8: 0-3 bases, 4 breaks),
    newlines dropped, each header line a run of breaks."""
    lut = torch.full((256,), 4, dtype=torch.uint8, device=buf.device)
    for i, b in enumerate(b"ACGT"):
        lut[b] = lut[b + 32] = i
    nl = buf == ord("\n")
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=buf.device),
                        torch.nonzero(nl).flatten() + 1])
    header_line = buf[starts.clamp(max=max(buf.numel() - 1, 0))] == ord(">")
    line = torch.cumsum(nl, 0) - nl.to(torch.int64)
    codes = torch.where(header_line[line], 4, lut[buf.to(torch.int64)]).to(torch.uint8)
    return codes[~nl | header_line[line]]


def _runs(c: torch.Tensor, L: int, reverse: bool) -> torch.Tensor:
    """For each start p in [0, len(c) - L]: the L codes from p as one
    integer, c[p] in the highest two bits; with ``reverse``, their
    complements with c[p] in the lowest two bits (the reverse complement
    of the run, read forward).  Built from runs of doubling length."""
    n = c.shape[0] - L + 1
    lev = (3 - c if reverse else c).to(torch.int64)
    levels, size = {1: lev}, 1
    while 2 * size <= L:
        m = lev.shape[0] - size
        lev = (lev[:m] | (lev[size:size + m] << 2 * size) if reverse
               else (lev[:m] << 2 * size) | lev[size:size + m])
        size *= 2
        levels[size] = lev
    out = torch.zeros(n, dtype=torch.int64, device=c.device)
    off = 0
    for size in sorted(levels, reverse=True):
        if L - off >= size:
            part = levels[size][off:off + n]
            out = out | (part << 2 * off) if reverse else (out << 2 * size) | part
            off += size
    return out


def window_keys(c: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical keys (n_valid, key_words(k)) int64 of the valid windows
    of codes ``c``, in window order."""
    n = c.shape[0] - k + 1
    W = key_words(k)
    if n <= 0:
        return torch.zeros((0, W), dtype=torch.int64, device=c.device)
    r = k - WORD * (W - 1)
    full_f = _runs(c, WORD, False) if W > 1 else None
    full_r = _runs(c, WORD, True) if W > 1 else None
    fwd = [full_f[WORD * j:WORD * j + n] for j in range(W - 1)]
    fwd.append(_runs(c, r, False)[WORD * (W - 1):WORD * (W - 1) + n])
    rev = [full_r[k - WORD * (j + 1):k - WORD * (j + 1) + n] for j in range(W - 1)]
    rev.append(_runs(c, r, True)[:n])
    fwd_first = torch.zeros(n, dtype=torch.bool, device=c.device)
    decided = torch.zeros(n, dtype=torch.bool, device=c.device)
    for f, b in zip(fwd, rev):
        fwd_first |= ~decided & (f < b)
        decided |= f != b
    fwd_first |= ~decided
    keys = torch.stack([torch.where(fwd_first, f, b) for f, b in zip(fwd, rev)], 1)
    bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=c.device),
                     torch.cumsum((c >= 4).to(torch.int64), 0)])
    return keys[bad[k:k + n] == bad[:n]]


def lexsort(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows of ``keys`` lexicographically."""
    perm = torch.arange(keys.shape[0], device=keys.device)
    for j in reversed(range(keys.shape[1])):
        perm = perm[torch.sort(keys[perm, j], stable=True)[1]]
    return perm


def merge_rows(keys: torch.Tensor, counts: torch.Tensor):
    """Distinct rows of ``keys`` in lexicographic order, each with the sum
    of its rows' ``counts``."""
    if keys.shape[0] == 0:
        return keys, counts
    perm = lexsort(keys)
    keys, counts = keys[perm], counts[perm]
    new = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    new[1:] = (keys[1:] != keys[:-1]).any(1)
    seg = torch.cumsum(new, 0) - 1
    sums = torch.zeros(int(seg[-1]) + 1, dtype=torch.int64, device=keys.device)
    return keys[new], sums.index_add_(0, seg, counts)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finaliser on int64 bit patterns (products wrap)."""
    z = (z ^ _shr(z, 30)) * (0xBF58476D1CE4E5B9 - (1 << 64))
    z = (z ^ _shr(z, 27)) * (0x94D049BB133111EB - (1 << 64))
    return z ^ _shr(z, 31)


def part_of(keys: torch.Tensor, parts: int) -> torch.Tensor:
    """The part (0 .. parts - 1, int64) of each key row: the splitmix64
    finaliser chained over the row's words (h = mix(h ^ word) from h =
    0), as an unsigned 64-bit number modulo ``parts``."""
    h = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    if parts == 1:
        return h
    for j in range(keys.shape[1]):
        h = _mix(h ^ keys[:, j])
    r = torch.remainder(h, parts)          # of the bits as unsigned: 2^64 more where h < 0
    return torch.where(h < 0, (r + (1 << 64) % parts) % parts, r)


def line_blocks(buf: np.ndarray, size: int = BLOCK):
    """[start, end) of consecutive pieces of ``buf`` that each end after a
    newline (the last at the end of ``buf``): whole lines of at most
    ``size`` bytes together, or one line where a line is longer."""
    a, n = 0, buf.shape[0]
    while a < n:
        b = min(a + size, n)
        if b < n:
            nl = np.flatnonzero(buf[a:b] == ord("\n"))
            if nl.size:
                b = a + int(nl[-1]) + 1
            else:                          # a line longer than size: to its end
                while not nl.size and b < n:
                    b0, b = b, min(b + size, n)
                    nl = b0 + np.flatnonzero(buf[b0:b] == ord("\n"))
                b = int(nl[0]) + 1 if nl.size else n
        yield a, b
        a = b


def count_codes(c: torch.Tensor, k: int, block: int = BLOCK):
    """(distinct keys (U, key_words(k)) in key order, counts (U,) int64)
    of every valid window of ``c``, counted ``block`` starts at a time."""
    parts, cnts = [], []
    for p0 in range(0, max(c.shape[0] - k + 1, 0), block):
        keys = window_keys(c[p0:p0 + block + k - 1], k)
        keys, cn = merge_rows(keys, torch.ones(keys.shape[0], dtype=torch.int64,
                                               device=c.device))
        parts.append(keys)
        cnts.append(cn)
    if not parts:
        return (torch.zeros((0, key_words(k)), dtype=torch.int64, device=c.device),
                torch.zeros(0, dtype=torch.int64, device=c.device))
    if len(parts) == 1:
        return parts[0], cnts[0]
    return merge_rows(torch.cat(parts), torch.cat(cnts))


def clip(counts: torch.Tensor, mode: int) -> torch.Tensor:
    return counts & 0xFFFF if mode == 0 else counts.clamp(max=16383)


def render(keys: torch.Tensor, counts: torch.Tensor, *, k: int, mode: int,
           min_abundance: int) -> torch.Tensor:
    """The count file's bytes (uint8 tensor) for keys in the given order."""
    v = clip(counts, mode)
    keep = (counts > 0) & (v >= min_abundance)
    keys, v = keys[keep], v[keep]
    W, L = keys.shape[1], k + 2 + MAX_DIGITS
    r = k - WORD * (W - 1)
    dev = keys.device
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    pow10 = 10 ** torch.arange(MAX_DIGITS - 1, -1, -1, device=dev)
    cell = torch.arange(L, device=dev) - (k + 1)
    out = [torch.zeros(0, dtype=torch.uint8, device=dev)]
    for r0 in range(0, keys.shape[0], ROWS):
        kk, vv = keys[r0:r0 + ROWS], v[r0:r0 + ROWS, None]
        text = torch.empty((kk.shape[0], L), dtype=torch.uint8, device=dev)
        for i in range(k):
            j = i // WORD
            width = WORD if j < W - 1 else r
            text[:, i] = acgt[(kk[:, j] >> 2 * (width - 1 - (i - WORD * j))) & 3]
        text[:, k] = ord(" ")
        text[:, k + 1:k + 1 + MAX_DIGITS] = (ord("0") + vv // pow10 % 10).to(torch.uint8)
        text[:, L - 1] = ord("\n")
        ndig = 1 + (vv >= pow10[:-1]).sum(1, keepdim=True)
        out.append(text[~((cell >= 0) & (cell < MAX_DIGITS - ndig))])
    return torch.cat(out)


def count_part(path: str, k: int, device, part: int = 0, parts: int = 1,
               block: int = BLOCK) -> tuple:
    """(distinct keys in key order, counts int64) of the valid windows of
    the FASTA file at ``path`` whose key lies in ``part`` of ``parts``
    (``part_of``), on ``device``.  The file is decoded ``line_blocks`` at
    a time; a block's windows, with the k - 1 codes before it, are keyed,
    the part's rows kept and merged, and the blocks' rows merged last."""
    buf = np.fromfile(path, np.uint8)
    carry = torch.zeros(0, dtype=torch.uint8, device=device)
    keys, cnts = [], []
    for a, b in line_blocks(buf, block):
        c = torch.cat([carry, codes_from_fasta(torch.from_numpy(buf[a:b]).to(device))])
        carry = c[max(c.shape[0] - (k - 1), 0):]
        kk = window_keys(c, k)
        if parts > 1:
            kk = kk[part_of(kk, parts) == part]
        kk, cn = merge_rows(kk, torch.ones(kk.shape[0], dtype=torch.int64, device=device))
        keys.append(kk)
        cnts.append(cn)
    if not keys:
        return (torch.zeros((0, key_words(k)), dtype=torch.int64, device=device),
                torch.zeros(0, dtype=torch.int64, device=device))
    if len(keys) == 1:
        return keys[0], cnts[0]
    keys, cnts = torch.cat(keys), torch.cat(cnts)
    return merge_rows(keys, cnts)
