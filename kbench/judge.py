"""The comparison that decides ``correct``: a judged job's store and count
file against the plain reference, number by number, each against its
limit.

The store and the reference are compared in key-hash parts
(``reference.kmer_count.part_of``), one part to a card of the cell,
one part after another: each part's numbers are summed over the parts,
and each part's rows are dropped before the next part is drawn, so that
a card holds one part's rows and temporaries at a time.  With one part
this is the comparison of the whole store.

- ``store_rows_off`` (exact, limit 0): keys whose store count differs
  from the reference's.  The store is every live row (count > 0) of the
  counter's ``dump_columns()``, before filtering and clipping: every
  valid canonical window counted once.  With ``-b`` the store holds the
  keys that passed the filter: each key the reference counts twice or
  more, with its count, and perhaps keys it counts once (the filter's
  false positives, with count 1); any other row, and any key stored
  twice, is off.
- ``bloom_singletons_kept`` (``-b`` only): the keys the reference counts
  once that the store holds.  The configuration states the filter's
  false-positive rate (``-f``); the limit is that rate times the
  reference's count-1 keys (both summed over the parts), with four
  binomial standard deviations of room (which matters only where
  singletons are few), so that a filter that keeps the singletons out
  as stated passes and one that lets them through fails.
- ``file_lines_off`` (exact, limit 0): lines of the count file that the
  reference's count file lacks, plus the reverse (as multisets: 0 when
  the files are equal byte for byte, and for a file in another row
  order).  The reference's file is rendered from every part's rows that
  it holds (clipped count at least ``-a``), merged into key order on the
  first part's device.
- ``jobs_failed`` (limit 0): jobs of the window that exited non-zero or
  raised.
"""

from __future__ import annotations

import collections
import math

import torch

from .reference import kmer_count as ref


def flag(argv, name: str, default):
    """The value after ``name`` in a CLI argv (the last one), else ``default``."""
    vals = [argv[i + 1] for i, a in enumerate(argv[:-1]) if a == name]
    return type(default)(vals[-1]) if vals else default


def store_keys(cols, k: int) -> torch.Tensor:
    """The program's store key columns (ceil(k / 16) int32 columns of u32
    bit patterns, base i at bits 30 - 2 (i % 16) of word i // 16) as the
    reference's key rows."""
    n, W = cols[0].shape[0], ref.key_words(k)
    out = torch.zeros((n, W), dtype=torch.int64, device=cols[0].device)
    words = [c.to(torch.int64) & 0xFFFFFFFF for c in cols]
    for i in range(k):
        code = (words[i // 16] >> (30 - 2 * (i % 16))) & 3
        out[:, i // ref.WORD] = (out[:, i // ref.WORD] << 2) | code
    return out


def store_rows_off(ref_keys, ref_counts, keys, counts, bloom: bool) -> tuple:
    """(rows off, keys the reference counts once that the store holds,
    keys the reference counts once)."""
    dev = ref_keys.device
    both = torch.cat([ref_keys, keys.to(dev)])
    perm = ref.lexsort(both)
    both = both[perm]
    side = (perm >= ref_keys.shape[0]).to(torch.int64)
    cnt = torch.cat([ref_counts, counts.to(dev).to(torch.int64)])[perm]
    new = torch.ones(both.shape[0], dtype=torch.bool, device=dev)
    new[1:] = (both[1:] != both[:-1]).any(1)
    seg = torch.cumsum(new, 0) - 1
    groups = int(seg[-1]) + 1 if seg.numel() else 0

    def total(x):
        return torch.zeros(groups, dtype=torch.int64, device=dev).index_add_(0, seg, x)

    rc, sc, sn = total(cnt * (1 - side)), total(cnt * side), total(side)
    singles = int((rc == 1).sum())
    if not bloom:
        off = (rc != sc) | (sn > 1)
        return int(off.sum()), 0, singles
    off = (((rc >= 2) & ((sc != rc) | (sn != 1)))
           | ((rc == 1) & ((sn > 1) | (sc > 1)))
           | ((rc == 0) & (sn > 0)))
    return int(off.sum()), int(((rc == 1) & (sn == 1)).sum()), singles


def singletons_allowed(singles: int, fpr: float) -> int:
    """The most count-1 keys a filter of false-positive rate ``fpr`` may
    let through out of ``singles``: the expected number, plus four
    standard deviations (binomial, rounded up)."""
    mean = fpr * singles
    return math.ceil(mean + 4 * math.sqrt(mean * (1 - fpr)))


def file_lines_off(expected: bytes, got: bytes) -> int:
    """Lines of ``got`` that ``expected`` lacks plus the reverse, as
    multisets; a last line with no newline is another line."""
    if expected == got:
        return 0
    a = collections.Counter(expected.splitlines(keepends=True))
    b = collections.Counter(got.splitlines(keepends=True))
    return sum(((a - b) + (b - a)).values())


def judge(k: int, argv, parts, text: bytes, jobs_failed: int) -> tuple:
    """The compared numbers of one judged job as {name: {value, limit}},
    and what is only reported: the reference's windows and, with -b, its
    count-1 keys.  ``parts`` yields, one key-hash part at a time, the
    reference's (keys, counts) and the store's (keys, counts), all on the
    part's device and in the reference's key rows; ``text`` is the count
    file's bytes."""
    bloom = "-b" in argv
    a, mode = flag(argv, "-a", 2), flag(argv, "-m", 2)
    if bloom and a < 2:
        # the -b file would then hold the filter's false positives too
        raise ValueError("the -b comparison needs -a 2 or more")
    off = kept = singles = windows = 0
    lines = []                                 # each part's rows of the count file
    for part in parts:
        ref_keys, ref_counts, keys, counts = part
        del part
        o, kp, s = store_rows_off(ref_keys, ref_counts, keys, counts, bloom)
        off, kept, singles = off + o, kept + kp, singles + s
        windows += int(ref_counts.sum())
        home = lines[0][0].device if lines else ref_keys.device
        keep = (ref_counts > 0) & (ref.clip(ref_counts, mode) >= a)
        lines.append((ref_keys[keep].to(home), ref_counts[keep].to(home)))
        del ref_keys, ref_counts, keys, counts, keep
    keys, counts = (torch.cat(c) for c in zip(*lines))
    del lines
    order = ref.lexsort(keys)          # the parts' rows into key order
    expected = ref.render(keys[order], counts[order], k=k, mode=mode, min_abundance=a)
    del keys, counts, order
    out = {"jobs_failed": {"value": jobs_failed, "limit": 0},
           "store_rows_off": {"value": off, "limit": 0}}
    if bloom:
        out["bloom_singletons_kept"] = {
            "value": kept, "limit": singletons_allowed(singles, flag(argv, "-f", 0.01))}
    out["file_lines_off"] = {"value": file_lines_off(expected.cpu().numpy().tobytes(), text),
                             "limit": 0}
    info = {"reference_windows": windows}
    if bloom:
        info["reference_singletons"] = singles
    return out, info


def ok(numbers: dict) -> bool:
    return all(d["value"] <= d["limit"] for d in numbers.values())
