"""Offline output tools: count-file comparator and k-mer orienter — the
port's copy of ``kaarme_tpu/utils/compare.py``.

Counterparts of the reference's pytools:
- ``compare_count_files`` ~ pytools/compare_outputs.py:4-33, but
  order-normalized: the reference emits table-traversal order while this
  framework emits slot order, so both sides are sorted before diffing
  (SURVEY.md section 4 calls this out explicitly);
- ``orient_file`` ~ pytools/kmer_orienter.py:7-46 — canonicalizes and
  abundance-filters a third-party counter's output so it can be compared.
"""

from __future__ import annotations

from .codec import canonical


def read_count_file(path: str) -> dict:
    counts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            kmer, cnt = line.split()
            counts[kmer] = int(cnt)
    return counts


def compare_count_files(path_a: str, path_b: str, max_report: int = 10):
    """Returns (equal, differences) where differences is a list of
    (kmer, count_a_or_None, count_b_or_None), capped at max_report."""
    a = read_count_file(path_a)
    b = read_count_file(path_b)
    diffs = []
    for kmer in sorted(set(a) | set(b)):
        ca, cb = a.get(kmer), b.get(kmer)
        if ca != cb:
            diffs.append((kmer, ca, cb))
            if len(diffs) >= max_report:
                break
    return (not diffs), diffs


def orient_file(path_in: str, path_out: str, min_abundance: int = 1) -> int:
    """Canonicalize + abundance-filter another counter's `KMER COUNT`
    output so it can be diffed against this framework's canonical output.
    Returns #lines written."""
    counts: dict = {}
    with open(path_in) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            kmer, cnt = line.split()
            km = canonical(kmer.upper())
            counts[km] = counts.get(km, 0) + int(cnt)
    n = 0
    with open(path_out, "w") as f:
        for km in sorted(counts):
            if counts[km] >= min_abundance:
                f.write(f"{km} {counts[km]}\n")
                n += 1
    return n


def main(argv=None) -> int:  # pragma: no cover - thin CLI shim
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) == 2:
        eq, diffs = compare_count_files(argv[0], argv[1])
        if eq:
            print("Files are equal")
            return 0
        for kmer, ca, cb in diffs:
            print(f"DIFF {kmer}: {ca} vs {cb}")
        return 1
    print("usage: python -m kaarme_tpu_torch.utils.compare FILE_A FILE_B", file=sys.stderr)
    return 2


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
