"""The plain reference against a string count, with both
configurations' flags, counted whole and in key-hash parts, and the
judge's numbers on altered stores, in one part and in four."""

import collections
import json
import os

import numpy as np
import pytest
import torch

from kbench import gen, judge, run
from kbench.reference import kmer_count as ref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def string_count(reads, k):
    out = collections.Counter()
    for r in reads:
        s = gen.ACGT[r].tobytes()
        rc = s.translate(COMP)[::-1]
        n = len(s)
        for i in range(n - k + 1):
            f, b = s[i:i + k], rc[n - k - i:n - i]
            out[f if f <= b else b] += 1
    return out


def config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def small(rate, seed=3):
    return gen.sample(dict(genome_bases=4000, coverage=8, read_len=150, reverse_share=0.5,
                           substitution_rate=rate), seed)["reads"]


@pytest.mark.parametrize("k", [2, 13, 31, 32, 51, 63, 101])
def test_counts_equal_a_string_count(k):
    reads = small(0.01)
    codes = ref.codes_from_fasta(torch.frombuffer(bytearray(gen.fasta_bytes(reads)),
                                                  dtype=torch.uint8))
    keys, counts = ref.count_codes(codes, k, block=777)
    gold = string_count(reads, k)
    text = ref.render(keys, counts, k=k, mode=2, min_abundance=1).numpy().tobytes()
    assert text == b"".join(b"%s %d\n" % kv for kv in sorted(gold.items()))


@pytest.mark.parametrize("name", ["ecoli-k51", "ecoli-k51-bf"])
def test_count_file_with_the_configuration_flags(name):
    cfg = config(name)
    k, a = cfg["k"], judge.flag(cfg["flags"], "-a", 2)
    reads = small(0.01)
    codes = ref.codes_from_fasta(torch.frombuffer(bytearray(gen.fasta_bytes(reads)),
                                                  dtype=torch.uint8))
    keys, counts = ref.count_codes(codes, k)
    gold = string_count(reads, k)
    want = b"".join(b"%s %d\n" % (km, min(c, 16383))
                    for km, c in sorted(gold.items()) if min(c, 16383) >= a)
    text = ref.render(keys, counts, k=k, mode=judge.flag(cfg["flags"], "-m", 2),
                      min_abundance=a).numpy().tobytes()
    assert text == want and a == 2
    # the judge passes the reference in the program's place (with -b, its
    # count >= 2 set) ...
    stored = counts >= (2 if "-b" in cfg["flags"] else 1)
    checks, _ = judge.judge(k, cfg["flags"], [(keys, counts, keys[stored], counts[stored])],
                            text, 0)
    assert judge.ok(checks)
    # ... and with -b, the count >= 2 set plus a few admitted singletons,
    # but not with every singleton kept (no filter at all)
    if "-b" in cfg["flags"]:
        single = torch.nonzero(counts == 1).flatten()
        assert single.numel() > 1000
        keep = counts >= 2
        keep[single[::200]] = True
        checks, info = judge.judge(k, cfg["flags"], [(keys, counts, keys[keep], counts[keep])],
                                   text, 0)
        assert judge.ok(checks) and info["reference_singletons"] == single.numel()
        assert 0 < checks["bloom_singletons_kept"]["value"] <= single.numel() // 100
        checks, _ = judge.judge(k, cfg["flags"], [(keys, counts, keys, counts)], text, 0)
        assert not judge.ok(checks)
        assert [n for n, d in checks.items() if d["value"] > d["limit"]] == ["bloom_singletons_kept"]


def test_singletons_allowed():
    assert judge.singletons_allowed(0, 0.01) == 0
    assert judge.singletons_allowed(20, 0.01) == 2          # 0.2 + 4 x 0.445
    assert judge.singletons_allowed(35_780_000, 0.01) == 360_181
    assert judge.singletons_allowed(35_780_000, 0.01) < 35_780_000 // 50


def test_clip_and_modes():
    keys = torch.tensor([[1], [2], [3]], dtype=torch.int64)
    counts = torch.tensor([70_000, 65_536, 1])
    t2 = ref.render(keys, counts, k=3, mode=2, min_abundance=1).numpy().tobytes()
    t0 = ref.render(keys, counts, k=3, mode=0, min_abundance=1).numpy().tobytes()
    assert t2 == b"AAC 16383\nAAG 16383\nAAT 1\n"
    assert t0 == b"AAC 4464\nAAT 1\n"


@pytest.mark.parametrize("bloom", [False, True])
def test_store_rows_off_counts_each_fault(bloom):
    keys = torch.arange(12, dtype=torch.int64).reshape(6, 2)
    counts = torch.tensor([1, 2, 3, 4, 5, 6])
    assert judge.store_rows_off(keys, counts, keys, counts, bloom) == (0, int(bloom), 1)
    bumped = counts.clone()
    bumped[2] += 1
    assert judge.store_rows_off(keys, counts, keys, bumped, bloom)[0] == 1
    assert judge.store_rows_off(keys, counts, keys[1:], counts[1:], bloom) == (
        (0, 0, 1) if bloom else (1, 0, 1))
    assert judge.store_rows_off(keys, counts, keys[2:], counts[2:], bloom)[0] == (1 if bloom else 2)
    dup = torch.cat([keys, keys[3:4]]), torch.cat([counts, counts[3:4]])
    assert judge.store_rows_off(keys, counts, *dup, bloom)[0] == 1
    alien = torch.cat([keys, torch.tensor([[99, 99]])]), torch.cat([counts, torch.tensor([1])])
    assert judge.store_rows_off(keys, counts, *alien, bloom)[0] == 1


def test_store_keys_reads_the_program_word_layout():
    k = 51
    reads = small(0.0)
    codes = ref.codes_from_fasta(torch.frombuffer(bytearray(gen.fasta_bytes(reads)),
                                                  dtype=torch.uint8))
    keys, _ = ref.count_codes(codes, k)
    text = ref.render(keys, torch.full((keys.shape[0],), 2), k=k, mode=2, min_abundance=1)
    bases = text.numpy().tobytes().split(b"\n")[:-1]
    # pack each k-mer as the program stores it: base i at bits 30 - 2 (i % 16) of word i // 16
    cols = torch.zeros((4, len(bases)), dtype=torch.int64)
    for r, line in enumerate(bases):
        for i, ch in enumerate(line[:k]):
            cols[i // 16, r] |= b"ACGT".index(ch) << (30 - 2 * (i % 16))
    cols = [(c - (c >> 31 << 32)).to(torch.int32) for c in cols]    # u32 bits as int32
    assert torch.equal(judge.store_keys(cols, k), keys)


def test_file_lines_off():
    off = judge.file_lines_off
    assert off(b"A 2\nC 3\n", b"A 2\nC 3\n") == 0
    assert off(b"A 2\nC 3\n", b"C 3\nA 2\n") == 0
    assert off(b"A 2\nC 3\n", b"A 2\nC 4\n") == 2
    assert off(b"A 2\nC 3\n", b"A 2\n") == 1
    assert off(b"A 2\nC 3\n", b"A 2\nC 3") == 2   # no newline: another line
    assert off(b"A 2\nA 2\n", b"A 2\n") == 1
    assert off(b"", b"G 9\n") == 1


MASK = (1 << 64) - 1


def splitmix64_final(z):
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK
    return z ^ (z >> 31)


def test_part_of_is_the_splitmix64_finaliser_of_the_key_words():
    g = torch.Generator().manual_seed(7)
    keys = torch.randint(-(2**63), 2**63 - 1, (500, 3), generator=g, dtype=torch.int64)
    for parts in (1, 3, 4):
        want = []
        for row in keys.tolist():
            h = 0
            for w in row:
                h = splitmix64_final(h ^ (w & MASK))
            want.append(h % parts)
        assert ref.part_of(keys, parts).tolist() == want


def messy_fasta(seed=11):
    """Reads, then a record wrapped over many lines with N bases and lower
    case, a record on one line longer than a block, and a last line with
    no newline."""
    rng = np.random.default_rng(seed)
    reads = gen.fasta_bytes(small(0.01, seed))
    seq = gen.ACGT[rng.integers(0, 4, 3000)].tobytes()
    seq = seq[:700] + b"NN" + seq[702:1500] + seq[1500:1600].lower() + seq[1600:]
    wrapped = b"\n".join(seq[i:i + 60] for i in range(0, len(seq), 60))
    long_line = gen.ACGT[rng.integers(0, 4, 2500)].tobytes()
    return (reads + b">wrapped record\n" + wrapped + b"\n>long\n" + long_line
            + b"\n>last\nACGTTGCANNACGTAC")


@pytest.mark.parametrize("k", [13, 51])
def test_the_parts_hold_the_whole_count(tmp_path, k):
    fa = messy_fasta()
    path = tmp_path / "m.fa"
    path.write_bytes(fa)
    codes = ref.codes_from_fasta(torch.frombuffer(bytearray(fa), dtype=torch.uint8))
    want_keys, want_counts = ref.count_codes(codes, k)
    # blocks of 1000 bytes: the wrapped record spans several, the long line is one
    blocks = list(ref.line_blocks(np.frombuffer(fa, np.uint8), 1000))
    assert blocks[0][0] == 0 and blocks[-1][1] == len(fa) and len(blocks) > 30
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(blocks, blocks[1:]))
    assert max(b - a for a, b in blocks) > 2500
    one = ref.count_part(str(path), k, "cpu", block=1000)
    assert torch.equal(one[0], want_keys) and torch.equal(one[1], want_counts)
    parts = [ref.count_part(str(path), k, "cpu", p, 4, block=1000) for p in range(4)]
    for p, (keys, counts) in enumerate(parts):
        assert keys.shape[0] > 0 and (ref.part_of(keys, 4) == p).all()
        assert torch.equal(ref.lexsort(keys), torch.arange(keys.shape[0]))
    keys, counts = (torch.cat(c) for c in zip(*parts))
    order = ref.lexsort(keys)
    assert torch.equal(keys[order], want_keys) and torch.equal(counts[order], want_counts)


@pytest.mark.parametrize("name", ["ecoli-k51", "ecoli-k51-bf"])
def test_the_judge_reads_alike_in_one_and_four_parts(tmp_path, name):
    cfg = config(name)
    k, flags = cfg["k"], cfg["flags"]
    path = tmp_path / "r.fa"
    path.write_bytes(gen.fasta_bytes(small(0.01)))
    keys, counts = ref.count_part(str(path), k, "cpu")
    text = ref.render(keys, counts, k=k, mode=2, min_abundance=2).numpy().tobytes()
    stored = counts >= (2 if "-b" in flags else 1)
    stored[torch.nonzero(counts == 1).flatten()[::300]] = True
    sk, sc = keys[stored], counts[stored].clone()
    sc[5] += 1
    stores = {"sound": (keys[stored], counts[stored]), "a count off": (sk, sc),
              "rows lost": (sk[::2], sc[::2]),
              "a row twice": (torch.cat([sk, sk[7:8]]), torch.cat([sc, sc[7:8]])),
              "every key": (keys, counts)}
    texts = [text, text[:-40] + b"\n", text.replace(b" 2\n", b" 3\n", 1)]

    def judged(store_keys, store_counts, got, parts):
        cpu = [torch.device("cpu")] * parts
        rows = [ref.count_part(str(path), k, "cpu", p, parts) for p in range(parts)]
        store = run.joined(run.into_parts(store_keys, store_counts, cpu))
        return judge.judge(k, flags, [(*r, *st) for r, st in zip(rows, store)], got, 0)

    for what, (pk, pc) in stores.items():
        for got in texts:
            one = judged(pk, pc, got, 1)
            assert judged(pk, pc, got, 4) == one, what
            sound = what == "sound" or (what == "every key" and "-b" not in flags)
            assert judge.ok(one[0]) == (sound and got == text), what
