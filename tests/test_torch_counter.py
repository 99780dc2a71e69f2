"""The probe-table counter of the PyTorch port (``models/counter.py``, the
``--backend table`` route) and the table half of its Bloom prefilter
(``models/bloom_counter.bloom_count_codes``), held to the JAX package's
``KmerCounter`` and ``bloom_count_codes`` and to the golden count: both
output modes, counts past 16383 and 65535, forced growth with the JAX
counter's grow events, occupancy, ``find``, ``as_dict`` and the count
file (slot order, so compared sorted), and the BF2 words and counters of
the Bloom pass at equal batch sizes.  Also the port's copy of
``utils/compare.py`` against the JAX one.  Every quantity is an integer:
tolerance 0."""

import gzip

import numpy as np
import pytest
import torch

from kaarme_tpu.io import reader as io_reader
from kaarme_tpu.models import bloom_counter as ref_bc
from kaarme_tpu.models.counter import CounterConfig as RefConfig, KmerCounter as RefCounter
from kaarme_tpu.utils import codec
from kaarme_tpu.utils import compare as ref_compare
from kaarme_tpu_torch.models import bloom_counter
from kaarme_tpu_torch.models.counter import CounterConfig, KmerCounter
from kaarme_tpu_torch.utils import compare

# one tile shape for every case, so the JAX count step compiles once per k
TILE, BATCH_TILES = 128, 4


def _seq_codes(n, seed):
    rng = np.random.default_rng(seed)
    return codec.encode_plain("".join("ACGT"[c] for c in rng.integers(0, 4, n)).encode())


def _pair(k, **kw):
    kw.setdefault("min_slots", 1 << 13)
    kw.setdefault("min_abundance", 1)
    common = dict(k=k, tile=TILE, batch_tiles=BATCH_TILES, **kw)
    return KmerCounter(CounterConfig(device="cpu", **common)), RefCounter(RefConfig(**common))


def _multiset(counter):
    tk, cn = counter.dump()
    return sorted(zip(map(tuple, np.asarray(tk, np.uint32).tolist()), np.asarray(cn).tolist()))


@pytest.mark.parametrize("mode,abu", [(2, 1), (0, 2)])
@pytest.mark.parametrize("k", [13, 31])
def test_count_codes_matches_reference_and_golden(k, mode, abu):
    codes = _seq_codes(4000, seed=k)
    codes = np.concatenate([codes, np.array([4], np.uint8), codes[500:1500]])
    port, ref = _pair(k, mode=mode, min_abundance=abu)
    for piece in np.array_split(codes, 5):        # uneven pieces: the halo carry
        port.add_codes(piece)
        ref.add_codes(piece)
    port.finish()
    ref.finish()
    golden = codec.golden_count(codes, k)
    assert port.as_dict() == ref.as_dict() == {s: c for s, c in golden.items() if c >= abu}
    assert _multiset(port) == _multiset(ref)
    assert port.occupancy() == ref.occupancy() == (len(golden), 1 << 13)
    for key in ("windows_processed", "batches", "grow_events"):
        assert port.stats[key] == ref.stats[key]
    assert port.stats["windows_processed"] == port.stats["batches"] * TILE * BATCH_TILES


@pytest.mark.parametrize("mode,want", [(2, 16383), (0, 70000 % 65536)])
def test_counts_past_16383_and_65535(mode, want):
    """Poly-A: one k-mer 70,000 times (every lane of a batch on one slot)."""
    codes = codec.encode_plain(b"A" * 70002)
    port, ref = _pair(3, mode=mode)
    port.count_codes(codes)
    ref.count_codes(codes)
    assert port.as_dict() == ref.as_dict() == {"AAA": want}
    assert port.dump()[1].tolist() == [70000]
    assert port.find(["AAA", "TTT", "ACG", "AXA"]) == ref.find(["AAA", "TTT", "ACG", "AXA"]) \
        == [want, want, 0, -1]


def test_forced_growth_matches_reference():
    """min_slots 256 and ~600 distinct keys: the table grows twice (256 ->
    512 -> 1024) and re-inserts only the pending windows."""
    codes = _seq_codes(612, seed=8)
    port, ref = _pair(13, min_slots=256)
    port.count_codes(codes)
    ref.count_codes(codes)
    assert ref.stats["grow_events"] == 2
    assert port.stats["grow_events"] == 2
    golden = codec.golden_count(codes, 13)
    assert port.occupancy() == ref.occupancy() == (len(golden), 1024)
    assert len(golden) > 512
    assert port.as_dict() == ref.as_dict() == golden
    assert _multiset(port) == _multiset(ref)


def test_growth_raises_past_max_grows():
    codes = _seq_codes(3000, seed=3)
    port, _ = _pair(13, min_slots=256, max_grows=1)
    with pytest.raises(RuntimeError, match="could not grow"):
        port.count_codes(codes)


def test_find_and_as_dict():
    k = 5
    codes = codec.encode_plain(b"ACGTACGTACGT\nGGGGGTTTTT")
    port, ref = _pair(k, min_abundance=2)
    port.count_codes(codes)
    ref.count_codes(codes)
    golden = codec.golden_count(codes, k)
    assert port.as_dict() == ref.as_dict() == {s: n for s, n in golden.items() if n >= 2}
    queries = ["ACGTA", codec.revcomp("ACGTA"), "acgta", "AATAA", "AXGTA", "ACG"]
    assert port.find(queries) == ref.find(queries) == [golden["ACGTA"]] * 3 + [0, -1, -1]
    assert port.find("GGGGG") == [golden["CCCCC"]]


def test_count_file_and_sorted_output(tmp_path):
    """FASTA and gzip input; the count file (slot order) equals the JAX
    counter's and the golden count once sorted."""
    k = 21
    rng = np.random.default_rng(2)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 400)) for _ in range(3)]
    fasta = "".join(f">read{i} x\n" + "\n".join(s[j:j + 47] for j in range(0, 400, 47)) + "\n"
                    for i, s in enumerate(seqs))
    p, pgz = tmp_path / "in.fa", tmp_path / "in.fa.gz"
    p.write_text(fasta)
    pgz.write_bytes(gzip.compress(fasta.encode()))
    golden = codec.golden_count(io_reader.read_codes(str(p)), k)
    for path in (p, pgz):
        port, ref = _pair(k)
        port.count_file(str(path), chunk_bytes=97)
        ref.count_file(str(path), chunk_bytes=97)
        a, b = tmp_path / "port.txt", tmp_path / "ref.txt"
        assert port.write_output(str(a)) == ref.write_output(str(b)) == len(golden)
        assert sorted(a.read_bytes().splitlines()) == sorted(b.read_bytes().splitlines())
        assert compare.read_count_file(str(a)) == golden
        assert port.stats["write_seconds"] > 0


def test_cuda_device_without_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="is_available"):
        KmerCounter(CounterConfig(k=13))
    with pytest.raises(RuntimeError, match="is_available"):
        bloom_counter.bloom_count_codes(bloom_counter.BloomCounterConfig(k=13, expected_unique=100),
                                        _seq_codes(100, seed=0))
    with pytest.raises(ValueError, match="kernels"):
        KmerCounter(CounterConfig(k=13, device="cpu", kernels="pallas"))


@pytest.mark.parametrize("k,mode", [(13, 2), (31, 0)])
def test_bloom_count_codes_matches_reference(k, mode):
    """Pass 1 at equal tile and batch_tiles: the same BF2 words and
    exactly-once counters; pass 2: the count >= 2 set of the golden
    count, the JAX counter's table contents."""
    codes = _seq_codes(3000, seed=k)
    codes = np.concatenate([codes, np.array([4], np.uint8), codes[:1200], codes[2000:2100]])
    common = dict(k=k, expected_unique=4000, fpr=0.02, mode=mode, min_abundance=1,
                  tile=TILE, batch_tiles=BATCH_TILES)
    port = bloom_counter.bloom_count_codes(
        bloom_counter.BloomCounterConfig(device="cpu", **common), codes)
    ref = ref_bc.bloom_count_codes(ref_bc.BloomCounterConfig(**common), codes)
    np.testing.assert_array_equal(port.bf2.numpy().view(np.uint32), np.asarray(ref.bf2))
    for key in ("new_in_first", "new_in_second", "bloom_bits", "bloom_hash_functions",
                "windows_processed", "batches", "grow_events"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["new_in_second"] > 0 and "bloom_pass1_seconds" in port.stats
    golden = codec.golden_count(codes, k)
    clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
    want = {s: clip(c) for s, c in golden.items() if c >= 2}
    got = port.as_dict()
    # false positives admit a few singletons; min_abundance 2 drops them
    assert {s: c for s, c in got.items() if c >= 2} == want
    assert got == ref.as_dict()
    assert port.occupancy() == ref.occupancy()


def test_compare_tools_match_reference(tmp_path):
    a, b, c = tmp_path / "a.txt", tmp_path / "b.txt", tmp_path / "c.txt"
    a.write_text("ACGT 3\nAAAA 2\n\nGGGA 1\n")
    b.write_text("AAAA 2\nGGGA 1\nACGT 3\n")
    c.write_text("AAAA 3\nCCCC 1\nACGT 3\n")
    for x, y in ((a, b), (a, c), (b, c)):
        assert compare.compare_count_files(str(x), str(y)) == \
            ref_compare.compare_count_files(str(x), str(y))
    assert compare.compare_count_files(str(a), str(b)) == (True, [])
    assert compare.compare_count_files(str(a), str(c))[1] == \
        [("AAAA", 2, 3), ("CCCC", None, 1), ("GGGA", 1, None)]
    assert compare.main([str(a), str(b)]) == 0 and compare.main([str(a), str(c)]) == 1
    assert compare.main([str(a)]) == 2
    raw = tmp_path / "raw.txt"
    raw.write_text("TTTT 3\nAAAA 2\nGGGG 1\nCCCC 4\n")
    o1, o2 = tmp_path / "o1.txt", tmp_path / "o2.txt"
    assert compare.orient_file(str(raw), str(o1), 2) == ref_compare.orient_file(str(raw), str(o2), 2)
    assert o1.read_text() == o2.read_text() == "AAAA 5\nCCCC 5\n"
