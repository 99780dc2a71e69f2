"""The sharded counters' key-range dump (``ShardedSortCounter.dump_columns``,
shared by ``ShardedSkmCounter``) through the port's CLI on 2 and 4 CPU
shards, on the skm and classic routes: the count file byte for byte
against the golden count, the store's live rows against the benchmark's
plain reference (``kbench/reference/kmer_count.py``) row for row, one
part a shard in key order, and ``dump_rows_moved`` against the rows
found off their range's shard.  Inputs: seeded reads from
``kbench/gen.py``, poly-A (one key: every other shard empty, fewer keys
than shards, one leading key), two keys, and reads whose keys mostly
share one leading 64-bit key, so that equal leading keys straddle a
split.  Every quantity is an integer: tolerance 0."""

import numpy as np
import pytest
import torch

from kaarme_tpu.utils import codec
from kaarme_tpu_torch import cli
from kaarme_tpu_torch.ops import sortcount
from kbench import gen, judge
from kbench.reference import kmer_count as ref

READS = dict(genome_bases=3000, coverage=10, read_len=150, reverse_share=0.5,
             substitution_rate=0.01)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite runs several worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fasta(seqs) -> bytes:
    return b"".join(b">r%d\n%s\n" % (i, s.encode()) for i, s in enumerate(seqs))


def _random(rng, n) -> str:
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _input(name: str, k: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if name == "reads":
        return gen.fasta_bytes(gen.sample(READS, seed)["reads"])
    if name == "poly_a":
        return _fasta(["A" * 300, "T" * 120])
    if name == "two_keys":
        return _fasta([_random(rng, k + 1)])
    # shared_lead: three keys in four start with 32 A's (leading 64-bit
    # key 0), the rest are random
    return _fasta(["A" * 32 + _random(rng, k - 32) if i % 4 else _random(rng, k)
                   for i in range(300)])


def _golden_file(codes, k: int) -> bytes:
    """The count file of ``-m 2 -a 1`` from the golden count: every key in
    key order (the string order of its k-mer), its count clipped at 16383."""
    golden = codec.golden_count(codes, k)
    return "".join(f"{s} {min(c, 16383)}\n" for s, c in sorted(golden.items())).encode()


def _rows(cols) -> set:
    """Key rows of store columns as tuples of unsigned words."""
    return {tuple(r) for r in torch.stack(list(cols), 1).numpy().view(np.uint32).tolist()}


INPUTS = ["reads", "poly_a", "two_keys", "shared_lead"]
# at k = 13 a key is one word: its leading key is the whole key
CASES = [(route, k, inp) for route, k in (("skm", 51), ("classic", 51), ("classic", 13))
         for inp in INPUTS if k > 32 or inp != "shared_lead"]


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("route,k,inp", CASES)
def test_range_dump(tmp_path, route, k, ndev, inp):
    path, out = tmp_path / "r.fa", tmp_path / "r.counts"
    text = _input(inp, k, seed=k + ndev)
    path.write_bytes(text)
    rc, c = cli.run([str(path), str(k), "-s", "4000", "-a", "1", "-q", "--device", "cpu",
                     "--devices", str(ndev), "--pipeline", route, "-o", str(out)])
    assert rc == 0 and type(c).__name__ == ("ShardedSkmCounter" if route == "skm"
                                            else "ShardedSortCounter")
    moved = c.stats["dump_rows_moved"]
    assert c.stats["range_dump_seconds"] > 0

    assert out.read_bytes() == _golden_file(codec.encode_fasta(text)[0], k)

    # one part a shard, on its device, in key order: the parts joined are
    # the reference's rows, row for row
    parts = c.dump_columns()
    assert len(parts) == ndev and [p[1].device for p in parts] == list(c.devices)
    keys = torch.cat([judge.store_keys(cols, k)[cnt > 0] for cols, cnt in parts])
    cnts = torch.cat([cnt[cnt > 0] for _, cnt in parts]).to(torch.int64)
    want_keys, want_cnts = ref.count_part(str(path), k, "cpu")
    assert torch.equal(keys, want_keys) and torch.equal(cnts, want_cnts)

    # the rows moved: those of part r that shard r did not hold
    shards = [{tuple(r) for r in keys_np.tolist()} for keys_np, _ in c.shard_dumps()]
    off = sum(len(_rows(cols) - shards[r]) for r, (cols, _) in enumerate(parts))
    assert moved == off
    assert c.stats["dump_rows_moved"] == 2 * off          # two dumps so far

    # what each input is for
    rows = [int(cnt.shape[0]) for _, cnt in parts]
    if inp == "reads":
        assert min(rows) > 0 and off > 0
    elif inp == "poly_a":
        assert sum(rows) == 1 and min(c._nd) == 0
    elif inp == "two_keys":
        assert sum(rows) <= 2          # at 4 shards, fewer keys than shards

    if inp == "shared_lead":
        # the largest shard's leading keys are equal on both sides of a split
        w = codec.words_per_kmer(k)
        big = max(range(ndev), key=lambda s: c._nd[s])
        lead = sortcount.sort_key([col[:c._nd[big]] for col in c.prefix[big][:min(w, 2)]])
        n = lead.shape[0]
        assert any(lead[n * r // ndev - 1] == lead[n * r // ndev] for r in range(1, ndev))
