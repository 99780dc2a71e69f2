"""The count file's lines (``kaarme_tpu_torch/ops/writer.py``, W1's plain
PyTorch version and ``write_lines``) against the JAX package's writer:
``kaarme_tpu.models.sort_counter.SortKmerCounter.write_output``, called
unbound on a stub that hands it the same rows.  Byte for byte over k
(the trailing word full at 16, 32 and 48 bases, one base spilling into
a new word at 17 and 33), both output modes and thresholds down to -1,
counts that cross every digit boundary, 16383/16384 and
65535/65536/131072, dead rows and empty files; chunked writes; the
``-m 0 -a 0`` wrap through both CLIs; and ``write_output`` on every
counter reaching ``write_lines`` with its dump's parts.  Every quantity
is a byte: tolerance 0."""

import numpy as np
import pytest
import torch

from kaarme_tpu import cli as ref_cli
from kaarme_tpu.models.sort_counter import SortKmerCounter as RefSortCounter
from kaarme_tpu_torch import cli
from kaarme_tpu_torch.ops import writer

KS = [2, 13, 16, 17, 31, 32, 33, 51, 101, 201]
# every digit boundary, the 14-bit saturation, the uint16 wrap; 0 = dead
EDGES = [0, 1, 2, 3, 9, 10, 99, 100, 999, 1000, 9999, 10000, 16383, 16384, 65535, 65536,
         65537, 131072, 70000]


class _RefStub:
    """What the JAX ``write_output`` reads: ``dump`` (rows with count > 0,
    as the JAX dumps drop dead rows), ``_clip``, ``cfg`` and ``stats``."""

    _clip = RefSortCounter._clip

    def __init__(self, k, mode, abu, keys, counts):
        self.cfg = type("Cfg", (), dict(k=k, mode=mode, min_abundance=abu))()
        self.stats = {"write_seconds": 0.0}
        live = counts > 0
        self._rows = keys[live], counts[live].astype(np.int64)

    def dump(self):
        return self._rows


def _rows(k, n, seed):
    """n rows of random key words (the trailing word's unused low bits
    too), poly-A and poly-T first, and counts over EDGES then random."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, (n, (k + 15) // 16), dtype=np.uint64).astype(np.uint32)
    keys[:1] = 0
    keys[1:2] = 0xFFFFFFFF
    counts = np.concatenate([EDGES, rng.integers(1, 200, max(n - len(EDGES), 0))])[:n]
    rng.shuffle(counts)
    return keys, counts.astype(np.int64)


def _columns(keys, counts, dtype=torch.int64):
    return ([torch.from_numpy(np.ascontiguousarray(keys[:, w]).view(np.int32))
             for w in range(keys.shape[1])], torch.from_numpy(counts.astype(np.int64)).to(dtype))


def _ref_bytes(tmp_path, k, mode, abu, keys, counts) -> bytes:
    path = tmp_path / "ref.txt"
    n = RefSortCounter.write_output(_RefStub(k, mode, abu, keys, counts), str(path))
    data = path.read_bytes()
    assert n == data.count(b"\n")
    return data


@pytest.mark.parametrize("abu", [-1, 0, 1, 2, 3])
@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("k", KS)
def test_plain_equals_jax_writer(tmp_path, k, mode, abu):
    keys, counts = _rows(k, 300, seed=k)
    want = _ref_bytes(tmp_path, k, mode, abu, keys, counts)
    cols, cnt = _columns(keys, counts, torch.int32 if k % 2 else torch.int64)
    text, lines = writer.format_lines_plain(cols, cnt, k=k, mode=mode, min_abundance=abu)
    assert text.dtype == torch.uint8
    assert bytes(text.numpy()) == want
    assert lines == want.count(b"\n")
    # the dispatching wrapper runs the plain version on CPU tensors
    launches = writer.format_lines.launches
    text2, lines2 = writer.format_lines(cols, cnt, k=k, mode=mode, min_abundance=abu)
    assert bytes(text2.numpy()) == want and lines2 == lines
    assert writer.format_lines.launches == launches


def test_plain_row_blocks_equal_jax_writer(tmp_path, monkeypatch):
    """The plain version's byte matrices of PLAIN_ROWS rows, here 7, join
    into the same text."""
    k = 51
    keys, counts = _rows(k, 300, seed=11)
    want = _ref_bytes(tmp_path, k, 0, 0, keys, counts)
    monkeypatch.setattr(writer, "PLAIN_ROWS", 7)
    text, lines = writer.format_lines_plain(*_columns(keys, counts), k=k, mode=0,
                                            min_abundance=0)
    assert bytes(text.numpy()) == want and lines == want.count(b"\n") > 7


@pytest.mark.parametrize("case", ["no_rows", "all_dead", "all_below", "wrap_kept"])
@pytest.mark.parametrize("mode", [0, 2])
def test_empty_and_wrapped_files(tmp_path, case, mode):
    """No rows, only dead rows, every row under the threshold: an empty
    file; -a 0 keeps the rows whose count wraps (mode 0) to 0."""
    k = 21
    keys, _ = _rows(k, 4, seed=5)
    counts = {"no_rows": np.zeros(0, np.int64), "all_dead": np.zeros(4, np.int64),
              "all_below": np.array([1, 2, 0, 3]),
              "wrap_kept": np.array([65536, 131072, 0, 65537])}[case]
    keys = keys[: counts.shape[0]]
    abu = {"all_below": 4, "wrap_kept": 0}.get(case, 1)
    want = _ref_bytes(tmp_path, k, mode, abu, keys, counts)
    if case == "wrap_kept":
        assert want.count(b" 0\n") == (2 if mode == 0 else 0)
        assert len(want.splitlines()) == 3
    else:
        assert want == b""
    cols, cnt = _columns(keys, counts)
    text, lines = writer.format_lines_plain(cols, cnt, k=k, mode=mode, min_abundance=abu)
    assert bytes(text.numpy()) == want and lines == want.count(b"\n")
    out = tmp_path / "port.txt"
    assert writer.write_lines(str(out), [(cols, cnt)], k=k, mode=mode, min_abundance=abu) \
        == lines
    assert out.read_bytes() == want


@pytest.mark.parametrize("budget", ["one_line", "few_lines", "everything"])
@pytest.mark.parametrize("kernels", ["cuda", "plain"])
def test_chunked_write_equals_one_piece(tmp_path, budget, kernels):
    """write_lines over several parts, in chunks of one line's budget, a
    few lines' and everything: one file, equal to the JAX writer's on the
    parts' rows in order."""
    k, mode, abu = 33, 0, 0
    parts = [_rows(k, n, seed=40 + n) for n in (0, 57, 1, 300)]
    keys = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    want = _ref_bytes(tmp_path, k, mode, abu, keys, counts)
    chunk = {"one_line": writer.line_bytes(k), "few_lines": 5 * writer.line_bytes(k) - 1,
             "everything": writer.CHUNK_BYTES}[budget]
    out = tmp_path / "port.txt"
    n = writer.write_lines(str(out), [_columns(*p) for p in parts], k=k, mode=mode,
                           min_abundance=abu, kernels=kernels, chunk_bytes=chunk)
    assert out.read_bytes() == want and n == want.count(b"\n")


def test_table_layout_equals_stacked_columns():
    """Key columns that are views of a (C, W) slot array (the probe
    table's dump part) give the same text as contiguous columns."""
    k = 40
    keys, counts = _rows(k, 200, seed=9)
    tk = torch.from_numpy(keys.view(np.int32).copy())
    cols, cnt = _columns(keys, counts, torch.int32)
    a = writer.format_lines(tuple(tk.unbind(1)), cnt, k=k, mode=2, min_abundance=2)
    b = writer.format_lines(cols, cnt, k=k, mode=2, min_abundance=2)
    assert torch.equal(a[0], b[0]) and a[1] == b[1] > 0


def test_rejects_bad_parts():
    cols, cnt = _columns(*_rows(20, 8, seed=1))
    with pytest.raises(ValueError, match="key columns"):
        writer.format_lines_plain(cols[:1], cnt, k=20, mode=2, min_abundance=1)
    with pytest.raises(ValueError, match="int32 or int64"):
        writer.format_lines_plain(cols, cnt.float(), k=20, mode=2, min_abundance=1)
    with pytest.raises(ValueError, match="kernels"):
        writer.write_lines("unused", [(cols, cnt)], k=20, mode=2, min_abundance=1,
                           kernels="xla")


@pytest.mark.parametrize("k,extra", [(13, []), (31, []), (31, ["--pipeline", "classic"]),
                                     (13, ["--backend", "table"])])
def test_mode0_wrap_through_both_clis(tmp_path, k, extra):
    """Poly-A with 131,072 windows (a multiple of 65,536) and a second
    record: with -m 0 -a 0 the A..A line wraps to 0 and is written by
    both CLIs, byte for byte (the table writes slot order: compared
    sorted)."""
    p = tmp_path / "polya.fa"
    tail = "ACGTTGCAACGGTACCATGGCA" * 3
    p.write_text(">a\n" + "A" * (131072 + k - 1) + "\n>b\n" + tail + "\n")
    a, b = tmp_path / "port.out", tmp_path / "ref.out"
    common = [str(p), str(k), "-s", "4096", "-m", "0", "-a", "0", "-q", *extra]
    assert cli.main(common + ["-o", str(a), "--device", "cpu"]) == 0
    assert ref_cli.main(common + ["-o", str(b)]) == 0
    got, want = a.read_bytes(), b.read_bytes()
    assert ("A" * k + " 0\n").encode() in got.splitlines(keepends=True)
    if "table" in extra:
        assert sorted(got.splitlines()) == sorted(want.splitlines())
    else:
        assert got == want


def _counter(name):
    from kaarme_tpu_torch import parallel
    from kaarme_tpu_torch.models.counter import CounterConfig, KmerCounter
    from kaarme_tpu_torch.models.skm_counter import SkmCounter, SkmCounterConfig
    from kaarme_tpu_torch.models.sort_counter import SortCounterConfig, SortKmerCounter

    out = dict(mode=0, min_abundance=2)
    sort = dict(batch_windows=1 << 12, superbatch_batches=2, prefix_cap=1 << 12, device="cpu")
    table = dict(min_slots=1 << 13, tile=128, batch_tiles=4)
    mesh = parallel.make_mesh(2, "cpu")
    return {
        "sort": lambda: SortKmerCounter(SortCounterConfig(k=13, **sort, **out)),
        "sort_merge": lambda: SortKmerCounter(SortCounterConfig(k=21, compactor="merge", **sort,
                                                                **out)),
        "skm": lambda: SkmCounter(SkmCounterConfig(k=31, **sort, **out)),
        "table": lambda: KmerCounter(CounterConfig(k=21, device="cpu", **table, **out)),
        "sharded_sort": lambda: parallel.ShardedSortCounter(parallel.ShardedSortConfig(
            k=13, batch_windows=1 << 10, prefix_cap=1 << 11, **out), mesh),
        "sharded_skm": lambda: parallel.ShardedSkmCounter(parallel.ShardedSkmConfig(
            k=31, batch_windows=1 << 10, prefix_cap=1 << 11, **out), mesh),
        "sharded_table": lambda: parallel.ShardedKmerCounter(parallel.ShardedCounterConfig(
            k=21, **table, **out), mesh),
    }[name]()


@pytest.mark.parametrize("name", ["sort", "sort_merge", "skm", "table", "sharded_sort",
                                  "sharded_skm", "sharded_table"])
def test_write_output_formats_the_dump_parts(tmp_path, monkeypatch, name):
    """Every counter's ``write_output`` hands ``write_lines`` its
    ``dump_columns()`` (one part; the sharded counters one per shard, in
    shard order: the table's own records, the sort and skm counters' key
    ranges) and writes what the JAX writer makes of its ``dump()``."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 6000).astype(np.uint8)
    codes[::151] = 4
    codes = np.concatenate([codes, codes[:2500]])        # counts of 2 and more
    counter = _counter(name)
    counter.count_codes(codes)
    seen, real = [], writer.write_lines
    monkeypatch.setattr(writer, "write_lines",
                        lambda path, parts, **kw: seen.append(parts) or real(path, parts, **kw))
    out = tmp_path / "port.txt"
    n = counter.write_output(str(out))
    assert len(seen) == 1 and len(seen[0]) == (2 if name.startswith("sharded") else 1)
    keys, counts = counter.dump()
    cfg = counter.cfg
    want = _ref_bytes(tmp_path, cfg.k, cfg.mode, cfg.min_abundance, keys, counts)
    assert out.read_bytes() == want and n == want.count(b"\n") > 100
    assert counter.stats["write_seconds"] > 0
