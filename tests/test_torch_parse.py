"""P1 (``ops/cuda_parse.py``, ``csrc/parse_pack.cu``) and the device code
stream (``io/rawstream.py``) that the one-card sort-route counters read
FASTA and plain text through.

On the CPU: P1's plain version, fed block by block through the stream,
gives every superstep's transfer chunk bit for bit as the host path
does (``fastio.encode_fasta`` / ``encode_plain``, then
``pack_stream_np``), and ``count_file`` on the device path equals
``count_codes`` of the host-encoded codes (stores, count files, Bloom
filters).  On a card (marked ``cuda``): the kernel against the plain
version, and full-size chunks against the host's pack.  No JAX here, so
the file also runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_parse.py -q
"""

import gzip

import numpy as np
import pytest
import torch

from kaarme_tpu_torch import cli
from kaarme_tpu_torch.io import fastio, rawstream
from kaarme_tpu_torch.models import bloom_counter
from kaarme_tpu_torch.models.skm_counter import SkmCounter, SkmCounterConfig
from kaarme_tpu_torch.models.sort_counter import SortCounterConfig, SortKmerCounter
from kaarme_tpu_torch.ops import _build, cuda_parse

_SEQ = np.frombuffer(b"ACGTACGTACGTacgtNn", np.uint8)


def _fasta(rng, nbytes: int) -> bytes:
    """Random FASTA of about ``nbytes``: wrapped lines, '\\r\\n' ends, empty
    lines, lower case and N, headers long enough to span blocks and
    holding '>', and '>' in the middle of a sequence line (which opens a
    header there)."""
    out, size, i = [], 0, 0
    while size < nbytes:
        hdr = b">r%d" % i + b" x>y" * int(rng.integers(0, 3) ** 4)
        rec = [hdr + (b"\r\n" if rng.random() < 0.1 else b"\n")]
        seq = _SEQ[rng.integers(0, _SEQ.shape[0], int(rng.integers(0, 400)))].tobytes()
        if rng.random() < 0.1 and seq:
            j = int(rng.integers(0, len(seq)))
            seq = seq[:j] + b">" + seq[j:]
        step = int(rng.integers(20, 120))
        for j in range(0, len(seq), step):
            rec.append(seq[j:j + step] + (b"\r\n" if rng.random() < 0.05 else b"\n"))
            if rng.random() < 0.05:
                rec.append(b"\n")
        blob = b"".join(rec)
        out.append(blob)
        size += len(blob)
        i += 1
    return b"".join(out)


def _plain(rng, nbytes: int) -> bytes:
    """Random plain text: one read a line, some empty lines and junk."""
    lines, size = [], 0
    while size < nbytes:
        ln = _SEQ[rng.integers(0, _SEQ.shape[0], int(rng.integers(0, 200)))].tobytes()
        if rng.random() < 0.05:
            ln += b"\t#"
        lines.append(ln)
        size += len(ln) + 1
    return b"\n".join(lines) + b"\n"


def _host_codes(data: bytes, fasta: bool) -> np.ndarray:
    return fastio.encode_fasta(data)[0] if fasta else fastio.encode_plain(data)


def _want(codes: np.ndarray, k: int, sb: int, pack=fastio.pack_stream_np) -> list:
    """The host path's supersteps of ``codes``: (packed, bitmap, windows)."""
    out, s, T = [], 0, codes.shape[0]
    while (s + 1) * sb + k - 1 <= T:
        out.append((codes[s * sb: s * sb + sb + k - 1], sb))
        s += 1
    if T - s * sb >= k:
        out.append((codes[s * sb:], T - s * sb - k + 1))
    return [pack(c) + (n,) for c, n in out]


def _blocks(rng, data: bytes, most: int):
    """``data`` cut at random places into blocks of 1 .. ``most`` bytes."""
    pos = 0
    while pos < len(data):
        n = int(rng.integers(1, most + 1))
        yield torch.frombuffer(bytearray(data[pos:pos + n]), dtype=torch.uint8)
        pos += n


def _stream(data: bytes, fasta: bool, k: int, sb: int, most: int, device, kernels="cuda",
            seed=0, head=None) -> list:
    rng = np.random.default_rng(seed)
    st = rawstream.CodeStream(device, k, sb, kernels)
    got = st.feed_codes(head) if head is not None else []
    for block in _blocks(rng, data, most):
        got += st.feed(block, fasta)
    return got + st.close()


def _assert_chunks(got, want):
    assert len(got) == len(want)
    for (words, bits, n), (pw, pm, wn) in zip(got, want):
        assert n == wn
        assert np.array_equal(words.cpu().numpy().view(np.uint32), pw)
        assert np.array_equal(bits.cpu().numpy().view(np.uint32), pm)


_SHAPES = [(31, 64), (5, 32), (201, 64), (51, 1024)]


@pytest.mark.parametrize("k,sb", _SHAPES, ids=[f"k{k}_sb{sb}" for k, sb in _SHAPES])
@pytest.mark.parametrize("most", [1, 13, 512, 5000])
@pytest.mark.parametrize("fmt", ["fasta", "plain"])
def test_p1_plain_chunks_equal_host_encode_and_pack(fmt, most, k, sb):
    """Every superstep's chunk (halos of k - 1 codes, and of more than a
    superstep at k=201, sb=64), blocks of 1 byte to 5 KB that split
    headers, '\\r\\n' and records anywhere."""
    rng = np.random.default_rng(most * 1000 + k)
    data = (_fasta if fmt == "fasta" else _plain)(rng, 3000 if most == 1 else 20000)
    got = _stream(data, fmt == "fasta", k, sb, most, torch.device("cpu"), seed=most)
    _assert_chunks(got, _want(_host_codes(data, fmt == "fasta"), k, sb))


@pytest.mark.parametrize("case", ["block_ends_in_header", "starts_in_sequence",
                                  "shorter_than_k", "empty", "head_codes"])
def test_p1_plain_edge_streams(case):
    k, sb = 21, 64
    head = None
    if case == "block_ends_in_header":
        data = b">" + b"h>" * 400 + b"\nACGTTGCA" * 50 + b"\n>x\n" + b"GATTACA" * 40 + b"\n"
    elif case == "starts_in_sequence":
        data = b"ACGT" * 100 + b"\n>hdr\nTTTT" * 30
    elif case == "shorter_than_k":
        data = b">a\nACGTACGTAC\n>b\nACG\n"
    elif case == "empty":
        data = b""
    else:
        head = np.random.default_rng(5).integers(0, 5, 150).astype(np.uint8)
        data = b">r\n" + b"ACGTTT" * 60 + b"\n"
    codes = _host_codes(data, True)
    if head is not None:
        codes = np.concatenate([head, codes])
    for most in (1, 7, 300):
        got = _stream(data, True, k, sb, most, torch.device("cpu"), head=head)
        _assert_chunks(got, _want(codes, k, sb))


def test_p1_plain_flags_a_code_outside_its_chunks():
    """A block whose codes land past the chunks it is given sets the error
    flag, and the stream's next read of the offset raises."""
    state = cuda_parse.ParseState(torch.device("cpu"))
    chunk = (torch.zeros(6, dtype=torch.int32), torch.zeros(3, dtype=torch.int32))
    raw = torch.frombuffer(bytearray(b"ACGT" * 30), dtype=torch.uint8)
    cuda_parse.parse_pack(raw, fasta=False, state=state, chunks=[chunk], base=0, sb=64, span=84)
    assert state.host_view(state.buf.tolist()) == (120, 0, 1)
    st = rawstream.CodeStream(torch.device("cpu"), 21, 64, "cuda")
    st.state.buf[4] = 1
    with pytest.raises(RuntimeError, match="outside its chunk table"):
        st.close()


# -- count_file on the device path against count_codes of the host's codes -----------


def _reads_fasta(rng, n_reads=400, genome=3000, err=0.02, wrap=70) -> bytes:
    g = rng.integers(0, 4, genome)
    out = []
    for i in range(n_reads):
        s = int(rng.integers(0, genome - 150))
        r = g[s:s + 150].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        flip = rng.random(150) < err
        r[flip] = (r[flip] + 1) % 4
        seq = np.frombuffer(b"ACGT", np.uint8)[r].tobytes()
        if rng.random() < 0.05:
            seq = seq[:40] + b"N" + seq[41:]
        out.append(b">read%d\n" % i + b"\n".join(seq[j:j + wrap] for j in range(0, 150, wrap))
                   + b"\n")
    return b"".join(out)


def _write(tmp_path, name, data: bytes, gz: bool) -> str:
    path = tmp_path / (name + (".gz" if gz else ""))
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)
    return str(path)


def _cfg(route, **kw):
    base = dict(min_abundance=1, device="cpu", batch_windows=1 << 10, superbatch_batches=2,
                prefix_cap=1 << 12)
    base.update(kw)
    if route in ("skm", "bloom_skm"):
        return SkmCounterConfig(k=31, **base)
    return SortCounterConfig(k=13, **base)


def _make(route, cfg):
    if route == "skm":
        return SkmCounter(cfg)
    if route == "classic":
        return SortKmerCounter(cfg)
    cls = bloom_counter.BloomSkmCounter if route == "bloom_skm" else bloom_counter.BloomSortCounter
    return cls(cfg, 20000)


def _same(a, b, tmp_path):
    ka, ca = a.dump()
    kb, cb = b.dump()
    assert np.array_equal(ka, kb) and np.array_equal(ca, cb)
    a.write_output(str(tmp_path / "a.txt"))
    b.write_output(str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()
    for key in ("windows_processed", "batches", "new_in_first", "new_in_second",
                "pass1_batches"):
        assert a.stats.get(key) == b.stats.get(key), key
    if hasattr(a, "bf2"):
        assert torch.equal(a.bf2, b.bf2)


@pytest.mark.parametrize("gz", [False, True], ids=["text", "gzip"])
@pytest.mark.parametrize("route", ["skm", "classic", "bloom_skm", "bloom_sort"])
def test_count_file_on_the_device_path_equals_count_codes(tmp_path, route, gz):
    """Small supersteps (2,048 windows) and 1,000-byte blocks: supersteps
    straddle blocks and halos; both passes of -b read the file."""
    data = _reads_fasta(np.random.default_rng(7))
    path = _write(tmp_path, "r.fa", data, gz)
    codes = _host_codes(data, True)
    a, b = _make(route, _cfg(route)), _make(route, _cfg(route))
    if route.startswith("bloom"):
        a.count_file_two_pass(path, chunk_bytes=1000)
        b.count_codes_two_pass(codes)
        assert a.stats["device_parsed_bytes"] == 2 * len(data)
    else:
        a.count_file(path, chunk_bytes=1000)
        b.count_codes(codes)
        assert a.stats["device_parsed_bytes"] == len(data)
    assert "host_encoded_bytes" not in a.stats
    assert a.stats["batches"] > 4
    _same(a, b, tmp_path)


@pytest.mark.parametrize("route", ["skm", "classic"])
def test_count_file_of_plain_text_equals_count_codes(tmp_path, route):
    data = _plain(np.random.default_rng(3), 60000).replace(b"\t#", b"")
    path = _write(tmp_path, "r.txt", data, False)
    a = _make(route, _cfg(route)).count_file(path, chunk_bytes=777, prefetch=0)
    b = _make(route, _cfg(route)).count_codes(_host_codes(data, False))
    _same(a, b, tmp_path)


@pytest.mark.parametrize("past", [None, 0, 1], ids=["one_read", "k_minus_1_past", "k_past"])
def test_count_file_with_a_short_tail(tmp_path, past):
    """A file shorter than a superstep, and files whose last superstep holds
    k - 1 codes (no windows: they are the halo of the one before) and k
    codes (one window)."""
    cfg = _cfg("skm")
    if past is None:
        data = b">a\n" + b"ACGTTGCAAGT" * 5 + b"\n>b\nACGT\n"
    else:
        n = cfg.superstep_windows + cfg.k - 1 + past - 1     # the header's 4 is a code
        seq = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(1).integers(0, 4, n)]
        data = b">x\n" + seq.tobytes() + b"\n"
    codes = _host_codes(data, True)
    if past is not None:
        assert codes.shape[0] == cfg.superstep_windows + cfg.k - 1 + past
    path = _write(tmp_path, "r.fa", data, False)
    a = SkmCounter(cfg).count_file(path, chunk_bytes=64)
    b = SkmCounter(cfg).count_codes(codes)
    _same(a, b, tmp_path)
    assert a.stats["batches"] == (1 if past in (None, 0) else 2)


@pytest.mark.parametrize("tail", ["short", "longer_than_a_superstep"])
def test_count_file_after_load_joins_the_checkpoint_tail(tmp_path, tail):
    """A checkpoint's unprocessed tail opens the next file's stream with its
    k - 1 overlap; a tail longer than the loading config's superstep is
    first cut into whole supersteps on the host path."""
    rng = np.random.default_rng(11)
    first, second = _reads_fasta(rng, 150), _reads_fasta(rng, 150)
    c1 = SkmCounter(_cfg("skm", batch_windows=1 << 12))
    c1.add_codes(_host_codes(first, True))
    ck = str(tmp_path / "ck.npz")
    c1.save(ck)
    cfg = _cfg("skm", batch_windows=1 << 12 if tail == "short" else 1 << 9)
    assert len(np.load(ck)["tail"]) > (cfg.superstep_windows + 30 if tail != "short" else 0)
    a = SkmCounter.load(ck, cfg).count_file(_write(tmp_path, "b.fa", second, False),
                                            chunk_bytes=999)
    b = SkmCounter.load(ck, cfg).count_codes(_host_codes(second, True))
    _same(a, b, tmp_path)


def test_fastq_and_sharded_counts_encode_on_the_host(tmp_path):
    """The host path: FASTQ on one card, and --devices 2 (CPU shards) on
    FASTA, encode every byte on the host and parse none on the device."""
    rng = np.random.default_rng(2)
    fq = b"".join(b"@q%d\n" % i + np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 120)]
                  .tobytes() + b"\n+\n" + b"I" * 120 + b"\n" for i in range(300))
    path = _write(tmp_path, "r.fq", fq, False)
    c = SkmCounter(_cfg("skm")).count_file(path)
    assert c.stats["host_encoded_bytes"] == len(fq) and "device_parsed_bytes" not in c.stats
    fa = _reads_fasta(rng, 300)
    path = _write(tmp_path, "r.fa", fa, False)
    rc, c = cli.run([path, "31", "--device", "cpu", "--devices", "2", "-q", "-a", "1",
                     "-s", "5000", "-o", str(tmp_path / "c.txt")])
    assert rc == 0
    assert c.stats["host_encoded_bytes"] == len(fa) and "device_parsed_bytes" not in c.stats
    rc, c = cli.run([path, "31", "--device", "cpu", "-q", "-a", "1", "-s", "5000",
                     "-o", str(tmp_path / "d.txt")])
    assert rc == 0
    assert c.stats["device_parsed_bytes"] == len(fa) and "host_encoded_bytes" not in c.stats
    assert (tmp_path / "c.txt").read_bytes() == (tmp_path / "d.txt").read_bytes()


# -- on a card -----------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (P1 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,sb", _SHAPES + [(51, 1 << 16)],
                         ids=[f"k{k}_sb{sb}" for k, sb in _SHAPES + [(51, 1 << 16)]])
@pytest.mark.parametrize("most", [13, 4096, 1 << 20])
@pytest.mark.parametrize("fmt", ["fasta", "plain"])
def test_p1_kernel_equals_plain(dev, fmt, most, k, sb):
    """The same blocks through the kernel and through the plain version
    (on the CPU, where it runs fast), and against the host's encode +
    pack; 3 MB at the large superstep (4 KiB tiles, many a launch)."""
    rng = np.random.default_rng(most + k)
    big = sb >= 1 << 16 and most >= 4096
    data = (_fasta if fmt == "fasta" else _plain)(rng, 3 << 20 if big else 8000)
    want = _stream(data, fmt == "fasta", k, sb, most, torch.device("cpu"), seed=most)
    before = cuda_parse.parse_pack.launches
    got = _stream(data, fmt == "fasta", k, sb, most, dev, seed=most)
    torch.cuda.synchronize()
    assert cuda_parse.parse_pack.launches > before
    _assert_chunks(got, [(w.numpy().view(np.uint32), b.numpy().view(np.uint32), n)
                         for w, b, n in want])
    _assert_chunks(got, _want(_host_codes(data, fmt == "fasta"), k, sb))


def _ecoli_like(rng, n_reads: int) -> bytes:
    """150 bp reads of a random 4.6 Mb genome, one a record, as the
    benchmark's inputs are laid out (147 MB at 920,000 reads)."""
    genome = rng.integers(0, 4, 4_600_000).astype(np.uint8)
    starts = rng.integers(0, genome.shape[0] - 150, n_reads)
    reads = genome[starts[:, None] + np.arange(150)]
    seq = np.frombuffer(b"ACGT", np.uint8)[reads]
    hdr = np.frombuffer(b">r0000000\n", np.uint8)
    rows = np.concatenate([np.broadcast_to(hdr, (n_reads, hdr.shape[0])), seq,
                           np.full((n_reads, 1), 10, np.uint8)], axis=1)
    return rows.tobytes()


@pytest.mark.cuda
def test_p1_full_size_chunks_equal_the_host_pack(dev):
    """A 147 MB FASTA in 8 MiB blocks at the benchmark's superstep (2^26
    windows, k=51): every chunk equals ``pack_chunk``'s dense form of the
    host's codes."""
    data = _ecoli_like(np.random.default_rng(0), 920_000)
    k, sb = 51, 1 << 26
    st = rawstream.CodeStream(dev, k, sb, "cuda")
    got = []
    for pos in range(0, len(data), 8 << 20):
        got += st.feed(torch.frombuffer(bytearray(data[pos:pos + (8 << 20)]),
                                        dtype=torch.uint8), True)
    got += st.close()
    _assert_chunks(got, _want(_host_codes(data, True), k, sb, pack=fastio.pack_stream))
    assert len(got) == 3


@pytest.mark.cuda
def test_p1_failed_launch_raises(dev, tmp_path, monkeypatch):
    """No host fallback: a P1 launch that reports an error ends the count."""
    path = _write(tmp_path, "r.fa", _reads_fasta(np.random.default_rng(1), 50), False)
    lib = _build.lib()

    class Failing:
        def kt_parse_pack_scratch(self, nb):
            return lib.kt_parse_pack_scratch(nb)

        def kt_parse_pack(self, *args):
            return 700

    monkeypatch.setattr(cuda_parse._build, "lib", lambda: Failing())
    c = SkmCounter(SkmCounterConfig(k=31, min_abundance=1, batch_windows=1 << 12))
    with pytest.raises(RuntimeError, match="kt_parse_pack"):
        c.count_file(path)
