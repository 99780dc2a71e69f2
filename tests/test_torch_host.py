"""The port's own host layer (kaarme_tpu_torch.io and .utils, the CLI's
parser and validation), held to the JAX package's modules it was copied
from, on seeded inputs: the same codes, words and messages, byte for
byte.  Also: the port's native encoder is built from its own source
into build/, and running the port's host layer touches nothing under
kaarme_tpu/."""

import gzip
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from kaarme_tpu import cli as ref_cli
from kaarme_tpu.io import fastio as ref_fastio
from kaarme_tpu.io import reader as ref_reader
from kaarme_tpu.io.codebuf import CodeBuffer as RefCodeBuffer
from kaarme_tpu.utils import codec as ref_codec
from kaarme_tpu.utils.mathutils import bloom_sizing as ref_bloom_sizing
from kaarme_tpu_torch import cli
from kaarme_tpu_torch.io import fastio, reader
from kaarme_tpu_torch.io.codebuf import CodeBuffer
from kaarme_tpu_torch.utils import codec
from kaarme_tpu_torch.utils.mathutils import bloom_sizing

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _fasta_bytes(seed: int, n_rec: int = 40) -> bytes:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_rec):
        seq = "".join(rng.choice(list("ACGTacgtNRY"), size=int(rng.integers(1, 400)),
                                 p=[.215, .215, .215, .215, .02, .02, .02, .02, .02, .02, .02]))
        width = int(rng.integers(10, 90))
        out.append(f">read_{i} some > header text\n")
        out.append("\n".join(seq[j:j + width] for j in range(0, len(seq), width)) + "\n")
    return "".join(out).encode()


def _fastq_bytes(seed: int, n_rec: int = 40) -> bytes:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_rec):
        seq = "".join(rng.choice(list("ACGTN"), size=int(rng.integers(1, 200))))
        qual = "".join(rng.choice(list("@+!#I5"), size=len(seq)))
        w = int(rng.integers(20, 120))
        out.append(f"@r{i}\n" + "\n".join(seq[j:j + w] for j in range(0, len(seq), w))
                   + f"\n+\n" + "\n".join(qual[j:j + w] for j in range(0, len(qual), w)) + "\n")
    return "".join(out).encode()


def _chunks(buf: bytes, seed: int):
    """Cut points at random, several of them inside headers."""
    rng = np.random.default_rng(seed)
    cuts = sorted(set(rng.integers(1, len(buf), 25).tolist()))
    cuts += [i + 3 for i in range(len(buf)) if buf[i:i + 1] == b">"][:5]
    cuts = sorted(set(c for c in cuts if 0 < c < len(buf)))
    return [buf[a:b] for a, b in zip([0] + cuts, cuts + [len(buf)])]


def _encoders(native: bool):
    """(encode_plain, encode_fasta, encode_fastq) of the port: the native
    library's, or the NumPy encoders."""
    if native:
        if fastio.get_lib() is None:
            pytest.skip("g++ is missing: no native encoder to compare")
        return fastio.encode_plain, fastio.encode_fasta, fastio.encode_fastq
    return (codec.encode_plain, codec.encode_fasta,
            lambda b, st=None: codec.encode_fastq(b, st or codec.FASTQ_STATE0))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("seed", [1, 2])
def test_fasta_chunks_with_split_headers_match_reference(native, seed):
    _, enc_fasta, _ = _encoders(native)
    chunks = _chunks(_fasta_bytes(seed), seed)
    got, want, st_g, st_w = [], [], False, False
    for c in chunks:
        g, st_g = enc_fasta(c, st_g)
        w, st_w = ref_fastio.encode_fasta(c, st_w)
        assert st_g == st_w
        got.append(g)
        want.append(w)
    assert any(codec.encode_fasta(c, False)[1] for c in chunks)      # a header was split
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    np.testing.assert_array_equal(np.concatenate(got),
                                  ref_codec.encode_fasta(_fasta_bytes(seed))[0])


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_fastq_state_carry_and_plain_match_reference(native):
    enc_plain, _, enc_fastq = _encoders(native)
    buf = _fastq_bytes(7)
    got, want, st_g, st_w = [], [], None, None
    for c in _chunks(buf, 7):
        g, st_g = enc_fastq(c, st_g)
        w, st_w = ref_fastio.encode_fastq(c, st_w)
        assert tuple(st_g) == tuple(st_w)
        got.append(g)
        want.append(w)
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    plain = _fasta_bytes(3).replace(b">", b"A")
    np.testing.assert_array_equal(enc_plain(plain), ref_fastio.encode_plain(plain))
    np.testing.assert_array_equal(enc_plain(b""), ref_fastio.encode_plain(b""))


@pytest.mark.parametrize("n", [0, 5, 33, 70_001])
def test_pack_stream_native_and_numpy_match_reference(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 5, n).astype(np.uint8)
    want = ref_fastio.pack_stream(codes)
    for got in (fastio.pack_stream(codes), fastio.pack_stream_np(codes)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("gz", [False, True], ids=["plain_file", "gzip"])
@pytest.mark.parametrize("fmt", ["fasta", "fastq", "plain"])
def test_code_chunk_reader_matches_reference(tmp_path, gz, fmt):
    buf = {"fasta": _fasta_bytes(11), "fastq": _fastq_bytes(11),
           "plain": _fasta_bytes(11).replace(b">", b"C")}[fmt]
    path = tmp_path / ("in.gz" if gz else "in.txt")
    path.write_bytes(gzip.compress(buf) if gz else buf)
    assert reader.sniff_format(str(path)) == ref_reader.sniff_format(str(path))
    got = list(reader.PrefetchingReader(reader.CodeChunkReader(str(path), chunk_bytes=997)))
    want = list(ref_reader.CodeChunkReader(str(path), chunk_bytes=997))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got), ref_reader.read_codes(str(path)))
    (tmp_path / "empty").write_bytes(b"")
    with pytest.raises(reader.FormatError, match="empty"):
        reader.sniff_format(str(tmp_path / "empty"))


def test_code_buffer_matches_reference():
    rng = np.random.default_rng(4)
    a, b = CodeBuffer(), RefCodeBuffer()
    for _ in range(30):
        c = rng.integers(0, 5, int(rng.integers(0, 300))).astype(np.uint8)
        a.append(c)
        b.append(c)
        if len(a) > 60:
            need = int(rng.integers(30, len(a)))
            adv = int(rng.integers(0, need + 1))
            np.testing.assert_array_equal(a.take(need, adv), b.take(need, adv))
        assert len(a) == len(b)
    np.testing.assert_array_equal(a.take_all(), b.take_all())


def test_codec_helpers_and_bloom_sizing_match_reference():
    rng = np.random.default_rng(9)
    for k in (2, 15, 16, 17, 31, 51, 201):
        s = "".join(rng.choice(list("ACGT"), size=k))
        assert codec.canonical(s) == ref_codec.canonical(s)
        assert codec.revcomp(s) == ref_codec.revcomp(s)
        np.testing.assert_array_equal(codec.pack_kmer(s), ref_codec.pack_kmer(s))
        assert codec.words_per_kmer(k) == ref_codec.words_per_kmer(k)
        words = rng.integers(0, 1 << 32, (7, codec.words_per_kmer(k)), dtype=np.uint64)
        assert codec.unpack_kmers(words.astype(np.uint32), k) == \
            ref_codec.unpack_kmers(words.astype(np.uint32), k)
    with pytest.raises(ValueError, match="invalid base"):
        codec.pack_kmer("ACGN")
    for u in (1, 1000, 4000, 5_000_000, 10 ** 9):
        for fpr in (0.001, 0.01, 0.02, 0.5, 0.999):
            assert bloom_sizing(u, fpr) == ref_bloom_sizing(u, fpr)


@pytest.mark.parametrize("argv", [
    ["1"], ["31"], ["31", "-s", "9", "-u", "9"], ["31", "-b", "-s", "9"],
    ["31", "-u", "9"], ["31", "-s", "9", "-t", "2"], ["31", "-s", "9", "-t", "65"],
    ["31", "-b", "-u", "9", "-f", "0.0001"], ["31", "-s", "9", "--devices", "2",
                                               "--backend", "table"],
    ["31", "-b", "-u", "9", "--devices", "2"], ["13", "-s", "9", "--pipeline", "skm"],
    ["31", "-s", "9", "--pipeline", "skm", "--backend", "table"], ["31", "-s", "9"],
    ["13", "-s", "9"], ["31", "-b", "-u", "9", "-f", "0.5"]])
@pytest.mark.parametrize("missing", [False, True], ids=["file", "no_file"])
def test_validate_matches_reference(tmp_path, argv, missing):
    """The reference's refusals, messages and --pipeline auto choice; the
    port adds only its own refusals of routes it has not ported."""
    path = tmp_path / "in.fa"
    if not missing:
        path.write_bytes(b">r\nACGT\n")
    full = [str(path)] + argv
    a, b = cli.build_parser().parse_args(full), ref_cli.build_parser().parse_args(full)
    want = ref_cli.validate(b)
    got = cli.validate(a)
    if want:
        assert got == want
    else:
        assert a.pipeline == b.pipeline
        assert got == "" or "not yet ported" in got


def test_native_encoder_builds_under_build_and_leaves_jax_package_alone(tmp_path):
    """The port's encoder library is built from csrc/host/_fastio.cpp into
    build/kaarme_tpu_torch/, named by the source's hash; a port run in a
    fresh process writes nothing under kaarme_tpu/ (no file there changes
    mtime or appears)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the NumPy encoders run instead")
    ref_fastio.get_lib()     # the JAX package's own (re)build, if any, comes first

    def snapshot():
        out = {}
        for dirpath, dirs, files in os.walk(ROOT / "kaarme_tpu"):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                out[os.path.join(dirpath, f)] = os.stat(os.path.join(dirpath, f)).st_mtime_ns
        return out

    before = snapshot()
    fa = tmp_path / "r.fa"
    fa.write_bytes(_fasta_bytes(5))
    code = ("import sys; import numpy as np; from kaarme_tpu_torch.io import fastio, reader\n"
            "lib = fastio.get_lib(); assert lib is not None\n"
            f"codes = np.concatenate(list(reader.CodeChunkReader({str(fa)!r})))\n"
            "fastio.pack_stream(codes)\n"
            "print(fastio.lib_path())\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'kaarme_tpu']\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         timeout=300)
    assert res.returncode == 0, res.stderr
    path = pathlib.Path(res.stdout.strip().splitlines()[-1])
    assert path.parent == ROOT / "build" / "kaarme_tpu_torch" and path.is_file()
    assert path.name.startswith("libkaarme_fastio_")
    assert snapshot() == before
