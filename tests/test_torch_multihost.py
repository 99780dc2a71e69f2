"""The port's multi-host counting (``kaarme_tpu_torch/parallel/multihost.py``)
on the CPU, against the JAX package's ``kaarme_tpu/parallel/multihost.py``.

- the host half byte for byte: each host's code chunks (FASTA with
  wrapped lines, headers cut by span edges and N; plain; FASTQ with
  '@'/'+'-leading qualities) for H in {2, 3, 5}, their union == the
  golden count, the gzip refusal, ``presplit`` part files (plain and
  gzipped) and ``merge_parts``;
- one two-process launcher run over gloo (2 CPU shards per process):
  part h == the JAX ``ShardedSortCounter``'s records on devices 2h and
  2h+1 of a 4-device mesh (after the exchange a record's shard depends
  only on its key and the global shard count), the merged file == the
  JAX CLI's count file == golden, one prefix cap and one count of grow
  events on both processes;
- one two-process checkpoint run: save mid-stream, load, finish ==
  golden == uninterrupted; the port's parts load in the JAX
  ``multihost_load`` (one process, 4-device mesh), a JAX save loads in
  the port's two processes; in one process (a world of size 1) the
  port's save part equals the JAX one field for field;
- refusals without a peer: a global shard count that is not a power of
  two, ``--device cuda`` without a card, gzip input, a missing
  coordinator, and the global-answer APIs of the counter.

The workers run with jax and kaarme_tpu refused by the import system.
Every quantity is an integer: tolerance 0."""

import gzip
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from kaarme_tpu import cli as ref_cli
from kaarme_tpu.io import reader as ref_reader
from kaarme_tpu.parallel import multihost as ref_mh
from kaarme_tpu.parallel.sharded import make_mesh as ref_mesh
from kaarme_tpu.parallel.sharded_sort import (ShardedSortConfig as RefConfig,
                                              ShardedSortCounter as RefCounter)
from kaarme_tpu.utils import codec
from kaarme_tpu_torch.parallel import ShardedSortConfig, make_mesh
from kaarme_tpu_torch.parallel import multihost as mh
from kaarme_tpu_torch.parallel.exchange import exchange, exchange_processes

ROOT = pathlib.Path(__file__).resolve().parent.parent
K = 31
TIMEOUT = 240

# Installed first in each worker: a meta-path finder that refuses jax
# and the JAX package, so that any import of them fails loudly.
_BLOCK = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "kaarme_tpu" \\
                or name.startswith("kaarme_tpu."):
            raise ImportError(f"the port imported {name}")
        return None
sys.meta_path.insert(0, _Block())
import torch
torch.set_num_threads(1)
def no_jax():
    bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'kaarme_tpu')]
    assert not bad, bad
"""

_LAUNCH = _BLOCK + """
import json
from kaarme_tpu_torch.parallel import multihost
rc, c = multihost.run(sys.argv[1:])
assert rc == 0, rc
no_jax()
print("STATS " + json.dumps(dict(c.stats, prefix_cap=c.cfg.prefix_cap, nd=c._nd)))
"""

_CKPT = _BLOCK + """
import json
import numpy as np
import torch.distributed as dist
from kaarme_tpu_torch.parallel import ShardedSortConfig
from kaarme_tpu_torch.parallel import multihost as mh
fasta, port, pid, ckpt, jax_ckpt, out = sys.argv[1:]
pid = int(pid)
mh.init_distributed(f"localhost:{port}", 2, pid, "gloo", timeout_s=%(timeout)d)
mesh = mh.global_mesh(2, "cpu")
cfg = lambda: ShardedSortConfig(k=%(k)d, min_abundance=1, batch_windows=1 << 10,
                                prefix_cap=1 << 12, kernels="plain")
codes = mh.host_span_codes(fasta, pid, 2, %(k)d)
seps = np.flatnonzero(codes >= 4)          # cut after a separator: no window spans it
cut = int(seps[len(seps) // 2]) + 1
c = mh.MultiHostSortCounter(cfg(), mesh)
c.count_codes(codes[:cut])
c.save(ckpt)
stats = {}
for name, src in (("resumed", ckpt), ("from_jax", jax_ckpt)):
    r = mh.multihost_load(src, cfg(), mesh)
    stats[name] = r.stats["windows_processed"]
    r.count_codes(codes[cut:])
    r.write_output_part(f"{out}.{name}")
c.count_codes(codes[cut:])                 # the live counter goes on
c.write_output_part(f"{out}.uninterrupted")
dist.destroy_process_group()
no_jax()
print("STATS " + json.dumps(stats))
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (small tensors, several
    suite workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_pair(code: str, argv_of, cwd):
    """Start the two worker processes of one pair."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return [subprocess.Popen([sys.executable, "-c", code, *argv_of(pid)], cwd=str(cwd), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(2)]


def _finish_pair(procs) -> list:
    """Wait for a pair (each with a timeout); every worker must exit 0.
    Returns each worker's STATS object."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, so[-2000:] + "\n" + se[-4000:]
    return [json.loads(next(ln for ln in so.splitlines() if ln.startswith("STATS "))[6:])
            for so, _ in outs]


def _read_counts(path) -> dict:
    got = {}
    for line in open(path):
        kk, v = line.split()
        assert kk not in got
        got[kk] = int(v)
    return got


def _random_fasta(path, seed, n_reads, glen, read_len=90, wrap=33):
    """Reads of a random genome, one N every 17 reads, wrapped lines and
    long headers (so host spans start inside headers and lines)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i in range(n_reads):
            start = int(rng.integers(0, glen - read_len))
            read = bytearray(lut[genome[start:start + read_len]].tobytes())
            if i % 17 == 0:
                read[int(rng.integers(0, read_len))] = ord("N")
            f.write(b">read%d some description\n" % i)
            for j in range(0, len(read), wrap):
                f.write(bytes(read[j:j + wrap]) + b"\n")
    return str(path)


def _random_fastq(path, seed, n_reads=240, read_len=80):
    """Quality lines that start with '@' and '+' stress the record-start
    detector."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i in range(n_reads):
            read = lut[rng.integers(0, 4, size=read_len)].tobytes()
            q = bytes(int(x) for x in rng.integers(33, 74, read_len))
            q = (b"@" if i % 3 == 0 else b"+" if i % 3 == 1 else q[:1]) + q[1:]
            f.write(b"@read%d desc\n" % i + read + b"\n+\n" + q + b"\n")
    return str(path)


def _random_plain(path, seed, n_lines=200):
    """One sequence per line, lengths 1-120, some N and lowercase."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(n_lines):
            s = bytearray(b"ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, 121))))
            if i % 7 == 0:
                s[int(rng.integers(0, len(s)))] = ord("N")
            if i % 5 == 0:
                s = s.lower()
            f.write(bytes(s) + b"\n")
    return str(path)


def _input(tmp_path, fmt, seed):
    if fmt == "fasta":
        return _random_fasta(tmp_path / "in.fasta", seed, n_reads=300, glen=4000)
    if fmt == "fastq":
        return _random_fastq(tmp_path / "in.fastq", seed)
    if fmt == "plain":
        return _random_plain(tmp_path / "in.txt", seed)
    p = tmp_path / "tiny.txt"          # more hosts than lines: empty spans
    p.write_bytes(b"ACGTACGTGGATTTACGT\nACGTNACGTT\nTTTTTTTTTTTT\n")
    return str(p)


def _golden_file(path, k) -> dict:
    fmt, _ = ref_reader.sniff_format(path)
    data = open(path, "rb").read()
    codes = (codec.encode_fasta(data)[0] if fmt == "fasta" else
             codec.encode_fastq(data)[0] if fmt == "fastq" else codec.encode_plain(data))
    return codec.golden_count(codes, k)


# ---------------------------------------------------------------------------
# The host half, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,H,k", [
    ("fasta", 2, 7), ("fasta", 3, 7), ("fasta", 5, 7),
    ("fasta", 2, 31), ("fasta", 3, 31), ("fasta", 5, 31),
    ("plain", 2, 7), ("plain", 3, 31), ("plain", 5, 31),
    ("tiny", 2, 5), ("tiny", 5, 5), ("tiny", 8, 5),
    ("fastq", 2, 31), ("fastq", 3, 31), ("fastq", 5, 31)])
def test_host_spans_equal_jax(tmp_path, fmt, H, k):
    """Each host's chunks (small chunks, so encoder state crosses them)
    equal the JAX host's, and the union of windows is the golden count."""
    path = _input(tmp_path, fmt, seed=H * 100 + k)
    union = {}
    for h in range(H):
        got = list(mh.HostSpanReader(path, h, H, k, chunk_bytes=700))
        want = list(ref_mh.HostSpanReader(path, h, H, k, chunk_bytes=700))
        assert len(got) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        codes = mh.host_span_codes(path, h, H, k)
        assert np.array_equal(codes, ref_mh.host_span_codes(path, h, H, k))
        for kk, v in (codec.golden_count(codes, k) if codes.size else {}).items():
            union[kk] = union.get(kk, 0) + v
    assert union == _golden_file(path, k)


def test_host_span_refuses_gzip(tmp_path):
    gz = str(tmp_path / "x.fasta.gz")
    with gzip.open(gz, "wb") as f:
        f.write(b">r\nACGT\n")
    with pytest.raises(ValueError, match="kaarme_tpu_torch.parallel.multihost --presplit"):
        mh.HostSpanReader(gz, 0, 2, 5)
    with pytest.raises(ValueError):
        ref_mh.HostSpanReader(gz, 0, 2, 5)


@pytest.mark.parametrize("fmt", ["fastq", "fasta", "plain"])
@pytest.mark.parametrize("gz", [False, True])
def test_presplit_equals_jax(tmp_path, fmt, gz):
    path = _input(tmp_path, fmt, seed=7)
    if gz:
        with open(path, "rb") as fi, gzip.open(path + ".gz", "wb") as fo:
            shutil.copyfileobj(fi, fo)
        path += ".gz"
    got = mh.presplit(path, 3, str(tmp_path / "port"), block_records=16)
    want = ref_mh.presplit(path, 3, str(tmp_path / "ref"), block_records=16)
    assert len(got) == len(want) == 3
    assert all(open(a, "rb").read() == open(b, "rb").read() for a, b in zip(got, want))
    k = 13
    union = {}
    for p in got:
        for kk, v in _golden_file(p, k).items():
            union[kk] = union.get(kk, 0) + v
    src = path[:-3] if gz else path
    assert union == _golden_file(src, k)


def test_merge_parts_equals_jax(tmp_path):
    out = str(tmp_path / "m.out")
    data = [[b"AAAC 3\n", b"CCGT 1\n"], [b"ACGT 2\n"], []]
    for h, lines in enumerate(data):
        with open(f"{out}.part{h}", "wb") as f:
            f.writelines(lines)
    assert mh.merge_parts(out, 3) == 3
    assert open(out, "rb").read() == b"AAAC 3\nACGT 2\nCCGT 1\n"
    # random disjoint sorted parts: the same file as the JAX merge
    rng = np.random.default_rng(4)
    keys = sorted({"".join("ACGT"[c] for c in rng.integers(0, 4, 9)) for _ in range(500)})
    owner = rng.integers(0, 4, len(keys))
    for h in range(4):
        with open(f"{out}.part{h}", "w") as f:
            f.writelines(f"{kk} {i % 97 + 1}\n" for i, kk in enumerate(keys) if owner[i] == h)
    ref_out = str(tmp_path / "r.out")
    for h in range(4):
        shutil.copy(f"{out}.part{h}", f"{ref_out}.part{h}")
    assert mh.merge_parts(out, 4) == ref_mh.merge_parts(ref_out, 4) == len(keys)
    assert open(out, "rb").read() == open(ref_out, "rb").read()


# ---------------------------------------------------------------------------
# Refusals without a peer
# ---------------------------------------------------------------------------

def _argv(path, *extra):
    return [str(path), str(K), "--coordinator", "localhost:1", "--process-id", "0",
            "-o", str(pathlib.Path(path).parent / "x.out"), *extra]


@pytest.mark.parametrize("extra,msg", [
    (["--device", "cpu", "--num-processes", "3", "--devices", "1"],
     "device count must be a power of two, got 3 (3 processes x 1 devices)"),
    (["--device", "cpu", "--num-processes", "2", "--devices", "3"],
     "device count must be a power of two, got 6"),
    (["--device", "cpu", "--num-processes", "1", "--devices", "2", "--dist-backend", "nccl"],
     "--dist-backend nccl needs --device cuda"),
], ids=["three_hosts", "three_devices", "nccl_on_cpu"])
def test_launcher_refuses_before_connecting(tmp_path, capsys, extra, msg):
    """Refused from the arguments, before any connection (the
    coordinator port is closed): exit 1, one message, no output."""
    path = _random_fasta(tmp_path / "in.fasta", 1, n_reads=20, glen=500)
    assert mh.main(_argv(path, *extra)) == 1
    assert msg in capsys.readouterr().err
    assert not list(tmp_path.glob("x.out*"))


def test_launcher_refuses_gzip_and_missing_coordinator(tmp_path, capsys, monkeypatch):
    path = _random_fasta(tmp_path / "in.fasta", 1, n_reads=20, glen=500)
    gz = path + ".gz"
    with open(path, "rb") as fi, gzip.open(gz, "wb") as fo:
        shutil.copyfileobj(fi, fo)
    assert mh.main(_argv(gz, "--device", "cpu", "--num-processes", "2")) == 1
    assert "--presplit" in capsys.readouterr().err
    for name in ("KAARME_COORDINATOR", "KAARME_NUM_PROCS", "KAARME_PROC_ID"):
        monkeypatch.delenv(name, raising=False)
    assert mh.main([path, str(K), "--device", "cpu", "--num-processes", "2", "-o", "x.out"]) == 1
    assert "needs --coordinator" in capsys.readouterr().err
    # --presplit exits before any init, gzip or not
    assert mh.main([gz, str(K), "-o", str(tmp_path / "pp"), "--presplit", "2"]) == 0
    assert sorted(p.name for p in tmp_path.glob("pp.host*")) == ["pp.host0", "pp.host1"]


def test_cuda_without_card_is_an_error(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    path = _random_fasta(tmp_path / "in.fasta", 1, n_reads=20, glen=500)
    assert mh.main(_argv(path, "--num-processes", "2")) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


def test_global_answers_are_refused():
    """find / as_dict would answer from one host's partition, add_codes /
    finish would leave the lockstep: all raise (no peer needed)."""
    mesh = mh.ProcessMesh(make_mesh(2, "cpu"), pid=0, nproc=2, host_group=None, staged=False)
    c = mh.MultiHostSortCounter(ShardedSortConfig(k=K, kernels="plain"), mesh)
    with pytest.raises(NotImplementedError, match="merged output file"):
        c.find(["A" * K])
    with pytest.raises(NotImplementedError, match="as_dict_local"):
        c.as_dict()
    for call in (lambda: c.add_codes(np.zeros(100, np.uint8)), c.finish):
        with pytest.raises(RuntimeError, match="round-driven"):
            call()
    with pytest.raises(ValueError, match="power of two"):
        mh.check_shard_count(3, 2)
    mh.check_shard_count(2, 4)


# ---------------------------------------------------------------------------
# One two-process launcher run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The launcher on two gloo processes x 2 CPU shards (k=31, 2^10-window
    rounds, -s 3000 so the shards grow), and, while they run, the JAX
    references: the sharded counter on 4 devices and the JAX CLI."""
    tmp = tmp_path_factory.mktemp("launch")
    path = _random_fasta(tmp / "in.fasta", 7, n_reads=600, glen=30000)
    out = str(tmp / "mh.counts")
    port = _free_port()
    procs = _start_pair(_LAUNCH, lambda pid: [
        path, str(K), "--coordinator", f"localhost:{port}", "--num-processes", "2",
        "--process-id", str(pid), "--device", "cpu", "--devices", "2", "-a", "1",
        "--batch-log2", "10", "-s", "3000", "-o", out, "--merge-parts"], tmp)
    try:
        codes = codec.encode_fasta(open(path, "rb").read())[0]
        ref = RefCounter(RefConfig(k=K, min_abundance=1, batch_windows=1 << 10, rows=1 << 5,
                                   prefix_cap=1 << 12), ref_mesh(4))
        ref.count_codes(codes)
        ref.dump()
        w = codec.words_per_kmer(K)
        cols = [np.asarray(c) for c in ref.prefix]
        shards = []
        for d in range(4):
            live = cols[-1][d] > 0
            shards.append((np.stack([cols[j][d][live] for j in range(w)], 1),
                           cols[-1][d][live].astype(np.int64)))
        ref_out = str(tmp / "ref.counts")
        assert ref_cli.main([path, str(K), "-s", "3000", "-a", "1", "-q",
                             "--pipeline", "classic", "-o", ref_out]) == 0
    finally:
        stats = _finish_pair(procs)
    return dict(path=path, out=out, ref_out=ref_out, shards=shards, stats=stats, codes=codes)


def test_parts_equal_jax_shards(launch):
    """Part h == the JAX sharded counter's records on devices 2h, 2h+1."""
    for h in range(2):
        lines = open(f"{launch['out']}.part{h}", "rb").read().splitlines()
        keys = np.concatenate([launch["shards"][2 * h + j][0] for j in range(2)])
        cnt = np.concatenate([launch["shards"][2 * h + j][1] for j in range(2)])
        want = sorted(f"{s} {min(int(c), 16383)}".encode()
                      for s, c in zip(codec.unpack_kmers(keys, K), cnt))
        assert lines == want
    assert launch["stats"][0]["nd"] == [len(launch["shards"][0][0]), len(launch["shards"][1][0])]
    assert launch["stats"][1]["nd"] == [len(launch["shards"][2][0]), len(launch["shards"][3][0])]


def test_merged_file_equals_jax_cli_and_golden(launch):
    merged = open(launch["out"], "rb").read()
    assert merged == open(launch["ref_out"], "rb").read()
    golden = codec.golden_count(launch["codes"], K)
    assert _read_counts(launch["out"]) == {s: min(c, 16383) for s, c in golden.items()}


def test_processes_agree_on_growth_and_windows(launch):
    """Both processes grew to one capacity in lockstep; their windows are
    their spans' window positions, and the exchange moved records."""
    a, b = launch["stats"]
    assert a["prefix_cap"] == b["prefix_cap"] > 1 << 12
    assert a["grow_events"] == b["grow_events"] >= 1
    assert a["batches"] == b["batches"] >= 5
    spans = [ref_mh.host_span_codes(launch["path"], h, 2, K).shape[0] for h in range(2)]
    assert [a["windows_processed"], b["windows_processed"]] == [n - K + 1 for n in spans]
    assert a["exchange_bytes"] > 0 and b["exchange_bytes"] > 0


# ---------------------------------------------------------------------------
# Checkpoints: two processes, and across the packages
# ---------------------------------------------------------------------------

def _ref_cfg():
    return RefConfig(k=K, min_abundance=1, batch_windows=1 << 10, rows=1 << 5,
                     prefix_cap=1 << 12)


def _port_cfg():
    return ShardedSortConfig(k=K, min_abundance=1, batch_windows=1 << 10, prefix_cap=1 << 12,
                             kernels="plain")


def _halves(path):
    """Each host's codes cut after its middle separator (as the workers cut)."""
    out = []
    for h in range(2):
        codes = ref_mh.host_span_codes(path, h, 2, K)
        seps = np.flatnonzero(codes >= 4)
        cut = int(seps[len(seps) // 2]) + 1
        out.append((codes[:cut], codes[cut:]))
    return out


@pytest.fixture(scope="module")
def world1():
    """This process alone as a gloo world of size 1."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield mh.global_mesh(4, "cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, world1):
    """A JAX one-process save of both hosts' first halves (part0,
    num_parts=1), the port's in one process too, then the two-process
    checkpoint pair."""
    tmp = tmp_path_factory.mktemp("ckpt")
    path = _random_fasta(tmp / "in.fasta", 13, n_reads=300, glen=8000)
    halves = _halves(path)
    first = np.concatenate([a for a, _ in halves])       # each half ends with a separator
    jax_mesh = Mesh(np.asarray(jax.devices("cpu")[:4]), ("d",))
    jax_ckpt, port1_ckpt = str(tmp / "jax"), str(tmp / "port1")
    ref = ref_mh.MultiHostSortCounter(_ref_cfg(), jax_mesh)
    ref.count_codes(first)
    ref.save(jax_ckpt)
    one = mh.MultiHostSortCounter(_port_cfg(), world1)
    one.count_codes(first)
    one.save(port1_ckpt)
    port = _free_port()
    ck, out = str(tmp / "port"), str(tmp / "ck.counts")
    procs = _start_pair(_CKPT % {"timeout": TIMEOUT, "k": K},
                        lambda pid: [path, str(port), str(pid), ck, jax_ckpt, out], tmp)
    stats = _finish_pair(procs)
    return dict(path=path, halves=halves, jax_mesh=jax_mesh, jax_ckpt=jax_ckpt,
                port1_ckpt=port1_ckpt, ck=ck, out=out, stats=stats, tmp=tmp)


def test_one_process_save_equals_jax(ckpt):
    """One process, 4 shards: the port's part0 == the JAX part0, field
    for field (the same rounds give the same per-shard stores)."""
    a = np.load(ckpt["port1_ckpt"] + ".part0.npz")
    b = np.load(ckpt["jax_ckpt"] + ".part0.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        assert np.array_equal(a[name], b[name]), name


@pytest.mark.parametrize("name", ["resumed", "from_jax", "uninterrupted"])
def test_two_process_checkpoint_resumes_to_golden(ckpt, name):
    """Resumed from the port's parts, from the JAX one-process part, and
    the live counter that went on: each merged == golden."""
    out = f"{ckpt['out']}.{name}"
    assert mh.merge_parts(out, 2) > 0
    golden = _golden_file(ckpt["path"], K)
    assert _read_counts(out) == {s: min(c, 16383) for s, c in golden.items()}
    if name != "uninterrupted":
        # restored windows: the port's parts hold each host's first half,
        # the JAX part the two halves counted as one stream
        n = sum(a.shape[0] for a, _ in ckpt["halves"])
        want = {"resumed": n - 2 * (K - 1), "from_jax": n - (K - 1)}[name]
        assert sum(s[name] for s in ckpt["stats"]) == want


def test_port_parts_load_in_jax(ckpt):
    """The port's two parts in the JAX ``multihost_load`` (one process, 4
    devices): it dumps the parts' summed records == golden of the first
    halves."""
    parts = [np.load(f"{ckpt['ck']}.part{h}.npz") for h in range(2)]
    assert [int(p["num_parts"]) for p in parts] == [2, 2]
    assert all(str(p["kind"]) == "multihost_sort" for p in parts)
    keys = np.concatenate([p["keys"] for p in parts])
    cnt = np.concatenate([p["counts"] for p in parts])
    summed = {}
    for s, c in zip(codec.unpack_kmers(keys, K), cnt.tolist()):
        summed[s] = summed.get(s, 0) + c
    r = ref_mh.multihost_load(ckpt["ck"], _ref_cfg(), ckpt["jax_mesh"])
    tk, tc = r.dump_local()
    got = dict(zip(codec.unpack_kmers(tk, K), tc.tolist()))
    assert got == summed
    first = np.concatenate([a for a, _ in ckpt["halves"]])
    assert got == codec.golden_count(first, K)


def test_exchange_across_one_process_equals_exchange(world1):
    """In a world of one process, the process-group exchange routes as
    the device-list exchange does: same buckets, same order."""
    rng = np.random.default_rng(5)
    cols, owners = [], []
    for s in range(4):
        n = int(rng.integers(0, 50))
        vals = torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32)) + 1000 * s
        own = torch.from_numpy(rng.integers(0, 4, n))
        cols.append((vals, own.to(torch.int32)))
        owners.append(own)
    want = exchange(cols, owners, world1.devices)
    got, nbytes = exchange_processes(cols, owners, world1)
    assert nbytes == 0
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
