"""The PyTorch port's CLI: count files byte-identical to ``kaarme_tpu.cli``
on the skm and classic routes, single-device and ``--devices 8`` (CPU
shards here), and equal to it once sorted on the probe table (which
writes slot order), ``--query`` on an unsorted dump, the JAX CLI's
refusals of ``--devices`` (with the table, with ``-b``, not a power of
two) and no CPU run when the cards are missing, and no JAX anywhere in
the port (a subprocess run and a source scan)."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from kaarme_tpu import cli as ref_cli
from kaarme_tpu.io import reader as io_reader
from kaarme_tpu.utils import codec
from kaarme_tpu_torch import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _fasta(tmp_path, seed=0, n=3000):
    """Wrapped lines, an N, and a second record (the test_cli.py shape)."""
    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
    seq = seq[:900] + "N" + seq[901:]
    body = "\n".join(seq[i:i + 70] for i in range(0, 2000, 70))
    body2 = "\n".join(seq[i:i + 60] for i in range(2000, n, 60))
    # repeat a stretch so some k-mers count more than once
    p = tmp_path / "sample.fasta"
    p.write_text(">r1 first\n" + body + "\n>r2\n" + body2 + "\n" + seq[100:400] + "\n")
    return p


@pytest.mark.parametrize("k,mode,abu", [(31, 2, 1), (31, 0, 2), (51, 2, 2), (21, 0, 1)])
def test_count_file_byte_identical_to_reference(tmp_path, k, mode, abu):
    p = _fasta(tmp_path, seed=k)
    a, b = tmp_path / "port.out", tmp_path / "ref.out"
    ha, hb = tmp_path / "port.histo", tmp_path / "ref.histo"
    common = [str(p), str(k), "-s", "4096", "-m", str(mode), "-a", str(abu), "-q"]
    assert cli.main(common + ["-o", str(a), "--histo", str(ha), "--device", "cpu"]) == 0
    assert ref_cli.main(common + ["-o", str(b), "--histo", str(hb)]) == 0
    assert a.read_bytes() == b.read_bytes()
    assert ha.read_bytes() == hb.read_bytes()
    golden = codec.golden_count(io_reader.read_codes(str(p)), k)
    clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
    want = {s: clip(c) for s, c in golden.items() if clip(c) >= abu}
    got = {ln.split()[0]: int(ln.split()[1]) for ln in a.read_text().splitlines()}
    assert got == want


def test_query_and_banner(tmp_path, monkeypatch, capsys):
    import io

    p = _fasta(tmp_path, seed=3)
    golden = codec.golden_count(io_reader.read_codes(str(p)), 31)
    some = sorted(golden)[:3]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(some + ["ACGT", "N" * 31]) + "\n"))
    rc = cli.main([str(p), "31", "-s", "4096", "-a", "1", "--device", "cpu",
                   "-o", str(tmp_path / "q.out"), "--query"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert "Running settings:" in out
    assert out[-5:] == [str(golden[s]) for s in some] + ["-1", "-1"]


@pytest.mark.parametrize("k,extra,mode,abu", [
    (13, [], 2, 1), (13, [], 0, 2), (13, ["--compactor", "merge"], 2, 2),
    (31, ["--pipeline", "classic"], 2, 2), (31, ["--pipeline", "classic"], 0, 1),
    (51, ["--pipeline", "classic", "--compactor", "merge"], 0, 1),
    (51, ["--pipeline", "classic", "--compactor", "merge"], 2, 2)])
def test_classic_count_file_byte_identical_to_reference(tmp_path, k, extra, mode, abu):
    """The classic pipeline (k < 16 under auto, or --pipeline classic),
    with and without the linear-merge compactor.  The JAX CLI runs its
    default compactor: its merge kernel has no CPU mode, and every
    compactor gives the same counts."""
    p = _fasta(tmp_path, seed=k + mode)
    a, b = tmp_path / "port.out", tmp_path / "ref.out"
    ha, hb = tmp_path / "port.histo", tmp_path / "ref.histo"
    common = [str(p), str(k), "-s", "4096", "-m", str(mode), "-a", str(abu), "-q"]
    assert cli.main(common + extra + ["-o", str(a), "--histo", str(ha), "--device", "cpu"]) == 0
    ref_extra = [x for x in extra if x not in ("--compactor", "merge")]
    assert ref_cli.main(common + ref_extra + ["-o", str(b), "--histo", str(hb)]) == 0
    assert a.read_bytes() == b.read_bytes()
    assert ha.read_bytes() == hb.read_bytes()
    golden = codec.golden_count(io_reader.read_codes(str(p)), k)
    clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
    want = {s: clip(c) for s, c in golden.items() if clip(c) >= abu}
    got = {ln.split()[0]: int(ln.split()[1]) for ln in a.read_text().splitlines()}
    assert got == want


@pytest.mark.parametrize("k,extra,mode,abu", [
    (31, [], 2, 2), (51, [], 0, 1), (13, [], 2, 2),
    (31, ["--pipeline", "classic"], 2, 2), (21, ["--pipeline", "classic"], 0, 2),
    (13, ["--compactor", "merge"], 2, 2)])
def test_bloom_count_file_byte_identical_to_reference(tmp_path, capsys, k, extra, mode, abu):
    """-b -u: the two-pass Bloom prefilter on the skm and classic routes
    (with the linear merge too); the JAX CLI runs its default compactor.
    Singletons never reach the store, so the count file is the golden
    count >= max(abu, 2)."""
    p = _fasta(tmp_path, seed=k + 7 * mode)
    a, b = tmp_path / "port.out", tmp_path / "ref.out"
    common = [str(p), str(k), "-b", "-u", "4000", "-f", "0.02", "-m", str(mode),
              "-a", str(abu)]
    rc, counter = cli.run(common + extra + ["-o", str(a), "--device", "cpu"])
    assert rc == 0
    banner = capsys.readouterr().out
    assert "using bloom filters:      yes" in banner and "est. unique k-mers:     4000" in banner
    assert "false positive rate:    0.02" in banner
    assert counter.bf1 is None and counter.stats["new_in_second"] > 0
    ref_extra = [x for x in extra if x not in ("--compactor", "merge")]
    assert ref_cli.main(common + ref_extra + ["-q", "-o", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    golden = codec.golden_count(io_reader.read_codes(str(p)), k)
    clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
    want = {s: clip(c) for s, c in golden.items() if c >= 2 and clip(c) >= abu}
    got = {ln.split()[0]: int(ln.split()[1]) for ln in a.read_text().splitlines()}
    assert got == want


@pytest.mark.parametrize("k,extra,mode,abu", [
    (13, ["-s", "4096"], 2, 1), (31, ["-s", "4096"], 0, 2), (51, ["-s", "4096"], 2, 2),
    (13, ["-b", "-u", "4000"], 0, 2), (31, ["-b", "-u", "4000"], 2, 1),
    (51, ["-b", "-u", "4000"], 0, 1)])
def test_table_count_file_matches_reference(tmp_path, capsys, k, extra, mode, abu):
    """--backend table, with and without the two-pass Bloom prefilter:
    the count file (slot order) equals the JAX CLI's once sorted, and the
    golden count (>= 2 with -b, where singletons never reach the table)."""
    p = _fasta(tmp_path, seed=k + 3 * mode)
    a, b = tmp_path / "port.out", tmp_path / "ref.out"
    ha, hb = tmp_path / "port.histo", tmp_path / "ref.histo"
    common = [str(p), str(k)] + extra + ["--backend", "table", "-m", str(mode), "-a", str(abu)]
    rc, counter = cli.run(common + ["-o", str(a), "--histo", str(ha), "--device", "cpu"])
    assert rc == 0 and type(counter).__name__ == ("BloomFilteredCounter" if "-b" in extra
                                                  else "KmerCounter")
    used, cap = counter.occupancy()
    assert f"Hash table slots in use: {used}/{cap}" in capsys.readouterr().out
    assert ref_cli.main(common + ["-q", "-o", str(b), "--histo", str(hb)]) == 0
    assert sorted(a.read_bytes().splitlines()) == sorted(b.read_bytes().splitlines())
    assert ha.read_bytes() == hb.read_bytes()
    golden = codec.golden_count(io_reader.read_codes(str(p)), k)
    clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
    least = 2 if "-b" in extra else 1
    want = {s: clip(c) for s, c in golden.items() if c >= least and clip(c) >= abu}
    got = {ln.split()[0]: int(ln.split()[1]) for ln in a.read_text().splitlines()}
    assert got == want


def test_table_query_sorts_the_dump(tmp_path, monkeypatch, capsys):
    """--query on the table route, whose dump is in slot order: every
    answer is the golden count, 0 for absent k-mers, -1 for malformed
    lines (a binary search of the unsorted dump would miss most)."""
    import io

    k = 21
    p = _fasta(tmp_path, seed=11)
    golden = codec.golden_count(io_reader.read_codes(str(p)), k)
    rng = np.random.default_rng(11)
    present = [s for s in rng.permutation(sorted(golden))[:60]]
    queries = present + [codec.revcomp(s) for s in present[:10]] + ["A" * k, "ACGT", "N" * k]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(queries) + "\n"))
    rc, counter = cli.run([str(p), str(k), "-s", "4096", "--backend", "table", "-a", "1",
                           "--device", "cpu", "-q", "-o", str(tmp_path / "q.out"), "--query"])
    assert rc == 0
    tk, _ = counter.dump()
    assert (np.lexsort(tk.T[::-1]) != np.arange(tk.shape[0])).any()      # slot order
    out = capsys.readouterr().out.splitlines()
    want = [str(golden[codec.canonical(s)]) for s in present + queries[60:70]]
    want += [str(golden.get("A" * k, 0)), "-1", "-1"]
    assert out == want


@pytest.mark.parametrize("extra,msg", [
    (["--devices", "2"], "--devices"),
    (["--devices", "2", "--backend", "table"],
     "--backend table does not support --devices; use the sort backend"),
    (["--devices", "2", "-b", "-u", "4000"], "-b/--use-bfilter does not support --devices yet"),
    (["--devices", "3", "--device", "cpu"], "device count must be a power of two, got 3"),
])
def test_unported_routes_are_refused(tmp_path, capsys, extra, msg):
    """--devices where the JAX CLI refuses it (the probe table, -b, a count
    that is not a power of two) exits 1 with its message; on the default
    device it needs one card per shard and, without them, exits 1
    before counting: it never falls back to the CPU."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two CUDA devices")
    p = _fasta(tmp_path)
    size = [] if "-u" in extra else ["-s", "4096"]
    out = tmp_path / "x.out"
    assert cli.main([str(p), "31"] + size + extra + ["-o", str(out)]) == 1
    err = capsys.readouterr().err
    assert msg in err and not out.exists()
    if extra == ["--devices", "2"]:
        assert f"need 2 devices, have {torch.cuda.device_count()}" in err


@pytest.mark.parametrize("k,extra,seed,n", [
    (9, [], 3, 2000), (21, ["--pipeline", "skm"], 9, 3000),
    (13, ["--compactor", "merge"], 5, 2500), (31, ["-m", "0", "-a", "2"], 4, 3000)])
def test_devices_count_file_byte_identical_to_reference(tmp_path, k, extra, seed, n):
    """--device cpu --devices 8 (8 CPU shards) writes the JAX CLI's
    --devices 8 count file byte for byte (tests/test_cli.py's inputs for
    the classic and skm routes; the JAX CLI runs its default compactor)."""
    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
    p = tmp_path / "sample.fasta"
    p.write_text(">r1\n" + "\n".join(seq[i:i + 70] for i in range(0, n, 70)) + "\n")
    a, b = tmp_path / "port.out", tmp_path / "ref.out"
    common = [str(p), str(k), "-s", "4096", "-q", "--devices", "8"]
    common += [] if "-a" in extra else ["-a", "1"]
    rc, counter = cli.run(common + extra + ["-o", str(a), "--device", "cpu"])
    assert rc == 0 and counter.ndev == 8
    assert type(counter).__name__ == ("ShardedSkmCounter" if k >= 16 else "ShardedSortCounter")
    ref_extra = [x for x in extra if x not in ("--compactor", "merge")]
    assert ref_cli.main(common + ref_extra + ["-o", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("compactor", ["xla", "merge_interpret"])
def test_jax_compactor_variants_point_to_kernels(tmp_path, capsys, compactor):
    p = _fasta(tmp_path)
    assert cli.main([str(p), "13", "-s", "4096", "--compactor", compactor,
                     "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert f"--compactor {compactor}" in err and "--kernels" in err


def test_skm_route_ignores_merge_compactor(tmp_path):
    """As in the JAX package, --compactor merge is a classic-only variant:
    the skm route accepts and ignores it."""
    p = _fasta(tmp_path, seed=4)
    a, b = tmp_path / "m.out", tmp_path / "d.out"
    common = [str(p), "31", "-s", "4096", "-a", "1", "-q", "--device", "cpu"]
    rc, counter = cli.run(common + ["--compactor", "merge", "-o", str(a)])
    assert rc == 0 and type(counter).__name__ == "SkmCounter"
    assert cli.main(common + ["-o", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_cuda_without_card_is_an_error(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _fasta(tmp_path)
    assert cli.main([str(p), "31", "-s", "4096", "-o", str(tmp_path / "x.out")]) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not (tmp_path / "x.out").exists()


# Installed first in each subprocess: a meta-path finder that refuses jax
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
"""


@pytest.mark.parametrize("extra,stdin", [
    (["31", "-s", "4096"], ""),
    (["13", "-s", "4096", "--pipeline", "classic"], ""),
    (["31", "-b", "-u", "4000"], ""),
    (["31", "-s", "4096", "--histo", "h.txt", "--query"], "ACGTACGTACGTACGTACGTACGTACGTACG\n"),
    (["31", "-s", "4096", "--backend", "table", "--query"], "ACGTACGTACGTACGTACGTACGTACGTACG\n"),
    (["13", "-s", "4096", "--devices", "2", "--query"], "ACGTACGTACGTA\n"),
], ids=["skm", "classic_k13", "bloom", "histo_query", "table", "devices"])
def test_port_run_imports_no_jax(tmp_path, extra, stdin):
    """Every module of the port imports, and the CLI runs (skm, classic
    k=13, -b -u, --histo with --query on stdin, the probe table with
    --query, two CPU shards with --query), with jax and kaarme_tpu
    refused by the import system; neither ends up in sys.modules."""
    p = _fasta(tmp_path, n=1200)
    argv = [str(p)] + extra + ["-q", "--device", "cpu", "-o", str(tmp_path / "o.txt")]
    code = _BLOCK + (
        "import importlib, pkgutil, kaarme_tpu_torch\n"
        "for m in pkgutil.walk_packages(kaarme_tpu_torch.__path__, 'kaarme_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from kaarme_tpu_torch import cli\n"
        f"rc = cli.main({argv!r})\n"
        "assert rc == 0, rc\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'kaarme_tpu')]\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, input=stdin, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "NOJAX" in res.stdout
    assert (tmp_path / "o.txt").stat().st_size > 0


def test_port_sources_never_import_jax():
    """No source of the port, and not chip_smoke.py, imports jax or the
    JAX package (kaarme_tpu; kaarme_tpu_torch is the port itself)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|kaarme_tpu)(\.|\s|$)", re.M)
    srcs = list((ROOT / "kaarme_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(srcs) > 10 and ROOT / "kaarme_tpu_torch" / "parallel" / "multihost.py" in srcs
    bad = [str(f) for f in srcs if pat.search(f.read_text())]
    assert not bad
    assert pat.search("from kaarme_tpu.io import reader") and pat.search("import jax.numpy")
    assert not pat.search("from kaarme_tpu_torch.io import reader")
