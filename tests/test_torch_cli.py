"""The PyTorch port's CLI: count files byte-identical to ``kaarme_tpu.cli``
on the skm route, clear errors on the routes not yet ported, and no JAX
anywhere in the port (a subprocess run and a source scan)."""

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


@pytest.mark.parametrize("extra,msg", [
    (["-b", "-u", "1000"], "Bloom"),
    (["--backend", "table"], "--backend table"),
    (["--devices", "2"], "--devices"),
    (["--compactor", "merge"], "--compactor merge"),
    (["--pipeline", "classic"], "classic"),
])
def test_unported_routes_are_refused(tmp_path, capsys, extra, msg):
    p = _fasta(tmp_path)
    size = [] if "-u" in extra else ["-s", "4096"]
    assert cli.main([str(p), "31"] + size + extra + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert msg in err and "not yet ported" in err


def test_small_k_needs_classic_pipeline(tmp_path, capsys):
    p = _fasta(tmp_path)
    assert cli.main([str(p), "13", "-s", "4096", "--device", "cpu"]) == 1
    assert "not yet ported" in capsys.readouterr().err


def test_cuda_without_card_is_an_error(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _fasta(tmp_path)
    assert cli.main([str(p), "31", "-s", "4096", "-o", str(tmp_path / "x.out")]) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not (tmp_path / "x.out").exists()


def test_port_run_imports_no_jax(tmp_path):
    p = _fasta(tmp_path)
    code = ("import sys; from kaarme_tpu_torch import cli; "
            f"rc = cli.main([{str(p)!r}, '31', '-s', '4096', '-q', '--device', 'cpu', "
            f"'-o', {str(tmp_path / 'o.txt')!r}]); "
            "assert rc == 0, rc; assert 'jax' not in sys.modules, 'jax imported'; "
            "print('NOJAX')")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "NOJAX" in res.stdout
    assert (tmp_path / "o.txt").stat().st_size > 0


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    srcs = list((ROOT / "kaarme_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(srcs) > 10
    bad = [str(f) for f in srcs if pat.search(f.read_text())]
    assert not bad
