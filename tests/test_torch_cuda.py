"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device: every test skips without one (the kernels have no
CPU mode).  This file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerance 0: every compared quantity is an integer.
"""

import numpy as np
import pytest
import torch

from kaarme_tpu_torch import cli
from kaarme_tpu_torch.ops import cuda_compact, cuda_skm, sortcount


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _codes(n, k, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n + k - 1).astype(np.int32)
    c[::151] = 4
    c[1000:1003] = 5                 # base bits under an invalid flag
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(16, 5000), (31, 1 << 15), (51, 1 << 20), (51, 777),
                                 (101, 100_003)])
def test_k1_kernel_equals_plain(dev, k, n):
    codes = torch.from_numpy(_codes(n, k, seed=k)).to(dev)
    for cap in (n // 4, 1024, 0):
        got = cuda_skm.run_rows_dense(codes, k=k, n=n, cap=cap)
        want = cuda_skm.run_rows_dense_torch(codes, k=k, n=n, cap=cap)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k1_writes_nothing_past_cap(dev):
    k, n = 51, 1 << 18
    codes = torch.from_numpy(_codes(n, k, seed=5)).to(dev)
    _, rows = cuda_skm.run_rows_dense_torch(codes, k=k, n=n, cap=0)
    cap = int(rows[0]) // 2
    out = torch.full((cuda_skm.content_words(k) + 1, cap + 333), 77, dtype=torch.int32,
                     device=dev)
    cols, r = cuda_skm.launch_dense(codes, k, n, out, cap)
    torch.cuda.synchronize()
    assert r.tolist() == rows.tolist()
    assert bool((out[:, cap:] == 77).all())
    want, _ = cuda_skm.run_rows_dense_torch(codes, k=k, n=n, cap=cap)
    for a, b in zip(cols, want):
        assert torch.equal(a, b)


def _sorted_rows(dev, W, N, embedded, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 40, (W, N)).astype(np.int64)
    keys[0] |= 0x80000000
    keys[:, ::9] = 0xFFFFFFFF                       # sentinel rows
    if embedded:
        keys[-1] = ((keys[-1] << 26) & 0xFFFFFFFF) | rng.integers(1, 1 << 21, N)
        keys[:, ::9] = 0xFFFFFFFF
    cols = [torch.from_numpy(keys[w].astype(np.uint32).view(np.int32)).to(dev)
            for w in range(W)]
    if not embedded:
        cols.append(torch.from_numpy(rng.integers(0, 1 << 21, N).astype(np.int32)).to(dev))
    s = sortcount.lexsort(cols, num_keys=W)
    return (s, None) if embedded else (s[:W].contiguous(), s[W].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("W,N,embedded", [(6, 300_000, True), (6, 2047, True),
                                          (4, 500_000, False), (1, 5000, False),
                                          (3, 0, True), (3, 0, False)])
def test_k2_kernel_equals_plain(dev, W, N, embedded):
    keys, cnt = _sorted_rows(dev, W, N, embedded, seed=W * 7 + N)
    eb = 26 if embedded else 0
    for out_len in (N, N // 3):
        got = cuda_compact.segsum_compact(keys, cnt, ebits=eb, out_len=out_len)
        want = cuda_compact.segsum_compact_torch(keys, cnt, ebits=eb, out_len=out_len)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cli_kernels_equal_plain_route(dev, tmp_path):
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 30_000)
    starts = rng.integers(0, 30_000 - 150, 2000)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(tmp_path / "r.fa", "wb") as f:
        for i, s0 in enumerate(starts):
            f.write(b">r%d\n%s\n" % (i, lut[genome[s0:s0 + 150]].tobytes()))
    cuda_skm.run_rows_dense.launches = cuda_compact.segsum_compact.launches = 0
    a, b = tmp_path / "k.txt", tmp_path / "p.txt"
    assert cli.main([str(tmp_path / "r.fa"), "51", "-s", "100000", "-a", "1", "-q",
                     "-o", str(a)]) == 0
    assert cuda_skm.run_rows_dense.launches > 0 and cuda_compact.segsum_compact.launches > 0
    assert cli.main([str(tmp_path / "r.fa"), "51", "-s", "100000", "-a", "1", "-q",
                     "-o", str(b), "--kernels", "plain"]) == 0
    assert a.read_bytes() == b.read_bytes()
    counts = [int(ln.split()[1]) for ln in a.read_bytes().splitlines()]
    assert sum(counts) == 2000 * 100
